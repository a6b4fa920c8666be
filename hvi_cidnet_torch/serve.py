"""Image enhancement on one device: pad, forward, clip, crop.

Counterpart of the JAX ``Evaluator.enhance`` / ``enhance_batch``
(``hvi_cidnet_tpu/eval/evaluator.py:61-133``), reference eval.py:56-75 and
demo.py: ``model(x ** gamma)`` on the image reflect-padded to multiples of
8, clipped to [0, 1] and cropped back.
"""

from __future__ import annotations

from typing import Optional, Union

import os

import numpy as np
import torch

from hvi_cidnet_torch.compat.jax_params import load_weights
from hvi_cidnet_torch.models.cidnet import (
    CIDNet,
    CIDNetConfig,
    HVIGates,
    cast_conv_weights,
    cidnet_forward,
)
from hvi_cidnet_torch.ops.routes import Routes
from hvi_cidnet_torch.utils.hf_config import config_from_hf_json


def _bucket(h: int, w: int, factor: int = 8):
    return (h + factor - 1) // factor * factor, (w + factor - 1) // factor * factor


def _pad_to(img: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """Reflect-pad like the reference (eval_sets.py:23-28); numpy 'reflect'
    needs pad < dim, so a sliver image pads with 'edge' instead."""
    ph, pw = bh - img.shape[0], bw - img.shape[1]
    mode = "reflect" if ph < img.shape[0] and pw < img.shape[1] else "edge"
    return np.pad(img, ((0, ph), (0, pw), (0, 0)), mode=mode)


class Enhancer:
    """Serves CIDNet (base, MSSA or TNSM) on ``device``.

    ``weights``: a ``CIDNet`` (taken over: moved to ``device``, conv weights
    cast to ``compute_dtype``; ``config``, if given, must be its config) or
    the path of a reference-layout state dict (``.pth`` / ``.npz`` /
    ``.safetensors``), of a JAX trainer checkpoint (``.npz`` with
    ``param::`` keys) or of an HF folder (``model.safetensors`` beside a
    ``config.json``), loaded into a fresh ``CIDNet(config)``. ``config``
    defaults to the folder's ``config.json``, else ``CIDNetConfig()``, as
    the JAX ``Evaluator`` takes its ``config``. ``strict`` defaults to True,
    and to False for TNSM: the shape-filtered load of the TNSM evaluator
    (cli/eval_tnsm.py), where every tensor the file lacks keeps its seeded
    init. ``routes``: the fused block route of every forward
    (``ops/routes.py``); None takes the defaults with the environment's
    overrides.
    """

    def __init__(
        self,
        weights: Union[str, CIDNet],
        gates: HVIGates = HVIGates(),
        *,
        config: Optional[CIDNetConfig] = None,
        strict: Optional[bool] = None,
        gamma: float = 1.0,
        compute_dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device] = "cuda",
        routes: Optional[Routes] = None,
    ):
        if isinstance(weights, CIDNet):
            if config is not None and config != weights.config:
                raise ValueError(f"model config {weights.config} != serving config {config}")
            model = weights
        else:
            if config is None:  # an HF folder's config.json, else the default
                hf = os.path.join(weights, "config.json")
                config = config_from_hf_json(hf) if os.path.isfile(hf) else CIDNetConfig()
            if strict is None:
                strict = config.variant != "tnsm"
            model = load_weights(CIDNet(config), weights, strict=strict)
        self.config = model.config
        self.device = torch.device(device)
        self.model = cast_conv_weights(model.to(self.device), compute_dtype).eval()
        self.gates = gates
        self.gamma = gamma
        self.compute_dtype = compute_dtype
        self.routes = routes

    @torch.no_grad()
    def _forward(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device, self.compute_dtype)
        if self.gamma != 1.0:
            t = t**self.gamma  # eval.py:64
        out = cidnet_forward(self.model, t, self.gates, compute_dtype=self.compute_dtype,
                             routes=self.routes)
        if self.config.variant == "tnsm":
            out = out[0]  # (rgb, None) when serving
        return out.float().clamp(0.0, 1.0)  # eval.py:69

    def enhance(self, img: np.ndarray) -> np.ndarray:
        """Enhance one HWC [0, 1] RGB image of any size."""
        h, w = img.shape[:2]
        x = _pad_to(img, *_bucket(h, w))
        return self._forward(x[None])[0, :h, :w].cpu().numpy()

    def enhance_batch(self, imgs: np.ndarray) -> np.ndarray:
        """Enhance a stacked NHWC batch whose H, W are multiples of 8."""
        return self._forward(imgs).cpu().numpy()
