"""Image enhancement on one device: pad, forward, clip, crop.

Counterpart of the JAX ``Evaluator.enhance`` / ``enhance_batch``
(``hvi_cidnet_tpu/eval/evaluator.py:61-133``), reference eval.py:56-75 and
demo.py: ``model(x ** gamma)`` on the image reflect-padded to multiples of
8, clipped to [0, 1] and cropped back.
"""

from __future__ import annotations

from typing import Union

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


def _bucket(h: int, w: int, factor: int = 8):
    return (h + factor - 1) // factor * factor, (w + factor - 1) // factor * factor


def _pad_to(img: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """Reflect-pad like the reference (eval_sets.py:23-28); numpy 'reflect'
    needs pad < dim, so a sliver image pads with 'edge' instead."""
    ph, pw = bh - img.shape[0], bw - img.shape[1]
    mode = "reflect" if ph < img.shape[0] and pw < img.shape[1] else "edge"
    return np.pad(img, ((0, ph), (0, pw), (0, 0)), mode=mode)


class Enhancer:
    """Serves base CIDNet on ``device``.

    ``weights``: a ``CIDNet`` (taken over: moved to ``device``, conv weights
    cast to ``compute_dtype``) or the path of a reference-layout state dict
    (``.pth`` / ``.npz``), loaded strictly into a fresh base model.
    """

    def __init__(
        self,
        weights: Union[str, CIDNet],
        gates: HVIGates = HVIGates(),
        *,
        gamma: float = 1.0,
        compute_dtype: torch.dtype = torch.float32,
        device: Union[str, torch.device] = "cuda",
    ):
        model = weights if isinstance(weights, CIDNet) else load_weights(
            CIDNet(CIDNetConfig()), weights
        )
        self.device = torch.device(device)
        self.model = cast_conv_weights(model.to(self.device), compute_dtype).eval()
        self.gates = gates
        self.gamma = gamma
        self.compute_dtype = compute_dtype

    @torch.no_grad()
    def _forward(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device, self.compute_dtype)
        if self.gamma != 1.0:
            t = t**self.gamma  # eval.py:64
        out = cidnet_forward(self.model, t, self.gates, compute_dtype=self.compute_dtype)
        return out.float().clamp(0.0, 1.0)  # eval.py:69

    def enhance(self, img: np.ndarray) -> np.ndarray:
        """Enhance one HWC [0, 1] RGB image of any size."""
        h, w = img.shape[:2]
        x = _pad_to(img, *_bucket(h, w))
        return self._forward(x[None])[0, :h, :w].cpu().numpy()

    def enhance_batch(self, imgs: np.ndarray) -> np.ndarray:
        """Enhance a stacked NHWC batch whose H, W are multiples of 8."""
        return self._forward(imgs).cpu().numpy()
