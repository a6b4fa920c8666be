"""VGG perceptual (+ optional Gram style) loss.

Counterpart of ``hvi_cidnet_tpu/losses/perceptual.py`` (reference
``loss/losses.py:68-161``). The trainer calls it with
``{'conv1_2': 1, 'conv2_2': 1, 'conv3_4': 1, 'conv4_4': 1}``, the mse
criterion and ``perceptual_weight=1``, and scales the result by
``P_weight`` outside (train.py:63-65, 192).

The VGG convs run in fp32 with TF32 off (``exact``, the default), in a
scope that restores the global flags: cuDNN allows TF32 for fp32 convs by
default on the card, and the loss must be the function the CPU tests pin.
The scope covers the forward only; the backward reads the flags when it
runs, so the train step runs it in the same scope.
"""

from __future__ import annotations

import contextlib
from typing import Mapping, Optional, Tuple

import torch

from hvi_cidnet_torch.losses.vgg import VGGFeatures
from hvi_cidnet_torch.ops.conv import exact_fp32


def _criterion(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if kind == "l1":
        return (a - b).abs().mean()
    if kind == "mse":
        return ((a - b) ** 2).mean()
    if kind == "fro":
        return torch.linalg.vector_norm((a - b).reshape(-1))
    raise NotImplementedError(kind)


def _gram(feat: torch.Tensor) -> torch.Tensor:
    """Gram matrix over spatial positions of an NCHW map (losses.py gram)."""
    n, c, h, w = feat.shape
    f = feat.reshape(n, c, h * w)
    return torch.bmm(f, f.transpose(1, 2)) / (c * h * w)


def perceptual_loss(
    vgg: VGGFeatures,
    x: torch.Tensor,
    gt: torch.Tensor,
    layer_weights: Mapping[str, float],
    *,
    criterion: str = "mse",
    perceptual_weight: float = 1.0,
    style_weight: float = 0.0,
    use_input_norm: bool = True,
    range_norm: bool = True,
    exact: bool = True,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Returns (percep, style) of NCHW ``x`` against ``gt``; ``gt`` is
    detached (losses.py:133): its features are computed without a graph."""
    names = list(layer_weights.keys())
    kw = dict(use_input_norm=use_input_norm, range_norm=range_norm)
    with exact_fp32() if exact else contextlib.nullcontext():
        xf = vgg(x, names, **kw)
        with torch.no_grad():
            gf = vgg(gt.detach(), names, **kw)

        percep = None
        if perceptual_weight > 0:
            percep = sum(_criterion(criterion, xf[k], gf[k]) * layer_weights[k] for k in names)
            percep = percep * perceptual_weight

        style = None
        if style_weight > 0:
            style = sum(_criterion(criterion, _gram(xf[k]), _gram(gf[k])) * layer_weights[k]
                        for k in names)
            style = style * style_weight
    return percep, style
