"""Pixel-space losses: L1, MSE, SSIM, Edge (Laplacian-of-Gaussian).

Counterpart of ``hvi_cidnet_tpu/losses/basic.py`` (reference
``loss/losses.py`` + ``loss/loss_utils.py``), on NCHW tensors, computed in
fp32 whatever the input dtype. The blurs are the JAX conv arm's operators:
the SSIM window is the 11x11 sigma-1.5 Gaussian with zero SAME padding, the
Edge blur the 5x5 binomial with replication padding; both are separable, so
each runs as a 1-D depthwise conv along H and then along W (the same
operator as the 2-D window; only the rounding of the sums differs). The
JAX package's other arm, banded einsums for the TPU's matrix unit
(``LOSS_BLUR_MXU``), is the same operator again and stays behind.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _reduce(loss: torch.Tensor, weight, reduction: str, channel_dim: int = 1) -> torch.Tensor:
    """Weight + reduce semantics of loss_utils.weight_reduce_loss (:30-59).
    A weight whose channel extent (``channel_dim``) is 1 counts once per
    channel of ``loss``."""
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        if weight is None:
            return loss.mean()
        # mean over the weighted region (loss_utils.py:52-57)
        if weight.shape[channel_dim] > 1:
            denom = weight.sum()
        else:
            denom = weight.sum() * loss.shape[channel_dim]
        return loss.sum() / denom
    raise ValueError(f"unknown reduction {reduction}")


def l1_loss(pred, target, weight=None, reduction="mean", loss_weight=1.0):
    """Weighted MAE (loss/losses.py:10-37, loss_utils.py:101-103)."""
    return loss_weight * _reduce((pred.float() - target.float()).abs(), weight, reduction)


def mse_loss(pred, target, weight=None, reduction="mean", loss_weight=1.0):
    d = pred.float() - target.float()
    return loss_weight * _reduce(d * d, weight, reduction)


@functools.lru_cache(maxsize=None)
def _gaussian_taps(window_size: int = 11, sigma: float = 1.5) -> tuple:
    """1-D normalized Gaussian taps (loss_utils.py:113-118)."""
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma**2))
    return tuple((g / g.sum()).astype(np.float32).tolist())


_BINOMIAL5 = (0.05, 0.25, 0.4, 0.25, 0.05)


def _separable(x: torch.Tensor, taps: tuple, pad_mode: str) -> torch.Tensor:
    """Depthwise SAME cross-correlation of NCHW ``x`` with the outer product
    of ``taps`` with itself: along H, then along W. ``pad_mode``: "zero" or
    "replicate" (the image's border values repeated)."""
    c, k = x.shape[1], len(taps)
    r = k // 2
    t = torch.tensor(taps, dtype=x.dtype, device=x.device)
    wh = t.view(1, 1, k, 1).expand(c, 1, k, 1)
    ww = t.view(1, 1, 1, k).expand(c, 1, 1, k)
    if pad_mode == "zero":
        y = F.conv2d(x, wh, padding=(r, 0), groups=c)
        return F.conv2d(y, ww, padding=(0, r), groups=c)
    y = F.conv2d(F.pad(x, (0, 0, r, r), mode="replicate"), wh, groups=c)
    return F.conv2d(F.pad(y, (r, r, 0, 0), mode="replicate"), ww, groups=c)


def ssim_map_mean(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM map on [0,1] NCHW images, C1=0.01^2 C2=0.03^2
    (loss_utils.py:125-145). One blur of [x, y, x^2, y^2, xy] stacked on
    the channels."""
    x = img1.float()
    y = img2.float()
    c = x.shape[1]
    blurred = _separable(torch.cat([x, y, x * x, y * y, x * y], dim=1),
                         _gaussian_taps(window_size), "zero")
    mu1, mu2, exx, eyy, exy = blurred.split(c, dim=1)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1, s2, s12 = exx - mu1_sq, eyy - mu2_sq, exy - mu12
    c1, c2 = 0.01**2, 0.03**2
    ssim = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return ssim.mean()


def ssim_loss(img1, img2, weight: float = 1.0):
    """``(1 - mean_ssim) * weight``: the reference D_loss (losses.py:166-190)."""
    return (1.0 - ssim_map_mean(img1, img2)) * weight


def laplacian_response(img: torch.Tensor) -> torch.Tensor:
    """LoG band: img - gauss(upsample0(downsample2(gauss(img))) * 4).

    Reference EdgeLoss.laplacian_kernel (losses.py:54-61): blur, keep every
    2nd pixel in place (the others zeroed) scaled by 4, blur again with
    replication padding (so past an even extent the replicated row or
    column is a zeroed one), subtract.
    """
    x = img.float()
    filtered = _separable(x, _BINOMIAL5, "replicate")
    h, w = x.shape[-2:]
    even = torch.zeros((h, w), dtype=x.dtype, device=x.device)
    even[::2, ::2] = 1.0
    return x - _separable(filtered * even * 4.0, _BINOMIAL5, "replicate")


def edge_loss(x, y, loss_weight: float = 1.0):
    """MSE of LoG responses x weight (losses.py:63-65)."""
    return mse_loss(laplacian_response(x), laplacian_response(y)) * loss_weight
