"""K1 and K2: the fused HVI transform kernels, their plain twins and the
dispatchers the model calls.

Counterpart of ``hvi_cidnet_tpu/ops/hvi_pallas.py`` (``rgb_to_hvi_pallas_hwcb``
and ``hvi_to_rgb_pallas_hwcb``, the default path of the JAX forward). The
kernels are ``csrc/hvi.cu``; they also absorb the layout change at the
model's boundary:

* ``rgb_to_hvi``: NHWC RGB (B, H, W, 3) -> NCHW HVI (B, 3, H, W) in
  ``out_dtype`` (the compute dtype);
* ``hvi_to_rgb``: NCHW HVI -> NHWC RGB, in the input's dtype.

Dispatch is by device only: a CPU tensor takes the plain twin, a CUDA
tensor the kernel (which raises on anything it does not take). The kernel
paths are ``autograd.Function``s whose backward runs the twin's autograd.
"""

from __future__ import annotations

import ctypes

import torch

from hvi_cidnet_torch.ops import hvi as _hvi
from hvi_cidnet_torch.ops._build import (
    DTYPE_CODES,
    CudaKernel,
    check_input,
    scalar_pointer,
    twin_backward,
)

_p, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
RGB_TO_HVI = CudaKernel("hvi_rgb_to_hvi", [_p, _i, _p, _i, _p, _i64, _i64])
HVI_TO_RGB = CudaKernel("hvi_hvi_to_rgb", [_p, _p, _i, _p, _i64, _i64, _i, _i, _f, _f])


# --------------------------------------------------------------------------
# K1: RGB -> HVI
# --------------------------------------------------------------------------


def rgb_to_hvi_plain(img: torch.Tensor, k: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Twin of K1: NHWC RGB -> NCHW HVI, computed in fp32, rounded to the
    input dtype (as the JAX twin returns) and then to ``out_dtype``."""
    return _hvi.rgb_to_hvi(img, k).permute(0, 3, 1, 2).to(out_dtype).contiguous()


def rgb_to_hvi_kernel(img: torch.Tensor, k: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch K1 on ``img`` (contiguous (B, H, W, 3) on the card)."""
    check_input(img, "img", 4)
    b, h, w, c = img.shape
    if c != 3:
        raise ValueError(f"img: expected 3 channels last, got shape {tuple(img.shape)}")
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} not supported (float32 or bfloat16)")
    out = torch.empty((b, 3, h, w), dtype=out_dtype, device=img.device)
    RGB_TO_HVI(
        img.device, img.data_ptr(), DTYPE_CODES[img.dtype],
        out.data_ptr(), DTYPE_CODES[out_dtype],
        scalar_pointer(k, img.device, "density_k"), b * h * w, h * w,
    )
    return out


class _RgbToHvi(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, k, out_dtype):
        ctx.save_for_backward(img, k)
        ctx.out_dtype = out_dtype
        return rgb_to_hvi_kernel(img, k, out_dtype)

    @staticmethod
    def backward(ctx, grad):
        img, k = ctx.saved_tensors
        grads = twin_backward(
            lambda i, kk: rgb_to_hvi_plain(i, kk, ctx.out_dtype),
            (img, k), grad, ctx.needs_input_grad[:2],
        )
        return (*grads, None)


def rgb_to_hvi(img: torch.Tensor, k: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """HVIT: NHWC RGB -> NCHW HVI. CPU: the twin; CUDA: K1."""
    if img.device.type == "cpu":
        return rgb_to_hvi_plain(img, k, out_dtype)
    return _RgbToHvi.apply(img, k, out_dtype)


# --------------------------------------------------------------------------
# K2: HVI -> RGB
# --------------------------------------------------------------------------


def hvi_to_rgb_plain(
    hvi: torch.Tensor, k: torch.Tensor, *, gated: bool = False, gated2: bool = False,
    alpha: float = 1.0, alpha_s: float = 1.3,
) -> torch.Tensor:
    """Twin of K2: NCHW HVI -> NHWC RGB in ``hvi.dtype``."""
    rgb = _hvi.hvi_to_rgb(
        hvi, k, gated=gated, gated2=gated2, alpha=alpha, alpha_s=alpha_s, channel_dim=1
    )
    return rgb.permute(0, 2, 3, 1).contiguous()


def hvi_to_rgb_kernel(
    hvi: torch.Tensor, k: torch.Tensor, *, gated: bool = False, gated2: bool = False,
    alpha: float = 1.0, alpha_s: float = 1.3,
) -> torch.Tensor:
    """Launch K2 on ``hvi`` (contiguous (B, 3, H, W) on the card)."""
    check_input(hvi, "hvi", 4)
    b, c, h, w = hvi.shape
    if c != 3:
        raise ValueError(f"hvi: expected 3 channels at dim 1, got shape {tuple(hvi.shape)}")
    out = torch.empty((b, h, w, 3), dtype=hvi.dtype, device=hvi.device)
    HVI_TO_RGB(
        hvi.device, hvi.data_ptr(), out.data_ptr(), DTYPE_CODES[hvi.dtype],
        scalar_pointer(k, hvi.device, "density_k"), b * h * w, h * w,
        int(bool(gated)), int(bool(gated2)), float(alpha), float(alpha_s),
    )
    return out


class _HviToRgb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hvi, k, gates):
        ctx.save_for_backward(hvi, k)
        ctx.gates = gates
        return hvi_to_rgb_kernel(hvi, k, **gates)

    @staticmethod
    def backward(ctx, grad):
        hvi, k = ctx.saved_tensors
        grads = twin_backward(
            lambda x, kk: hvi_to_rgb_plain(x, kk, **ctx.gates),
            (hvi, k), grad, ctx.needs_input_grad[:2],
        )
        return (*grads, None)


def hvi_to_rgb(
    hvi: torch.Tensor, k: torch.Tensor, *, gated: bool = False, gated2: bool = False,
    alpha: float = 1.0, alpha_s: float = 1.3,
) -> torch.Tensor:
    """PHVIT: NCHW HVI -> NHWC RGB. ``k`` detached by the caller, as the
    reference's PHVIT read a Python float. CPU: the twin; CUDA: K2."""
    gates = dict(gated=gated, gated2=gated2, alpha=alpha, alpha_s=alpha_s)
    if hvi.device.type == "cpu":
        return hvi_to_rgb_plain(hvi, k, **gates)
    return _HviToRgb.apply(hvi, k, gates)
