"""K6: the channel LayerNorm kernel, its plain twin and the dispatcher
``layer_norm``.

Counterpart of ``hvi_cidnet_tpu/ops/norm_pallas.py``. The kernel is
``csrc/norm.cu`` and takes a contiguous NCHW activation (fp32 or bf16) and
the LayerNorm's fp32 weight and bias; the twin is
``ops/conv.py:layer_norm_channels`` (fp32: the exact two-pass form; bf16:
fp32 statistics, bf16 apply), whose arithmetic the kernel repeats op for op.

Dispatch is by device only: a CPU tensor takes the plain twin, a CUDA
tensor the kernel. Backward runs the twin's autograd.
"""

from __future__ import annotations

import ctypes

import torch

from hvi_cidnet_torch.ops._build import DTYPE_CODES, CudaKernel, check_input, twin_backward
from hvi_cidnet_torch.ops.conv import layer_norm_channels

EPS = 1e-6
MAX_CHANNELS = 256  # the kernel stages a C x 128-pixel slice in shared memory

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
LAYER_NORM = CudaKernel("layer_norm_channels", [_p, _p, _i, _p, _p, _i64, _i, _i64, ctypes.c_float])


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Twin of K6."""
    return layer_norm_channels(x, weight, bias, EPS)


def _check_affine(t: torch.Tensor, c: int, device: torch.device, name: str) -> None:
    if t.dtype != torch.float32 or t.device != device or t.numel() != c or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected {c} contiguous fp32 values on {device}, got {tuple(t.shape)} "
            f"{t.dtype} on {t.device}"
        )


def layer_norm_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch K6 on contiguous NCHW ``x`` on the card."""
    check_input(x, "x", 4)
    b, c, h, w = x.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"x: the LayerNorm kernel takes C <= {MAX_CHANNELS}, got {c}")
    _check_affine(weight, c, x.device, "weight")
    _check_affine(bias, c, x.device, "bias")
    out = torch.empty_like(x)
    LAYER_NORM(
        x.device, x.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype], weight.data_ptr(),
        bias.data_ptr(), b, c, h * w, EPS,
    )
    return out


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return layer_norm_kernel(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        return twin_backward(layer_norm_plain, ctx.saved_tensors, grad, ctx.needs_input_grad)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Channel LayerNorm of the LCA blocks. CPU: twin; CUDA: K6."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias)
    return _LayerNorm.apply(x, weight, bias)
