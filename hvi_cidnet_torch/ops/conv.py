"""Convolution and norm primitives on NCHW activations.

Counterpart of ``hvi_cidnet_tpu/ops/conv.py``. Weights are OIHW, as in the
reference ``state_dict``; every conv casts its weight to the activation
dtype, as the JAX ``conv2d`` does. The TPU layout machinery (HWCB, the
border-corrected replication-pad conv, LN moments on the MXU) stays behind.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for the cuDNN convolutions and cuBLAS products inside (the
    plain versions of the fused kernels compute in full fp32); the previous
    settings come back on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def conv2d(x: torch.Tensor, w: torch.Tensor, *, padding=0, groups: int = 1) -> torch.Tensor:
    """Stride-1 conv, no bias; ``padding`` as ``F.conv2d`` takes it."""
    return F.conv2d(x, w.to(x.dtype), padding=padding, groups=groups)


def conv1x1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Pointwise conv. ``w``: (C_out, C_in, 1, 1)."""
    return conv2d(x, w)


def dwconv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 with zero SAME padding. ``w``: (C, 1, 3, 3)."""
    return conv2d(x, w, padding=1, groups=x.shape[1])


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense 3x3 with zero SAME padding (the NormDown/Up convs)."""
    return conv2d(x, w, padding=1)


def conv3x3_replpad(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``ReplicationPad2d(1)`` + VALID 3x3 conv: the stems and heads
    (net/CIDNet.py:21-24, 32-35, 39-42, 50-53)."""
    return conv2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), w)


def prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """PReLU with one shared slope, computed in the activation dtype."""
    a = a.reshape(()).to(x.dtype)
    return x.clamp_min(0) + a * x.clamp_max(0)


def layer_norm_channels(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Channel LayerNorm over dim 1: biased variance, eps inside the rsqrt
    (net/transformer_utils.py:24-29).

    fp32 runs the exact two-pass form. Other dtypes keep the statistics in
    fp32 as E[x^2] - E[x]^2 and apply in the activation dtype, as the JAX
    bf16 form does (``hvi_cidnet_tpu/ops/conv.py:196-220``). The plain twin
    of K6 (``ops/norm_cuda.py``, ``csrc/norm.cu``).
    """
    w = weight.reshape(1, -1, 1, 1)
    b = bias.reshape(1, -1, 1, 1)
    if x.dtype == torch.float32:
        u = x.mean(dim=1, keepdim=True)
        d = x - u
        s = (d * d).mean(dim=1, keepdim=True)
        return w * (d * torch.rsqrt(s + eps)) + b
    dt = x.dtype
    n = x.shape[1]
    x32 = x.float()
    u = x32.sum(dim=1, keepdim=True) / n
    m2 = x32.square().sum(dim=1, keepdim=True) / n
    s = (m2 - u * u).clamp_min(0.0)
    scale = torch.rsqrt(s + eps).to(dt)
    shift = u.to(dt)
    return w.to(dt) * ((x - shift) * scale) + b.to(dt)
