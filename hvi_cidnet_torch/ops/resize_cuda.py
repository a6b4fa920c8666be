"""K3 and K4: fused bilinear x0.5 + PReLU and bilinear x2 kernels, their
plain twins and the dispatchers ``half_prelu`` / ``double_bilinear``.

Counterpart of ``hvi_cidnet_tpu/ops/resize_pallas.py``. The kernels are
``csrc/resize.cu`` and take contiguous NCHW activations. Kernels and twins
(``ops/resize.py``) use the same float64-derived fp32 band weights, uploaded
once per (size, device), the same tap order (H pass, then W pass) and fp32
arithmetic with one rounding to the activation dtype at the end, after
K3's shared-slope PReLU. K4 launches by a plan computed here
(``double_plan``: block shape, store width, grid), which the CPU tests walk.

Dispatch is by device only: a CPU tensor takes the plain twin, a CUDA
tensor the kernel. Backward runs the twin's autograd.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from hvi_cidnet_torch.ops._build import (
    DTYPE_CODES,
    CudaKernel,
    check_input,
    scalar_pointer,
    twin_backward,
)
from hvi_cidnet_torch.ops.conv import prelu
from hvi_cidnet_torch.ops.resize import axis_weights, scale_double_f32, scale_half_f32

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
HALF_PRELU = CudaKernel("resize_half_prelu", [_p, _p, _i, _p, _p, _p, _i64, _i64, _i64])
DOUBLE = CudaKernel("resize_double",
                    [_p, _p, _i, _p, _p, _i64, _i64, _i64, _i, _i, _i, _i, _i, _i])


# --------------------------------------------------------------------------
# K3: bilinear x0.5 + PReLU
# --------------------------------------------------------------------------


def half_prelu_plain(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Twin of K3: ``prelu(UpsamplingBilinear2d(0.5)(x), alpha)``, in fp32."""
    return prelu(scale_half_f32(x), alpha).to(x.dtype)


def half_prelu_kernel(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Launch K3 on contiguous NCHW ``x`` on the card."""
    check_input(x, "x", 4)
    b, c, h, w = x.shape
    if h < 2 or w < 2:
        raise ValueError(f"x: bilinear x0.5 needs H, W >= 2, got shape {tuple(x.shape)}")
    out = torch.empty((b, c, h // 2, w // 2), dtype=x.dtype, device=x.device)
    HALF_PRELU(
        x.device, x.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype],
        axis_weights("half", h, x.device).data_ptr(),
        axis_weights("half", w, x.device).data_ptr(),
        scalar_pointer(alpha, x.device, "prelu slope"), b * c, h, w,
    )
    return out


class _HalfPrelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x, alpha)
        return half_prelu_kernel(x, alpha)

    @staticmethod
    def backward(ctx, grad):
        x, alpha = ctx.saved_tensors
        return twin_backward(half_prelu_plain, (x, alpha), grad, ctx.needs_input_grad)


def half_prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """NormDownsample's tail: bilinear x0.5 then PReLU. CPU: twin; CUDA: K3."""
    if x.device.type == "cpu":
        return half_prelu_plain(x, alpha)
    return _HalfPrelu.apply(x, alpha)


# --------------------------------------------------------------------------
# K4: bilinear x2
# --------------------------------------------------------------------------


def double_bilinear_plain(x: torch.Tensor) -> torch.Tensor:
    """Twin of K4: ``UpsamplingBilinear2d(2)(x)``, in fp32."""
    return scale_double_f32(x).to(x.dtype)


MAX_GRID_X = 2**31 - 1   # CUDA's limit on gridDim.x
# K4's block: a warp covers 32 chunks (512 contiguous bytes) of one output
# row; each thread walks 2 source rows. On the card, narrower warps were
# slower at every site of the 600 x 400 forward, while the rows per thread
# and the warps per block mattered little.
DOUBLE_BLOCK = (32, 4)
DOUBLE_ROWS = 2


class DoublePlan(NamedTuple):
    """How K4 covers a (planes, 2h, 2w) output (``csrc/resize.cu``).

    Block (tx, ty), a 1-D grid of planes * gy * gz blocks; block b is (p, by,
    bz) with b = (p * gy + by) * gz + bz. Its thread (tx_i, ty_i) owns output
    columns [c0, c0 + chunk) with c0 = (bz * tx + tx_i) * chunk, and source
    rows [j0, j0 + rows_per_thread) with j0 = (by * ty + ty_i) *
    rows_per_thread, each giving output rows 2j and 2j + 1; parts past the
    plane are skipped. Stores are ``store`` elements wide.
    """

    chunk: int            # output columns per thread: 16 bytes
    store: int            # elements per vector store
    tx: int
    ty: int
    rows_per_thread: int
    grid: tuple           # (planes, gy, gz); planes * gy * gz blocks


def double_plan(planes: int, h: int, w: int, itemsize: int) -> DoublePlan:
    """K4's launch plan: the widest aligned store the output row allows
    (2w is even, so a pair always fits) and enough blocks to cover it."""
    chunk = 16 // itemsize
    store = chunk
    while (2 * w) % store:
        store //= 2
    tx, ty = DOUBLE_BLOCK
    chunks = -(-2 * w // chunk)
    gy, gz = -(-h // (ty * DOUBLE_ROWS)), -(-chunks // tx)
    if planes * gy * gz > MAX_GRID_X:
        raise ValueError(f"K4: {planes} planes of {h} x {w} need more than {MAX_GRID_X} blocks")
    return DoublePlan(chunk, store, tx, ty, DOUBLE_ROWS, (planes, gy, gz))


def double_bilinear_kernel(x: torch.Tensor) -> torch.Tensor:
    """Launch K4 on contiguous NCHW ``x`` on the card."""
    check_input(x, "x", 4)
    b, c, h, w = x.shape
    if h * w >= 2**31:
        raise ValueError(f"x: K4 takes planes below 2**31 elements, got {h} x {w}")
    out = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    plan = double_plan(b * c, h, w, x.element_size())
    DOUBLE(
        x.device, x.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype],
        axis_weights("double", h, x.device).data_ptr(),
        axis_weights("double", w, x.device).data_ptr(),
        b * c, h, w, plan.store, plan.tx, plan.ty, plan.rows_per_thread, *plan.grid[1:],
    )
    return out


class _Double(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return double_bilinear_kernel(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return twin_backward(double_bilinear_plain, (x,), grad, ctx.needs_input_grad)


def double_bilinear(x: torch.Tensor) -> torch.Tensor:
    """NormUpsample's bilinear x2. CPU: twin; CUDA: K4."""
    if x.device.type == "cpu":
        return double_bilinear_plain(x)
    return _Double.apply(x)
