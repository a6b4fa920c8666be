"""P4 and P5: the dense 3x3 conv kernel and the fused NormDownsample kernel
(conv 3x3 -> bilinear x0.5 -> PReLU), their plain versions and the
dispatchers ``conv3x3`` and ``conv3x3_half_prelu``.

Counterpart of ``experiments/conv_pallas_nhcw.py:_pallas_conv3x3`` (P4,
``pad_mode`` "zero" or "edge") and ``experiments/fused_pallas_nhcw.py:
_pallas_down`` (P5). Both kernels are ``csrc/conv3x3.cu`` and take a
contiguous NCHW activation and the OIHW weight in the activation dtype (the
wrapper casts it with ``.to(x.dtype)``, a no-op in the model); P5 also
takes K3's float64-derived band weights (``ops/resize.py:axis_weights``)
and the PReLU's fp32 slope on the card. Plain versions: P4's is the port's
``conv3x3_same`` / ``conv3x3_replpad`` (``ops/conv.py``); P5's is
``conv3x3_same`` in fp32 (TF32 off), then K3's plain ``half_prelu`` in
fp32, cast once at the end. Both launch by plans computed here
(``conv3x3_plan``, ``half_plan``), which the CPU tests walk.

Dispatch is by device only: a CPU tensor takes the plain version, a CUDA
tensor the kernel. Backward runs the plain version's autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from hvi_cidnet_torch.ops._build import (
    DTYPE_CODES,
    CudaKernel,
    check_input,
    scalar_pointer,
    twin_backward,
)
from hvi_cidnet_torch.ops.conv import conv3x3_replpad, conv3x3_same, exact_fp32
from hvi_cidnet_torch.ops.resize import axis_weights
from hvi_cidnet_torch.ops.resize_cuda import half_prelu_plain
from hvi_cidnet_torch.utils import flops

_p, _i = ctypes.c_void_p, ctypes.c_int
CONV3X3 = CudaKernel("conv3x3", [_p] * 3 + [_i] * 11)
CONV3X3_HALF_PRELU = CudaKernel("conv3x3_half_prelu", [_p] * 3 + [_i] + [_p] * 3 + [_i] * 9)

PAD_MODES = ("zero", "edge")
MAX_GRID_X = 2**31 - 1
THREADS = 256                 # csrc/conv3x3.cu:kConvThreads, one conv pixel a thread
CI_STEP = 8                   # csrc/conv3x3.cu:kCiStep
CO_TILES = (12, 4)            # output channels a block (the kernel's instantiations)
TILE = (8, 32)                # P4: output rows x columns a block (kTileH, kTileW)
HALF_TILE = (3, 16)           # P5: half-size output rows x columns a block (kHalfH, kHalfW)


class ConvPlan(NamedTuple):
    """How P4 or P5 covers its output (``csrc/conv3x3.cu``).

    Block i owns output channels [g * co_tile, (g + 1) * co_tile) (those
    below C_out) of image i // (groups * tiles_y * tiles_x), with g = (i //
    (tiles_y * tiles_x)) % groups, and the tile_h x tile_w output tile at
    tile row (i // tiles_x) % tiles_y and column i % tiles_x (P5: of the
    half-size output); parts past the output are not written. P4 computes
    its tile's conv outputs one pixel a thread; P5 the (2 tile_h + 1) x
    (2 tile_w + 1) conv outputs that its tile's bilinear taps read."""

    co_tile: int
    tile_h: int
    tile_w: int
    tiles_y: int
    tiles_x: int
    groups: int
    blocks: int
    conv_pixels: int      # conv outputs a block computes (at most THREADS)
    smem_bytes: int       # static shared memory of a block


def _co_tile(cout: int) -> int:
    """12 output channels a block, or 4 where that leaves fewer idle (C_out
    of 1 to 4, the heads)."""
    return min(CO_TILES, key=lambda t: (-(-cout // t) * t - cout, -t))


def _plan(b: int, cout: int, oh: int, ow: int, tile: tuple, conv: tuple, smem_floats) -> ConvPlan:
    co_tile = _co_tile(cout)
    tiles_y, tiles_x = -(-oh // tile[0]), -(-ow // tile[1])
    groups = -(-cout // co_tile)
    blocks = b * groups * tiles_y * tiles_x
    if blocks > MAX_GRID_X:
        raise ValueError(f"conv3x3: {blocks} blocks, past the grid's limit")
    return ConvPlan(co_tile, *tile, tiles_y, tiles_x, groups, blocks, conv[0] * conv[1],
                    4 * smem_floats(co_tile))


@functools.lru_cache(maxsize=256)
def conv3x3_plan(b: int, cout: int, h: int, w: int) -> ConvPlan:
    """P4's launch plan for a (b, *, h, w) -> (b, cout, h, w) conv."""
    th, tw = TILE
    return _plan(b, cout, h, w, TILE, TILE,
                 lambda co: CI_STEP * (th + 2) * (tw + 2) + CI_STEP * 9 * co)


@functools.lru_cache(maxsize=256)
def half_plan(b: int, cout: int, h: int, w: int) -> ConvPlan:
    """P5's launch plan for a (b, *, h, w) input, (b, cout, h // 2, w // 2)
    output."""
    th, tw = HALF_TILE
    rh, rw = 2 * th + 1, 2 * tw + 1
    return _plan(b, cout, h // 2, w // 2, HALF_TILE, (rh, rw),
                 lambda co: CI_STEP * (rh + 2) * (rw + 2) + CI_STEP * 9 * co + co * rh * rw)


# --------------------------------------------------------------------------
# P4: dense 3x3
# --------------------------------------------------------------------------


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """Plain version of P4: the port's zero-padded or replication-padded 3x3
    conv, in the activation dtype."""
    return conv3x3_same(x, w) if pad_mode == "zero" else conv3x3_replpad(x, w)


def _weight(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    cin = x.shape[1]
    if w.dim() != 4 or tuple(w.shape[1:]) != (cin, 3, 3) or w.device != x.device:
        raise ValueError(f"w: expected a (C_out, {cin}, 3, 3) weight on {x.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    w = w.to(x.dtype)
    if not w.is_contiguous():
        raise ValueError("w: expected a contiguous tensor")
    return w


def _check_pad(pad_mode: str) -> None:
    if pad_mode not in PAD_MODES:
        raise ValueError(f"pad_mode {pad_mode!r} is not one of {PAD_MODES}")


def conv3x3_kernel(x: torch.Tensor, w: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """Launch P4 on contiguous NCHW ``x`` on the card."""
    _check_pad(pad_mode)
    check_input(x, "x", 4)
    b, cin, h, wd = x.shape
    w = _weight(w, x)
    cout = w.shape[0]
    if max(cin, cout) * h * wd >= 2**31:
        raise ValueError(f"x: P4 takes images below 2**31 elements, got {tuple(x.shape)}")
    plan = conv3x3_plan(b, cout, h, wd)
    out = torch.empty((b, cout, h, wd), dtype=x.dtype, device=x.device)
    CONV3X3(x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype], b, cin,
            cout, h, wd, int(pad_mode == "edge"), plan.co_tile, plan.tiles_x, plan.tiles_y,
            plan.groups)
    return out


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, pad_mode):
        ctx.save_for_backward(x, w)
        ctx.pad_mode = pad_mode
        return conv3x3_kernel(x, w, pad_mode)

    @staticmethod
    def backward(ctx, grad):
        fn = lambda x, w: conv3x3_plain(x, w, ctx.pad_mode)
        return (*twin_backward(fn, ctx.saved_tensors, grad, ctx.needs_input_grad[:2]), None)


def conv3x3(x: torch.Tensor, w: torch.Tensor, pad_mode: str = "zero") -> torch.Tensor:
    """Dense 3x3 stride-1 conv, zero SAME padding or the replication pad.
    CPU: plain; CUDA: P4."""
    with flops.kernel("P4", x, cout=w.shape[0]):
        _check_pad(pad_mode)
        if x.device.type == "cpu":
            return conv3x3_plain(x, w, pad_mode)
        return _Conv3x3.apply(x, w, pad_mode)


# --------------------------------------------------------------------------
# P5: conv 3x3 -> bilinear x0.5 -> PReLU
# --------------------------------------------------------------------------


def conv3x3_half_prelu_plain(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain version of P5: ``conv3x3_same`` in fp32 with TF32 off (the
    weight taken in the activation dtype, then widened), K3's plain x0.5 +
    PReLU in fp32, one cast to the activation dtype."""
    with exact_fp32():
        y = conv3x3_same(x.float(), w.to(x.dtype).float())
    return half_prelu_plain(y, alpha).to(x.dtype)


def conv3x3_half_prelu_kernel(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Launch P5 on contiguous NCHW ``x`` on the card."""
    check_input(x, "x", 4)
    b, cin, h, wd = x.shape
    if h < 2 or wd < 2:
        raise ValueError(f"x: bilinear x0.5 needs H, W >= 2, got shape {tuple(x.shape)}")
    w = _weight(w, x)
    cout = w.shape[0]
    if max(cin, cout) * h * wd >= 2**31:
        raise ValueError(f"x: P5 takes images below 2**31 elements, got {tuple(x.shape)}")
    plan = half_plan(b, cout, h, wd)
    out = torch.empty((b, cout, h // 2, wd // 2), dtype=x.dtype, device=x.device)
    CONV3X3_HALF_PRELU(
        x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype],
        axis_weights("half", h, x.device).data_ptr(), axis_weights("half", wd, x.device).data_ptr(),
        scalar_pointer(alpha, x.device, "prelu slope"), b, cin, cout, h, wd, plan.co_tile,
        plan.tiles_x, plan.tiles_y, plan.groups,
    )
    return out


class _Conv3x3HalfPrelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, alpha):
        ctx.save_for_backward(x, w, alpha)
        return conv3x3_half_prelu_kernel(x, w, alpha)

    @staticmethod
    def backward(ctx, grad):
        return twin_backward(conv3x3_half_prelu_plain, ctx.saved_tensors, grad,
                             ctx.needs_input_grad)


def conv3x3_half_prelu(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """NormDownsample's conv, x0.5 and PReLU in one pass. CPU: plain; CUDA:
    P5."""
    with flops.kernel("P5", x, cout=w.shape[0]):
        if x.device.type == "cpu":
            return conv3x3_half_prelu_plain(x, w, alpha)
        return _Conv3x3HalfPrelu.apply(x, w, alpha)
