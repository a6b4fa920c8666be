"""P2/P3: the fused LayerNorm + IEL (+ residual) kernel, its plain version
and the dispatcher ``ln_iel``.

Counterpart of ``experiments/iel_fused_pallas.py:fused_iel`` and
``experiments/iel_pallas_nhcw.py:_pallas_ln_iel`` (one function, two TPU
layouts). The kernel is ``csrc/ln_iel.cu`` and takes a contiguous NCHW
activation, the LayerNorm's fp32 weight and bias and the IEL's OIHW
weights in the activation dtype (the wrapper casts them with ``.to(x.dtype)``,
a no-op in the model, whose conv weights hold the compute dtype); the plain
version is ``ops/ln_iel.py:ln_iel``. It launches by a plan computed here
(``ln_iel_plan``: tile height, tiles, shared memory), which the CPU tests
walk.

Dispatch is by device only: a CPU tensor takes the plain version, a CUDA
tensor the kernel. Backward runs the plain version's autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from hvi_cidnet_torch.ops import ln_iel as plain
from hvi_cidnet_torch.ops._build import DTYPE_CODES, CudaKernel, check_input, twin_backward
from hvi_cidnet_torch.ops.norm_cuda import _check_affine

_p, _i = ctypes.c_void_p, ctypes.c_int
LN_IEL = CudaKernel("ln_iel", [_p] * 2 + [_i] + [_p] * 7 + [_i] * 9 + [ctypes.c_float, _i])

EPS = plain.EPS
SMEM_LIMIT = 232_448     # shared memory one block may use (227 KB)
MAX_GRID_X = 2**31 - 1
THREADS = 512            # csrc/ln_iel.cu:kLnIelThreads
CHUNK = 16               # csrc/ln_iel.cu:kChunk, hidden channels of each half per step
TILE_W = 16              # csrc/ln_iel.cu:kTileW
TILE_HEIGHTS = (8, 4, 2)  # tallest first


class LnIelPlan(NamedTuple):
    """How P2/P3 covers a (b, c, h, w) tensor (``csrc/ln_iel.cu``).

    Block i owns output rows [ty * tile_h, (ty + 1) * tile_h) and columns
    [tx * TILE_W, (tx + 1) * TILE_W) of image i // (tiles_y * tiles_x), with
    tx = i % tiles_x and ty = (i // tiles_x) % tiles_y; parts past the image
    are not written. It stages the (tile_h + 4) x (TILE_W + 4) region around
    its tile and walks the hidden channels CHUNK of each half at a time."""

    tile_h: int
    tiles_y: int
    tiles_x: int
    blocks: int
    smem_bytes: int


def ln_iel_smem_bytes(c: int, tile_h: int) -> int:
    """Shared memory of one block (``csrc/ln_iel.cu:ln_iel_smem_floats``):
    x over the 2-ring region, the C x tile accumulator, the chunk's weights,
    its expansion over the 2-ring region and first depthwise conv over the
    1-ring region."""
    p2, p1, p0 = (tile_h + 4) * (TILE_W + 4), (tile_h + 2) * (TILE_W + 2), tile_h * TILE_W
    return 4 * (c * (p2 + p0 + 3 * CHUNK) + 2 * 2 * CHUNK * 9 + 2 * CHUNK * (p2 + p1))


@functools.lru_cache(maxsize=256)
def ln_iel_plan(b: int, c: int, h: int, w: int) -> LnIelPlan:
    """P2/P3's launch plan: the tallest tile (8, 4 or 2 rows of 16 columns)
    whose shared memory fits in a block's 227 KB (C = 36 and 72 take 8 rows,
    C = 144 takes 4)."""
    tile_h = next((t for t in TILE_HEIGHTS if ln_iel_smem_bytes(c, t) <= SMEM_LIMIT), None)
    if tile_h is None:
        raise ValueError(f"P2/P3: C = {c} does not fit in a block's shared memory")
    tiles_y, tiles_x = -(-h // tile_h), -(-w // TILE_W)
    blocks = b * tiles_y * tiles_x
    if blocks > MAX_GRID_X:
        raise ValueError(f"P2/P3: {blocks} blocks, past the grid's limit")
    return LnIelPlan(tile_h, tiles_y, tiles_x, blocks, ln_iel_smem_bytes(c, tile_h))


def ln_iel_plain(x, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, residual: bool):
    """Plain version of P2/P3."""
    return plain.ln_iel(x, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, residual)


def _weight(t: torch.Tensor, shape: tuple, x: torch.Tensor, name: str) -> torch.Tensor:
    if tuple(t.shape) != shape or t.device != x.device:
        raise ValueError(f"{name}: expected {shape} on {x.device}, got {tuple(t.shape)} on "
                         f"{t.device}")
    t = t.to(x.dtype)
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t


def ln_iel_kernel(x, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, residual: bool):
    """Launch P2/P3 on contiguous NCHW ``x`` on the card."""
    check_input(x, "x", 4)
    b, c, h, w = x.shape
    hid = w_pi.shape[0] // 2
    if h * w >= 2**31:
        raise ValueError(f"x: P2/P3 takes planes below 2**31 elements, got {h} x {w}")
    _check_affine(ln_w, c, x.device, "ln_w")
    _check_affine(ln_b, c, x.device, "ln_b")
    w_pi = _weight(w_pi, (2 * hid, c, 1, 1), x, "w_pi")
    w_dw = _weight(w_dw, (2 * hid, 1, 3, 3), x, "w_dw")
    w_dw1 = _weight(w_dw1, (hid, 1, 3, 3), x, "w_dw1")
    w_dw2 = _weight(w_dw2, (hid, 1, 3, 3), x, "w_dw2")
    w_po = _weight(w_po, (c, hid, 1, 1), x, "w_po")
    plan = ln_iel_plan(b, c, h, w)
    out = torch.empty_like(x)
    LN_IEL(x.device, x.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype], ln_w.data_ptr(),
           ln_b.data_ptr(), w_pi.data_ptr(), w_dw.data_ptr(), w_dw1.data_ptr(), w_dw2.data_ptr(),
           w_po.data_ptr(), b, c, hid, h, w, plan.tile_h, plan.tiles_x, plan.tiles_y,
           int(residual), EPS, plan.smem_bytes)
    return out


class _LnIel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, residual):
        ctx.save_for_backward(x, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po)
        ctx.residual = residual
        return ln_iel_kernel(x, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, residual)

    @staticmethod
    def backward(ctx, grad):
        fn = lambda *a: ln_iel_plain(*a, ctx.residual)
        return (*twin_backward(fn, ctx.saved_tensors, grad, ctx.needs_input_grad[:8]), None)


def ln_iel(x, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, residual: bool):
    """LayerNorm + IEL (+ residual) of an LCA block. CPU: plain; CUDA: P2/P3."""
    if x.device.type == "cpu":
        return ln_iel_plain(x, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, residual)
    return _LnIel.apply(x, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, residual)
