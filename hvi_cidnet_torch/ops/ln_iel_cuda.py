"""P2/P3: the fused LayerNorm + IEL (+ residual) kernel, its plain version
and the dispatcher ``ln_iel``.

Counterpart of ``experiments/iel_fused_pallas.py:fused_iel`` and
``experiments/iel_pallas_nhcw.py:_pallas_ln_iel`` (one function in fp32,
two TPU layouts; in bf16 the port rounds where P3 does). The kernel is
``csrc/ln_iel.cu`` and takes a contiguous NCHW activation, the LayerNorm's
fp32 weight and bias and the IEL's OIHW weights in the activation dtype
(the wrapper casts them with ``.to(x.dtype)``, a no-op in the model, whose
conv weights hold the compute dtype); the plain version is
``ops/ln_iel.py:ln_iel``. It launches by plans computed here, which the CPU
tests walk: bf16 by ``ln_iel_mma_plan`` (both products on the tensor cores,
8 x 32 or 8 x 16 tiles, the weights packed once a call), fp32 by
``ln_iel_plan`` (the CUDA cores: tile height, tiles, shared memory).

Dispatch is by device only: a CPU tensor takes the plain version, a CUDA
tensor the kernel. Backward runs the plain version's autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from hvi_cidnet_torch.ops import ln_iel as plain
from hvi_cidnet_torch.ops._build import (
    DTYPE_CODES,
    CudaKernel,
    check_input,
    twin_backward,
    widest_vector,
)
from hvi_cidnet_torch.ops.norm_cuda import _check_affine
from hvi_cidnet_torch.utils import flops

_p, _i = ctypes.c_void_p, ctypes.c_int
LN_IEL = CudaKernel("ln_iel", [_p] * 2 + [_i] + [_p] * 8 + [_i] * 9 + [ctypes.c_float] + [_i] * 4)

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


# bf16, the tensor-core arm (csrc/ln_iel.cu:ln_iel_mma_kernel)
MMA_TILE_H = 8           # kMTileH
# (tile width, threads a block, blocks an SM, project_out's n8 tiles a warp
# the kernel is built for), the first that fits first: two blocks of 256
# threads an SM overlap each other's serial phases
MMA_ARMS = ((16, 256, 2, range(1, 7)), (32, 512, 1, range(1, 10)), (16, 512, 1, range(5, 10)))
HALF = 16                # kHalf: hidden channels of each half a chunk
PR_PITCH = HALF + 8      # kPrPitch
TAP_PITCH = 12           # kTapPitch: fp32 a channel's 9 taps, padded
PI_PITCH = 36            # kPiPitch: fp32 a pixel of the expansion
SM_SMEM = 228 * 1024     # an SM's shared memory, 1 KB of it reserved a block


class LnIelMmaPlan(NamedTuple):
    """How P2/P3's tensor-core arm (bf16) covers a (b, c, h, w) tensor.

    Blocks of ``threads`` threads, ``blocks_per_sm`` an SM. Block i owns
    output rows [ty * 8, ty * 8 + 8) and columns [tx * tile_w, (tx + 1) *
    tile_w) of image i // (tiles_y * tiles_x), with tx = i % tiles_x and ty
    = (i // tiles_x) % tiles_y; parts past the image are not written. C is
    padded to ``cpad`` (a multiple of 16) for the expansion, the hidden
    channels go ``HALF`` of each half a chunk (``chunks``), and warp w keeps
    project_out's sums of m16 tile w % (8 tile_w / 16) of the tile's pixels
    and ``n_tiles_warp`` n8 tiles of channels from (w // (8 tile_w / 16))
    n_tiles_warp: ``npad`` output channels in all, zero past C. ``vec``:
    the elements of each output store; ``pack_bytes``: the packed weights'
    scratch."""

    tile_h: int
    tile_w: int
    threads: int
    blocks_per_sm: int
    tiles_y: int
    tiles_x: int
    blocks: int
    cpad: int
    chunks: int
    n_tiles_warp: int
    npad: int
    vec: int
    smem_bytes: int
    pack_bytes: int


def chunk_bytes(cpad: int, npad: int) -> int:
    """One chunk's packed weights (csrc/ln_iel.cu:li_chunk_bytes): W_pi
    [32][cpad + 8] and W_po [npad][24] in bf16, two depthwise convs' taps
    [32][12] in fp32."""
    return 2 * 2 * HALF * (cpad + 8) + 2 * npad * PR_PITCH + 2 * 4 * 2 * HALF * TAP_PITCH


def ln_iel_mma_smem_bytes(tile_w: int, cpad: int, npad: int) -> int:
    """Shared memory of one block of the tensor-core arm (csrc/ln_iel.cu:
    li_smem_bytes): A over the 2-pixel ring, the chunk's expansion there, its
    first depthwise conv over the 1-pixel ring, the product tile and two
    chunks of weights."""
    p2 = (MMA_TILE_H + 4) * (tile_w + 4)
    p1 = (MMA_TILE_H + 2) * (tile_w + 2)
    p0 = MMA_TILE_H * tile_w
    return (2 * p2 * (cpad + 8) + 4 * (p2 * PI_PITCH + p1 * 2 * HALF)
            + 2 * p0 * PR_PITCH + 2 * chunk_bytes(cpad, npad))


def epilogue_fits(c: int, tile_w: int, cpad: int, npad: int) -> bool:
    """The rounded outputs [C][8 tile_w + 8] fit over the tiles before the
    weights."""
    return 2 * c * (MMA_TILE_H * tile_w + 8) <= \
        ln_iel_mma_smem_bytes(tile_w, cpad, npad) - 2 * chunk_bytes(cpad, npad)


@functools.lru_cache(maxsize=256)
def ln_iel_mma_plan(b: int, c: int, h: int, w: int, hid: int) -> LnIelMmaPlan:
    """P2/P3's launch plan in bf16: the first of ``MMA_ARMS`` whose
    project_out sums fit a warp's registers and whose shared memory fits
    its blocks an SM (C <= 48: two blocks of 256 threads on 8 x 16 tiles;
    up to 72 one block of 512 on 8 x 32, up to 144 on 8 x 16)."""
    cpad, nt = -(-c // 16) * 16, -(-c // 8)
    for tile_w, threads, per_sm, built in MMA_ARMS:
        nh = threads // 32 // (MMA_TILE_H * tile_w // 16)
        ntw = -(-nt // nh)
        npad = 8 * ntw * nh
        smem = ln_iel_mma_smem_bytes(tile_w, cpad, npad)
        budget = min(SMEM_LIMIT, SM_SMEM // per_sm - 1024)
        if ntw in built and smem <= budget and epilogue_fits(c, tile_w, cpad, npad):
            break
    else:
        raise ValueError(f"P2/P3: C = {c} does not fit the tensor-core arm (C <= 144)")
    tiles_y, tiles_x = -(-h // MMA_TILE_H), -(-w // tile_w)
    blocks = b * tiles_y * tiles_x
    if blocks > MAX_GRID_X:
        raise ValueError(f"P2/P3: {blocks} blocks, past the grid's limit")
    chunks = -(-hid // HALF)
    return LnIelMmaPlan(MMA_TILE_H, tile_w, threads, per_sm, tiles_y, tiles_x, blocks, cpad,
                        chunks, ntw, npad, widest_vector(w, 0, 2), smem,
                        chunks * chunk_bytes(cpad, npad))


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
    """Launch P2/P3 on contiguous NCHW ``x`` on the card: bf16 on the tensor
    cores (``ln_iel_mma_plan``), fp32 on the CUDA cores (``ln_iel_plan``)."""
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
    out = torch.empty_like(x)
    ptrs = (ln_w.data_ptr(), ln_b.data_ptr(), w_pi.data_ptr(), w_dw.data_ptr(), w_dw1.data_ptr(),
            w_dw2.data_ptr(), w_po.data_ptr())
    if x.dtype == torch.bfloat16:
        plan = ln_iel_mma_plan(b, c, h, w, hid)
        wpack = torch.empty(plan.pack_bytes, dtype=torch.uint8, device=x.device)
        LN_IEL(x.device, x.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype], *ptrs,
               wpack.data_ptr(), b, c, hid, h, w, plan.tile_w, plan.tiles_x, plan.tiles_y,
               int(residual), EPS, plan.smem_bytes, plan.threads, plan.n_tiles_warp, plan.vec)
    else:
        plan = ln_iel_plan(b, c, h, w)
        LN_IEL(x.device, x.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype], *ptrs, None, b, c,
               hid, h, w, plan.tile_h, plan.tiles_x, plan.tiles_y, int(residual), EPS,
               plan.smem_bytes, 0, 0, 0)
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
    with flops.kernel("P2/P3", x):
        if x.device.type == "cpu":
            return ln_iel_plain(x, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, residual)
        return _LnIel.apply(x, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, residual)
