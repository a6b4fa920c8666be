"""P7, P8/P9/P11, P12/P13 and P14: the TPU relayouts as one kernel, its
launch plan and the dispatchers.

Each Pallas relayout copies a 3-D array under an axis permutation; each is
one batched 2-D transpose with a strided middle axis,
``out[g, y, m, x] = in[g, x, m, y]`` from (G, X, M, Y) to (G, Y, M, X)
(:func:`geometry`), which ``csrc/relayout.cu`` computes for 2- and 4-byte
elements. Four launch counters, one a row of the kernel table, share the
kernel: ``P7``, ``P8/P9/P11``, ``P12/P13`` and ``P14`` (``KERNELS``).

The plan (:func:`relayout_plan`, cached per shape) first drops unit axes
(:func:`canonical`: at batch 1 the HWCB entry and exit are copies, which
still launch), then picks the tile, the vector widths, the threads of a
warp along a row on each side and the shared tile's row pitch: it scores
each choice on one warp (shared-memory wavefronts an element, the global
sectors its vectors touch) and keeps the best. The CPU tests walk it.

Dispatch is by device only: a CPU tensor takes the plain version
(``ops/relayout.py``), a CUDA tensor the kernel, which raises on what it
does not take (another device, a dtype that is not 2 or 4 bytes, a
tensor that is not contiguous). The kernel paths are ``autograd.Function``
s whose backward runs the plain version's autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from hvi_cidnet_torch.ops import relayout as _plain
from hvi_cidnet_torch.ops._build import CudaKernel, twin_backward, widest_vector

THREADS = 256           # csrc/relayout.cu:kRelayoutThreads
WARP = 32
BANKS = 32              # shared-memory banks of 4 bytes
SECTOR = 32             # bytes of a global memory sector
TILE = 4096             # elements a tile, about
EDGE = 64               # the tile's side along a long axis, the other one long too
MAX_PAD = 16            # row pitches tried: TY .. TY + MAX_PAD - 1 elements
SMEM_LIMIT = 48 * 1024  # csrc/relayout.cu:kRelayoutSmem (no opt-in)
SMS = 132               # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 8       # 256-thread blocks an SM holds


_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS = [_p, _p, _i, _i64, _i64, _i64, _i64, _i, _i, _i, _i, _i, _i, _i, _i, _i, _i]
P7 = CudaKernel("relayout", _ARGS)
P8_P9_P11 = CudaKernel("relayout", _ARGS)
P12_P13 = CudaKernel("relayout", _ARGS)
P14 = CudaKernel("relayout", _ARGS)
KERNELS = {"P7": P7, "P8/P9/P11": P8_P9_P11, "P12/P13": P12_P13, "P14": P14}


# --------------------------------------------------------------------------
# The geometry of each Pallas relayout
# --------------------------------------------------------------------------


def geometry(name: str, shape, *, n_blk: Optional[int] = None,
             steps: int = 3) -> Tuple[tuple, tuple]:
    """((G, X, M, Y), output shape) of relayout ``name`` ("P7", "P8",
    "P9", "P11", "P12", "P13", "P14") on an input of ``shape``."""
    a0, a1, a2 = shape
    if name == "P7":  # (HW, C, B)
        return {0: ((1, 1, 1, a0 * a1 * a2), (a0, a1, a2)),
                1: ((a0, a1, 1, a2), (a0, a2, a1)),
                2: ((1, a0 * a1, 1, a2), (a2, a0, a1)),
                3: ((1, a0, a1, a2), (a2, a1, a0))}[steps]
    if name in ("P8", "P9", "P11"):  # (N, C, B) -> (B, C, N); P11 the reverse
        return (1, a0, a1, a2), (a2, a1, a0)
    g = a0 // n_blk
    if name in ("P12", "P13"):  # (N, C, B) -> (G, B, C, n_blk)
        return (g, n_blk, a1, a2), (g, a2, a1, n_blk)
    if name == "P14":  # (N, C, B) -> (G, B, n_blk, C)
        return (g, n_blk * a1, 1, a2), (g, a2, n_blk, a1)
    raise ValueError(f"unknown relayout {name!r}")


def canonical(g: int, x: int, m: int, y: int) -> tuple:
    """(G, X, M, Y) with unit axes dropped: with Y = 1 the copy is (G, X, M)
    -> (G, M, X), a transpose of X and M; with X = 1 it is (G, M, Y) ->
    (G, Y, M). A swapped axis still of extent 1 makes it a copy of every
    element, (1, 1, 1, G X M Y)."""
    if y == 1:
        x, m, y = x, 1, m
    elif x == 1:
        x, m, y = m, 1, y
    if m == 1 and (x == 1 or y == 1):
        return 1, 1, 1, g * x * y
    return g, x, m, y


# --------------------------------------------------------------------------
# The launch plan
# --------------------------------------------------------------------------


class RelayoutPlan(NamedTuple):
    """How ``csrc/relayout.cu`` runs one (G, X, M, Y) relayout (canonical).

    A copy (``x == 1``): ``blocks`` blocks of THREADS threads copy the
    ``y`` elements in ``vi``-element vectors, grid-stride. A transpose:
    work item w (m fastest, then g, then the tile, y-tiles before x-tiles)
    moves the tile x in [x0, x0 + tx), y in [y0, y0 + ty) of slab (g, m)
    (cut at X and Y), or of ``slabs`` whole slabs g, g + 1, ... (M = 1):
    thread t loads rows t // lx + i * (THREADS // lx) of the item (row r is
    row r % tx of slab r // tx), vectors t % lx + j * lx of ``vi`` elements
    along y, into shared rows of ``pitch`` elements (slab s at column s *
    ty); then stores output rows t // sx + i * (THREADS // sx), vectors
    t % sx + j * sx of ``vo`` elements along x. Block b takes work items b,
    b + blocks, ...
    """

    g: int
    x: int
    m: int
    y: int
    copy: bool
    tx: int
    ty: int
    pitch: int
    vi: int
    vo: int
    lx: int
    sx: int
    slabs: int
    tiles_x: int
    tiles_y: int
    work: int
    blocks: int
    smem_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def tile_shape(x: int, y: int, vi: int, vo: int) -> tuple:
    """(tx, ty): ~TILE elements, the narrow axis whole up to EDGE and the
    other one long; EDGE x EDGE when both are long. A cut side is a whole
    number of vectors."""
    if y <= x:
        ty = min(y, EDGE)
        tx = min(x, max(1, TILE // ty))
    else:
        tx = min(x, EDGE)
        ty = min(y, max(1, TILE // tx))
    if ty < y:
        ty = max(vi, ty // vi * vi)
    if tx < x:
        tx = max(vo, tx // vo * vo)
    return tx, ty


def _wavefronts(words: list) -> int:
    """Shared-memory wavefronts of one warp access: the most distinct
    4-byte words any bank holds among the lanes' addresses."""
    per_bank: dict = {}
    for w in words:
        per_bank.setdefault(w % BANKS, set()).add(w)
    return max((len(s) for s in per_bank.values()), default=0)


def side_cost(along: int, rows: int, vec: int, vectors: int, row_stride: int, itemsize: int,
              pitch: int, tile: Optional[tuple] = None) -> tuple:
    """(global sectors an element, shared wavefronts an element, share of
    the block's threads busy) of one side's first warp: ``along`` lanes a
    row take ``vec``-element vectors of rows ``row_stride`` elements apart
    in global memory. The load side (``tile`` = (tx, ty)) writes input row
    r, row r % tx of slab r // tx, at (r % tx) * pitch + (r // tx) * ty in
    shared memory, as one vector where the pitch keeps it aligned
    (csrc/relayout.cu), else element by element; the store side (``tile``
    None) reads the tile's columns element by element. A vector access of B
    bytes is served in phases of 128 / B lanes."""
    lanes = [(lane // along, lane % along) for lane in range(WARP)]
    lanes = [(r, v) for r, v in lanes if r < rows and v < vectors]
    if not lanes:
        return float("inf"), float("inf"), 0.0
    sectors = {((r * row_stride + v * vec + k) * itemsize) // SECTOR
               for r, v in lanes for k in range(vec)}
    word = lambda e: e * itemsize // 4
    load = tile is not None
    start = lambda r: r % tile[0] * pitch + r // tile[0] * tile[1]
    if load and pitch % vec == 0:  # one vector store a lane
        words = [range(word(start(r) + v * vec), word(start(r) + (v + 1) * vec - 1) + 1)
                 for r, v in lanes]
        phase = max(1, 128 // max(4, vec * itemsize))
        waves = sum(_wavefronts([w for ws in words[i:i + phase] for w in ws])
                    for i in range(0, len(words), phase))
    elif load:
        waves = sum(_wavefronts([word(start(r) + v * vec + k) for r, v in lanes])
                    for k in range(vec))
    else:
        waves = sum(_wavefronts([word((v * vec + k) * pitch + r) for r, v in lanes])
                    for k in range(vec))
    n = len(lanes) * vec
    busy = min(rows, THREADS // along) * min(vectors, along) / THREADS
    return len(sectors) / n, waves / n, busy


def _along_choices(vectors: int) -> list:
    """Threads along a row: powers of two up to the row's vectors (rounded
    up) and THREADS."""
    top = min(THREADS, _pow2_ceil(vectors))
    return [1 << s for s in range(top.bit_length())]


@functools.lru_cache(maxsize=1024)
def relayout_plan(g: int, x: int, m: int, y: int, itemsize: int, in_offset: int = 0,
                  out_offset: int = 0) -> RelayoutPlan:
    """The plan of a (G, X, M, Y) relayout of ``itemsize``-byte elements
    whose input and output start ``in_offset`` and ``out_offset`` bytes
    past 16-byte boundaries. Cached per shape: at batch 1 the host's work
    per launch sets the pace.

    Each side's lanes and the pitch are scored on the first warp (side_cost):
    the fewest sectors (DRAM traffic) first; then, on the load side, the
    most threads busy (the loads in flight hide the memory's latency; a
    store does not wait); then the fewest shared-memory wavefronts; then
    the widest rows of lanes and the narrowest pitch."""
    if min(g, x, m, y) < 1:
        raise ValueError(f"relayout: extents must be >= 1, got {(g, x, m, y)}")
    if itemsize not in (2, 4):
        raise TypeError(f"relayout: {itemsize}-byte elements not supported (2 or 4)")
    g, x, m, y = canonical(g, x, m, y)
    cap = SMS * BLOCKS_PER_SM
    if x == 1:
        v = widest_vector(y, in_offset | out_offset, itemsize)
        work = _cdiv(y, THREADS * v)
        return RelayoutPlan(1, 1, 1, y, True, 1, y, 0, v, v, THREADS, THREADS, 1, 1, 1, work,
                            min(work, cap), 0)
    vi = widest_vector(y, in_offset, itemsize)
    vo = widest_vector(x, out_offset, itemsize)
    tx, ty = tile_shape(x, y, vi, vo)
    # whole slabs under half a tile share a work item (their rows follow
    # each other on both sides when M = 1)
    slabs = min(g, TILE // (x * y)) if m == 1 and 2 * x * y <= TILE else 1
    best = None
    for pitch in range(slabs * ty, slabs * ty + MAX_PAD):
        if tx * pitch * itemsize > SMEM_LIMIT:
            break
        load = min(((sec, -busy, waves, -lx), lx) for lx in _along_choices(ty // vi)
                   for sec, waves, busy in [side_cost(lx, slabs * tx, vi, ty // vi, m * y,
                                                      itemsize, pitch, (tx, ty))])
        store = min(((sec, waves, -sx), sx) for sx in _along_choices(tx // vo)
                    for sec, waves, _ in [side_cost(sx, slabs * ty, vo, tx // vo, m * x,
                                                    itemsize, pitch)])
        (l_sec, l_busy, l_waves, l_wide), (s_sec, s_waves, s_wide) = load[0], store[0]
        score = (l_sec + s_sec, l_busy, l_waves + s_waves, l_wide + s_wide, pitch)
        if best is None or score < best[0]:
            best = (score, pitch, load[1], store[1])
    _, pitch, lx, sx = best
    tiles_x, tiles_y = _cdiv(x, tx), _cdiv(y, ty)
    work = _cdiv(g * m, slabs) * tiles_x * tiles_y
    return RelayoutPlan(g, x, m, y, False, tx, ty, pitch, vi, vo, lx, sx, slabs, tiles_x,
                        tiles_y, work, min(work, cap), tx * pitch * itemsize)


# --------------------------------------------------------------------------
# The kernel and the dispatchers
# --------------------------------------------------------------------------


def relayout_kernel(t: torch.Tensor, counter: CudaKernel, gxmy: tuple,
                    out_shape: tuple) -> torch.Tensor:
    """Launch the relayout of contiguous ``t`` (on the card) viewed as
    (G, X, M, Y) into a new (G, Y, M, X) tensor of ``out_shape``, counted
    on ``counter``."""
    if t.device.type != "cuda":
        raise ValueError(f"relayout: expected a CUDA tensor, got {t.device}")
    if t.element_size() not in (2, 4):
        raise TypeError(f"relayout: dtype {t.dtype} not supported (2- or 4-byte elements)")
    if not t.is_contiguous():
        raise ValueError("relayout: expected a contiguous tensor")
    out = torch.empty(out_shape, dtype=t.dtype, device=t.device)
    if t.numel() == 0:
        return out
    p = relayout_plan(*gxmy, t.element_size(), t.data_ptr() % 16, out.data_ptr() % 16)
    counter(t.device, t.data_ptr(), out.data_ptr(), t.element_size(), p.g, p.x, p.m, p.y,
            p.tx, p.ty, p.pitch, p.vi, p.vo, p.lx, p.sx, p.slabs, p.blocks, p.smem_bytes)
    return out


class _Relayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, counter, gxmy, out_shape, plain):
        ctx.save_for_backward(t)
        ctx.plain = plain
        return relayout_kernel(t, counter, gxmy, out_shape)

    @staticmethod
    def backward(ctx, grad):
        (t,) = ctx.saved_tensors
        (dt,) = twin_backward(ctx.plain, (t,), grad, ctx.needs_input_grad[:1])
        return dt, None, None, None, None


def _relayout(name: str, counter: CudaKernel, plain, x: torch.Tensor,
              n_blk: Optional[int] = None, steps: int = 3) -> torch.Tensor:
    n_blk = _plain.validate(name, x, n_blk, steps)
    if x.device.type == "cpu":
        return plain(x)
    gxmy, out_shape = geometry(name, tuple(x.shape), n_blk=n_blk, steps=steps)
    return _Relayout.apply(x, counter, gxmy, out_shape, plain)


def transpose_steps(x: torch.Tensor, hwt: Optional[int] = None, steps: int = 3) -> torch.Tensor:
    """P7: (HW, C, B) -> (HW, C, B), (HW, B, C), (B, HW, C) or (B, C, HW)
    at ``steps`` 0-3. CPU: plain; CUDA: the kernel."""
    return _relayout("P7", P7, lambda t: _plain.transpose_steps(t, hwt, steps), x, hwt, steps)


def relayout_t3(x: torch.Tensor, n_blk: Optional[int] = None) -> torch.Tensor:
    """P8: (N, C, B) -> (B, C, N). CPU: plain; CUDA: the kernel."""
    return _relayout("P8", P8_P9_P11, lambda t: _plain.relayout_t3(t, n_blk), x, n_blk)


def relayout_t2(x: torch.Tensor, n_blk: Optional[int] = None) -> torch.Tensor:
    """P9: (N, C, B) -> (B, C, N). CPU: plain; CUDA: the kernel."""
    return _relayout("P9", P8_P9_P11, lambda t: _plain.relayout_t2(t, n_blk), x, n_blk)


def relayout_t2_rev(x: torch.Tensor, n_blk: Optional[int] = None) -> torch.Tensor:
    """P11: (B, C, N) -> (N, C, B). CPU: plain; CUDA: the kernel."""
    return _relayout("P11", P8_P9_P11, lambda t: _plain.relayout_t2_rev(t, n_blk), x, n_blk)


def t3_blocked(x: torch.Tensor, n_blk: int) -> torch.Tensor:
    """P12: (N, C, B) -> (G, B, C, n_blk). CPU: plain; CUDA: the kernel."""
    return _relayout("P12", P12_P13, lambda t: _plain.t3_blocked(t, n_blk), x, n_blk)


def t2_blocked(x: torch.Tensor, n_blk: int) -> torch.Tensor:
    """P13: (N, C, B) -> (G, B, C, n_blk). CPU: plain; CUDA: the kernel."""
    return _relayout("P13", P12_P13, lambda t: _plain.t2_blocked(t, n_blk), x, n_blk)


def pack_blocked(x: torch.Tensor, n_blk: int) -> torch.Tensor:
    """P14: (N, C, B) -> (G, B, n_blk, C). CPU: plain; CUDA: the kernel."""
    return _relayout("P14", P14, lambda t: _plain.pack_blocked(t, n_blk), x, n_blk)
