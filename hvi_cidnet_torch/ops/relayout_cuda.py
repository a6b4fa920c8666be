"""P7, P8/P9/P11, P12/P13 and P14: the TPU relayouts as one kernel, its
launch plan and the dispatchers.

Each Pallas relayout copies a 3-D array under an axis permutation; each is
one batched 2-D transpose with a strided middle axis,
``out[g, y, m, x] = in[g, x, m, y]`` from (G, X, M, Y) to (G, Y, M, X)
(:func:`geometry`), which ``csrc/relayout.cu`` computes for 2- and 4-byte
elements. Four launch counters, one a row of the kernel table, share the
kernel: ``P7``, ``P8/P9/P11``, ``P12/P13`` and ``P14`` (``KERNELS``).

The plan (:func:`relayout_plan`, cached per shape and offsets) first drops
unit axes (:func:`canonical`: at batch 1 the HWCB entry and exit are
copies, which still launch), then picks the kernel's arm:

* ``BULK`` where M > 1, M rows of the narrow axis hold MIN_ROW bytes, X
  and Y are whole 16-byte vectors and both tensors start 16-byte aligned
  (:func:`bulk_plan`): work items of k slabs g, tm channels m and a tile
  of the long axis, the narrow axis whole; a narrow side moved
  by bulk copies, a long side by 4-D tensor map boxes of one 128-byte line
  x tmb channels (tmb odd) x the narrow extent, 128-byte swizzle; a ring of
  ``stages`` input and output buffers; the pitches keep the transposition's
  16-byte shared accesses free of bank conflicts;
* ``ASYNC`` elsewhere (:func:`async_plan`): tiles of one (g, m) slab (of
  ``k`` whole slabs of G where M = 1) by cp.async copies of the widest
  vectors the extents and the starts allow into a two-stage ring where
  half the blocks take a second item, else (``tiles``: PR 10's kernel)
  through registers in one stage; the threads a row and the pitch scored
  on one warp (shared-memory wavefronts an element, sectors, threads
  busy);
* ``COPY`` for a copy.

The CPU tests replay the plans (``tests/test_torch_launch_plan.py``).

Dispatch is by device only: a CPU tensor takes the plain version
(``ops/relayout.py``), a CUDA tensor the kernel, which raises on what it
does not take (another device, a dtype that is not 2 or 4 bytes, a
tensor that is not contiguous). The kernel paths are ``autograd.Function``
s whose backward runs the plain version's autograd.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from hvi_cidnet_torch.ops import relayout as _plain
from hvi_cidnet_torch.ops._build import CudaKernel, sm_count, twin_backward, widest_vector

THREADS = 256             # csrc/relayout.cu:kRelayoutThreads
BULK_THREADS = THREADS + 32  # the bulk arm's: and its producer warp (kBulkThreads)
WARP = 32
BANKS = 32                # shared-memory banks of 4 bytes
SECTOR = 32               # bytes of a global memory sector
SMS = 132                 # H100 SXM; the wrapper passes the card's own count
SMEM_CAP = 227 * 1024     # a block's shared memory (csrc/relayout.cu:kSmemCap)
SMEM_SM = 228 * 1024      # an SM's, 1 KB of it reserved a block
BLOCKS_PER_SM = 8         # 256-thread blocks an SM holds
COPY, BULK, ASYNC = 0, 1, 2
BULK_SIDE, LONG_BOX, NARROW_BOX = 0, 1, 2  # how a side of the bulk arm moves (csrc/relayout.cu)
BOX_ROWS = 256            # a box's rows along a, at most (kBoxRows)
# the bulk arm
LINE = 128                # bytes of a box's inner line, the swizzle's row (kLine)
ITEM_BYTES = 8 * 1024     # a side's bytes an item, at most (where tmb channels fit)
NARROW_BYTES = 512        # an axis whose rows are this short is whole in every item
MIN_ROW = 512             # bytes a narrow side's row of tm channels holds, at least
MAX_STAGES = 3            # the ring's depth at most (csrc/relayout.cu:kMaxStages)
RING_ALIGN = 1024         # kRingAlign: the ring's and each box region's alignment
BARS = 3 * 8 * MAX_STAGES  # the ring's mbarriers: full, done and free, kMaxStages each
MAX_ITEMS = 1 << 22       # work items the kernel's float divisions index exactly
# the cp.async arm
TILE = 4096               # elements a tile, about
EDGE = 64                 # the tile's side along a long axis
MAX_PAD = 16              # row pitches tried: k TY .. k TY + MAX_PAD - 1 elements
ASYNC_SMEM = 48 * 1024    # a stage of its two
RING_ITEMS = 1.5          # items a block, on average, for its ring: half the blocks take two


_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGS = [_p, _p, _i, _i64, _i64, _i64, _i64, ctypes.POINTER(ctypes.c_int)]
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

    Fields ``arm`` .. ``smem`` are the kernel's plan array (:meth:`c_plan`).
    Work item w (x-tiles fastest, then y-tiles, channel chunks, slab
    groups) covers x in [x0, x0 + tx), y in [y0, y0 + ty), m in [m0, m0 +
    tm) of slabs [g0, g0 + k), cut at the extents (``ASYNC``: one (g, m)
    slab, or k whole slabs of G where M = 1, slabs fastest; tm 1). Block b takes items b, b + blocks, ...

    ``BULK``: a side with ``*_box`` 0 holds row rho = s ta + a of the item
    (input a = x, output a = y; tm channels of the whole narrow axis b, rb =
    tm tb itemsize bytes) at byte (rho // ``*_run``) ``*_pr`` + (rho %
    ``*_run``) rb of its buffer (run 0: rho rb, all rows one copy), channel
    m at m tb itemsize in it, a run of rows a bulk copy; a side with
    ``*_box`` 1 as tensor map boxes (a line of the long axis, ``tmb``
    channels, the side's a tile); ``*_box`` 2 as boxes of the narrow axis
    padded to ``*_pr`` bytes, ``tmb`` channels, up to BOX_ROWS rows of a. ``pair_y``: 4-byte elements, the blocks
    paired in an 8-lane phase along y (else x). ``in_bytes`` /
    ``out_bytes``: the buffers, ``stages`` of each.

    ``ASYNC``: thread t loads rows t // lx + i (THREADS // lx) of the item
    (row r is row r % tx of slab r // tx), vectors t % lx + j lx of ``vi``
    elements along y, into shared rows of ``pitch`` elements (slab s at
    column s ty; by cp.async where ``pitch`` is a whole number of vectors,
    else through registers), and stores output rows t // sx + i
    (THREADS // sx),
    vectors t % sx + j sx of ``vo`` elements along x.

    ``COPY``: ``blocks`` blocks copy the ``y`` elements in ``vi``-element
    vectors, grid-stride.
    """

    g: int
    x: int
    m: int
    y: int
    arm: int
    tx: int
    ty: int
    tm: int
    k: int
    vi: int
    vo: int
    lx: int
    sx: int
    pitch: int
    in_box: int
    in_run: int
    in_pr: int
    out_box: int
    out_run: int
    out_pr: int
    tmb: int
    pair_y: int
    stages: int
    blocks: int
    smem: int
    work: int
    in_bytes: int
    out_bytes: int

    @property
    def copy(self) -> bool:
        return self.arm == COPY

    @property
    def name(self) -> str:
        """The arm as ``chip_smoke.py`` and ``kernel_times`` print it."""
        if self.arm == COPY:
            return "copy"
        if self.arm == ASYNC:
            return "cp.async" if self.stages == 2 else "tiles"
        sides = [("bulk", "TMA", "TMA rows")[box] for box in (self.in_box, self.out_box)]
        return f"{sides[0]} in, {sides[1]} out"

    def c_plan(self):
        """The 21 ints the C entry reads (csrc/relayout.cu:Plan)."""
        return (ctypes.c_int * 21)(*self[4:25])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _blocks(work: int, smem: int, sms: int, threads: int = THREADS) -> int:
    """Persistent blocks: as many as the SMs hold at this shared memory."""
    per_sm = min(2048 // threads, SMEM_SM // (smem + 1024))
    return min(work, sms * max(1, per_sm))


def odd_channels(m: int, cap: int) -> int:
    """tmb: the largest odd divisor of M up to ``cap`` and 255 (a box's
    channels)."""
    odd = m
    while odd % 2 == 0:
        odd //= 2
    return max(d for d in range(1, max(1, min(odd, cap, 255)) + 1, 2) if odd % d == 0)


def _pitch(row: int, residue: int) -> int:
    """The least pitch >= ``row`` bytes whose 16-byte chunks number ``residue``
    (1: odd, else 2 modulo 4)."""
    c = row // 16
    while not (c % 2 == 1 if residue == 1 else c % 4 == 2):
        c += 1
    return 16 * c


def bulk_runs(rb: int, residue: int, follow: bool) -> tuple:
    """(run, pitch) of a bulk side's buffer: runs of ``run`` rows of ``rb``
    bytes (a power of two), each one bulk copy, ``pitch`` bytes apart; run 0:
    the tensor's own layout, one copy for all the item's rows. Residue 1: 8
    consecutive rows of one 16-byte chunk land on 8 distinct bank groups
    (2-byte elements; 4-byte ones on the paired side); residue 2: 4
    consecutive rows of two adjacent chunks do (the other 4-byte side). A
    row length that does so itself keeps the tensor's layout (run 0 where
    the rows ``follow`` each other in the tensor, else one row a copy);
    else runs of 8, 4, 2 or 1 rows at a padded pitch (one row where they do
    not follow)."""
    rc = rb // 16
    if rc % 2 == 1 if residue == 1 else rc % 4 == 2:
        return (0 if follow else 1), rb
    if not follow:
        return 1, _pitch(rb, residue)
    run = 8 // math.gcd(rc, 8) if residue == 1 else (2 if rc % 8 == 4 else 1)
    return run, _pitch(run * rb, residue)


def bulk_plan(g: int, x: int, m: int, y: int, itemsize: int,
              sms: int = SMS) -> Optional[RelayoutPlan]:
    """The bulk arm's plan of a canonical (G, X, M, Y) transpose of aligned
    tensors whose X and Y are whole 16-byte vectors (else None; also past
    MAX_ITEMS work items, some 64 GB of data). ITEM_BYTES and MAX_STAGES:
    sweeps of item sizes, stages and blocks on an H100 picked them.

    An axis of at most NARROW_BYTES a row is narrow and whole in every item.
    Both narrow: items of whole slabs (all m where a slab of them fits
    ITEM_BYTES, else tm channels), both sides by bulk copies. One
    narrow: its side by bulk copies, the long side by boxes of tmb channels
    (the largest odd divisor of M whose line across them fits
    ITEM_BYTES); tm a multiple of tmb that keeps a long line's bytes
    within ITEM_BYTES but the narrow side's rows (bulk copies) at least
    MIN_ROW bytes, M split evenly; the long tile whole lines up to
    ITEM_BYTES; at most MAX_STAGES stages.
    Both long: 128-byte lines on both, boxes on both. Pitches: odd chunks
    on a bulk side (bulk_runs) for 2-byte elements (ldmatrix / stmatrix read
    and write 8 consecutive rows of one chunk); for 4-byte elements the
    blocks pair along x (box input) or y (box output), the paired side's
    rows odd and the other's 2 modulo 4 chunks, or the pairing with the least
    padding."""
    e = itemsize
    vec, unit = 16 // e, LINE // e
    if x % vec or y % vec:
        return None
    narrow_x, narrow_y = x * e <= NARROW_BYTES, y * e <= NARROW_BYTES
    tmb, k = 1, 1
    if narrow_x and narrow_y:
        in_box = out_box = 0
        tx, ty, slab = x, y, x * y * e
        tm = m if m * slab <= ITEM_BYTES else max(1, ITEM_BYTES // slab)
        tm = _cdiv(m, _cdiv(m, tm))
        if tm == m:
            k = min(g, max(1, ITEM_BYTES // (m * slab)))
    else:
        in_box, out_box = int(not narrow_y), int(not narrow_x)
        n = y if narrow_y else x if narrow_x else unit
        per_m = unit * n * e  # a line of the long axis across the narrow one, one m
        tmb = odd_channels(m, ITEM_BYTES // per_m)
        # blocks of tmb channels: as many as ITEM_BYTES holds, and at least
        # enough that a narrow side's row of them is MIN_ROW bytes (a bulk
        # copy that long), the chunks of M even
        blocks, lo = m // tmb, _cdiv(MIN_ROW, (x if narrow_x else y) * e * tmb)
        hi = max(lo, ITEM_BYTES // (per_m * tmb))
        chunks = max(1, min(_cdiv(blocks, hi), blocks // lo))
        tm = tmb * _cdiv(blocks, chunks)
        if narrow_x == narrow_y:  # both long
            tx = ty = unit
        else:
            lines = max(1, ITEM_BYTES // (per_m * tm))
            long = min(lines, _cdiv(y if narrow_x else x, unit)) * unit
            tx, ty = (x, long) if narrow_x else (long, y)
    in_row, out_row = tm * ty * e, tm * tx * e
    sides = ((in_box, in_row, tx, x), (out_box, out_row, ty, y))

    def layout(side, residue):  # (box, run, pitch, buffer bytes) of one side
        box, row, ta, a_ext = side
        if box:
            region = _round_up(LINE * tmb * ta, RING_ALIGN)
            return LONG_BOX, 1, 0, (tm // tmb) * (row // (tm * LINE)) * region
        run, pitch = bulk_runs(row, residue, tm == m and (k == 1 or ta == a_ext))
        line = row // tm  # the narrow axis of one channel
        pad = _pitch(line, residue)
        if (run != 0 and run * row < MIN_ROW and k == 1 and pad <= BOX_ROWS * e
                and (ta <= BOX_ROWS or ta % BOX_ROWS == 0)):
            # short copies: boxes of the narrow axis padded, tmb channels
            region = _round_up(pad * tmb * min(ta, BOX_ROWS), RING_ALIGN)
            return NARROW_BOX, 1, pad, (tm // tmb) * _cdiv(ta, BOX_ROWS) * region
        return (BULK_SIDE, run, pitch,
                _round_up((_cdiv(k * ta, run) if run else k * ta) * pitch, RING_ALIGN))

    if e == 2:
        pair_y = 0
    elif in_box or out_box:
        pair_y = int(out_box and not in_box)
    else:  # both bulk: the pairing with the smaller buffers
        size = lambda py: layout(sides[0], 2 if py else 1)[3] + layout(sides[1], 1 if py else 2)[3]
        pair_y = int(size(1) < size(0))
    (in_box, in_run, in_pr, in_bytes), (out_box, out_run, out_pr, out_bytes) = (
        layout(sides[0], 2 if e == 4 and pair_y else 1),
        layout(sides[1], 2 if e == 4 and not pair_y else 1))
    stages = min(MAX_STAGES, (SMEM_CAP - RING_ALIGN - BARS) // (in_bytes + out_bytes))
    if stages < 2:
        return None
    smem = RING_ALIGN + stages * (in_bytes + out_bytes) + BARS
    work = _cdiv(g, k) * _cdiv(m, tm) * _cdiv(x, tx) * _cdiv(y, ty)
    if work >= MAX_ITEMS:
        return None
    return RelayoutPlan(g, x, m, y, BULK, tx, ty, tm, k, vec, vec, 0, 0, 0, in_box, in_run,
                        in_pr, out_box, out_run, out_pr, tmb, pair_y, stages,
                        _blocks(work, smem, sms, BULK_THREADS), smem, work, in_bytes, out_bytes)


def async_tile(g: int, x: int, m: int, y: int, vi: int, vo: int) -> tuple:
    """(tx, ty, k) of the cp.async arm: ~TILE elements, the narrow axis whole
    up to EDGE and the other one long, EDGE x EDGE when both are long; k
    whole slabs of G an item where M = 1 and a slab is under half a tile
    (their rows follow each other on both sides). A cut side is a whole
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
    k = min(g, TILE // (x * y)) if m == 1 and 2 * x * y <= TILE else 1
    return tx, ty, k


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
    the block's threads busy) of one side's first warp of the cp.async arm:
    ``along`` lanes a row take ``vec``-element vectors of rows ``row_stride``
    elements apart in global memory. The load side (``tile`` = (tx, ty))
    copies input row r, row r % tx of slab r // tx, to (r % tx) * pitch +
    (r // tx) * ty in shared memory as one vector where the pitch keeps it
    aligned (a cp.async copy), else element by element; the store side
    (``tile`` None) reads the tile's
    columns element by element. A vector access of B bytes is served in
    phases of 128 / B lanes."""
    lanes = [(lane // along, lane % along) for lane in range(WARP)]
    lanes = [(r, v) for r, v in lanes if r < rows and v < vectors]
    if not lanes:
        return float("inf"), float("inf"), 0.0
    sectors = {((r * row_stride + v * vec + k) * itemsize) // SECTOR
               for r, v in lanes for k in range(vec)}
    word = lambda e: e * itemsize // 4
    start = lambda r: r % tile[0] * pitch + r // tile[0] * tile[1]
    if tile is not None and pitch % vec == 0:
        words = [range(word(start(r) + v * vec), word(start(r) + (v + 1) * vec - 1) + 1)
                 for r, v in lanes]
        phase = max(1, 128 // max(4, vec * itemsize))
        waves = sum(_wavefronts([w for ws in words[i:i + phase] for w in ws])
                    for i in range(0, len(words), phase))
    elif tile is not None:
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


def async_plan(g: int, x: int, m: int, y: int, itemsize: int, in_offset: int = 0,
               out_offset: int = 0, sms: int = SMS) -> RelayoutPlan:
    """The cp.async arm's plan of a canonical (G, X, M, Y) transpose.

    Each side's lanes and the pitch are scored on the first warp
    (side_cost): the fewest sectors (DRAM traffic) first; then, on the load
    side, the most threads busy (the loads in flight hide the memory's
    latency; a store does not wait); then the fewest shared-memory
    wavefronts; then the widest rows of lanes and the narrowest pitch.

    Two stages, a ring the input vectors enter by cp.async, where the pitch
    is a whole number of them and at least half the blocks take a second
    item (work >= RING_ITEMS x blocks: with fewer there is little next item
    for the ring to load early, and on an H100 the ring then lost to loads
    through registers, e.g. at the bf16 HWCB exit at batch 8); else one
    stage loaded through registers (element by element into the tile where
    the pitch breaks the vectors' alignment)."""
    vi = widest_vector(y, in_offset, itemsize)
    vo = widest_vector(x, out_offset, itemsize)
    tx, ty, k = async_tile(g, x, m, y, vi, vo)
    best = None
    for pitch in range(k * ty, k * ty + MAX_PAD):
        if tx * pitch * itemsize > ASYNC_SMEM:
            break
        load = min(((sec, -busy, waves, -lx), lx) for lx in _along_choices(ty // vi)
                   for sec, waves, busy in [side_cost(lx, k * tx, vi, ty // vi, m * y,
                                                      itemsize, pitch, (tx, ty))])
        store = min(((sec, waves, -sx), sx) for sx in _along_choices(tx // vo)
                    for sec, waves, _ in [side_cost(sx, k * ty, vo, tx // vo, m * x,
                                                    itemsize, pitch)])
        (l_sec, l_busy, l_waves, l_wide), (s_sec, s_waves, s_wide) = load[0], store[0]
        score = (l_sec + s_sec, l_busy, l_waves + s_waves, l_wide + s_wide, pitch)
        if best is None or score < best[0]:
            best = (score, pitch, load[1], store[1])
    _, pitch, lx, sx = best
    work = _cdiv(g * m, k) * _cdiv(x, tx) * _cdiv(y, ty)
    ring = pitch % vi == 0 and work >= RING_ITEMS * _blocks(work, 2 * tx * pitch * itemsize, sms)
    stages = 2 if ring else 1
    smem = stages * tx * pitch * itemsize
    return RelayoutPlan(g, x, m, y, ASYNC, tx, ty, 1, k, vi, vo, lx, sx, pitch, 0, 0, 0, 0, 0,
                        0, 1, 0, stages, _blocks(work, smem, sms), smem, work, 0, 0)


@functools.lru_cache(maxsize=1024)
def relayout_plan(g: int, x: int, m: int, y: int, itemsize: int, in_offset: int = 0,
                  out_offset: int = 0, sms: int = SMS) -> RelayoutPlan:
    """The plan of a (G, X, M, Y) relayout of ``itemsize``-byte elements
    whose input and output start ``in_offset`` and ``out_offset`` bytes
    past 16-byte boundaries, on a card of ``sms`` SMs. Cached. A copy
    where a swapped axis is 1; the bulk arm where M > 1, M rows of the
    narrow axis hold MIN_ROW bytes (the bulk copies its plan aims at) and
    its copies can run (both starts aligned, X and Y whole 16-byte
    vectors); the cp.async arm elsewhere. Where M = 1 a tile's rows are
    whole runs on both sides, so the bulk arm's items have no split sector
    to mend. On an H100 (``cli/kernel_times.py --arms``) the cp.async arm
    was the faster at every M = 1 shape timed (the HWCB ends at batch 8
    and 32, P14 and P7 at level 1, the levels at batch 1) and at TNSM's
    noise map (M = 3) in fp32; the bulk arm at every level's shape with M
    = 36 or 72 at batch 8."""
    if min(g, x, m, y) < 1:
        raise ValueError(f"relayout: extents must be >= 1, got {(g, x, m, y)}")
    if itemsize not in (2, 4):
        raise TypeError(f"relayout: {itemsize}-byte elements not supported (2 or 4)")
    g, x, m, y = canonical(g, x, m, y)
    if x == 1:
        v = widest_vector(y, in_offset | out_offset, itemsize)
        work = _cdiv(y, THREADS * v)
        return RelayoutPlan(1, 1, 1, y, COPY, 1, y, 1, 1, v, v, THREADS, THREADS, 0, 0, 0, 0,
                            0, 0, 0, 1, 0, 1, min(work, sms * BLOCKS_PER_SM), 0, work, 0, 0)
    if m > 1 and m * min(x, y) * itemsize >= MIN_ROW and in_offset == 0 and out_offset == 0:
        plan = bulk_plan(g, x, m, y, itemsize, sms)
        if plan is not None:
            return plan
    return async_plan(g, x, m, y, itemsize, in_offset, out_offset, sms)


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
    dev = t.device
    counter(dev, t.data_ptr(), out.data_ptr(), t.element_size(),
            *_launch_args(gxmy, t.element_size(), t.data_ptr() % 16, out.data_ptr() % 16, dev))
    return out


@functools.lru_cache(maxsize=1024)
def _launch_args(gxmy: tuple, itemsize: int, in_offset: int, out_offset: int,
                 device: torch.device) -> tuple:
    """The C entry's (g, x, m, y, plan) of a launch: one cached lookup a
    call, as the wrapper's host work sets the pace at batch 1."""
    p = relayout_plan(*gxmy, itemsize, in_offset, out_offset, sm_count(device))
    return p.g, p.x, p.m, p.y, p.c_plan()


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
