"""P10/P15: the batched score product, its plain version and the dispatcher
``batched_qk``; the launch plan of the score core it shares with P1.

Counterpart of ``experiments/relayout_probe_r5h.py:dot_bcn`` (P10) and
``experiments/mosaic_micro_r5h.py:bdot`` (P15): ``s[g] = q[g] k[g]^T`` over
the last axis, (G, c, N) x (G, c, N) -> (G, c, c) in fp32, for fp32 or
bf16 q and k. P10 as written never zeroes its output before accumulating
into it (its interpret-mode result is NaN); P15, and this port, compute
what it was meant to. The kernel is ``csrc/batched_qk.cu`` on the score
core of ``csrc/qk_scores.cuh``: a cluster of ``splits`` blocks per g, each
summing ``chunk`` columns, met in a fixed order (two calls give the same
bits). fp32 runs on the CUDA cores in loads of ``vec`` elements
(``qk_plan``); bf16 on the tensor cores, its columns streamed through a
ring of bulk copies, or ``cp.async`` where rows are not 16-byte aligned
(``mma_plan``; ``mma_replay`` repeats its addressing on the CPU). The
plain version is one fp32 ``bmm`` with TF32 off.

The probe route runs it at TNSM's noise-aware attention
(``models/tnsm.py``), where q and k are not normalised.

Dispatch is by device only: a CPU tensor takes the plain version, a CUDA
tensor the kernel. Backward runs the plain version's autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from hvi_cidnet_torch.ops._build import DTYPE_CODES, CudaKernel, check_input, twin_backward
from hvi_cidnet_torch.ops.conv import exact_fp32
from hvi_cidnet_torch.utils import flops

# csrc/qk_scores.cuh
THREADS = 256
TILE = 256              # columns a step
RT = 3                  # a thread's register tile: 3 x 3 entries
MAX_C = 32
MAX_CLUSTER = 8         # the fp32 arm's: the portable cluster size (csrc/qk_scores.cuh kMaxCluster)
SMS = 132               # streaming multiprocessors of an H100 SXM
TARGET_BLOCKS = 2 * SMS
SMEM_LIMIT = 232_448    # shared memory one block may use (227 KB)
MAX_GRID_Y = 65535
# bf16 arm (csrc/qk_scores.cuh: kWarps, kMmaTile, kMmaPitch, kMaxStages,
# kMaxApplyStages)
WARPS = THREADS // 32
MMA_TILE = 512          # columns a ring stage
MMA_PITCH = MMA_TILE + 8  # a staged row, in elements
MAX_STAGES = 6
MAX_APPLY_STAGES = 8
BARRIER_BYTES = 8 * (MAX_STAGES + MAX_APPLY_STAGES)  # the rings' mbarriers
SM_SMEM = 233_472       # shared memory of one SM (228 KB)
SMEM_PER_BLOCK = 1024   # reserved by the hardware for each block
MMA_MAX_CLUSTER = 16    # the bf16 arm's: past 8 non-portable (kMmaMaxCluster)
# Clusters of 1..16 blocks of either bf16 kernel at c = 18 that an H100 SXM
# (NVIDIA H100 80GB HBM3) held at once at two blocks an SM, as its
# cudaOccupancyMaxActiveClusters gave them (``chip_smoke.py`` step 4c logs
# the card's). The CPU tests and replays plan with these; on the card the
# wrappers plan with the card's own (``card_clusters``).
H100_CLUSTERS = (264, 132, 79, 62, 47, 39, 32, 30, 23, 21, 16, 16, 14, 14, 14, 14)


def side_tiles(c: int) -> int:
    return -(-c // RT)


def slices(c: int) -> int:
    """Column slices a block runs side by side: one thread a 3 x 3 tile of
    the c x c entries in each."""
    return THREADS // side_tiles(c) ** 2


def entries(c: int, norms: bool) -> int:
    """Sums a g: the c x c scores, then |q_r|^2 and |k_c|^2 (P1)."""
    return c * c + (2 * c if norms else 0)


def pitch(itemsize: int) -> int:
    """Row pitch of the staged q and k tiles, in elements: TILE and 16
    bytes."""
    return TILE + 16 // itemsize


def core_bytes(c: int, norms: bool, itemsize: int) -> int:
    """Shared memory of the score core: the q and k tiles in the input's
    type (rows rounded up to 3), then the slices' partials and the block's
    sums in fp32."""
    return 2 * side_tiles(c) * RT * pitch(itemsize) * itemsize \
        + 4 * (slices(c) + 1) * entries(c, norms)


def c_max(c: int) -> int:
    """c rounded up to the kernels' instantiations (8, 20 or 32): the rows
    their registers hold."""
    return 8 if c <= 8 else 20 if c <= 20 else 32


def load_vec(n: int, itemsize: int, offset: int) -> int:
    """Elements a load: 16 bytes' worth, else 2, else 1, the widest that
    divides N and every base's ``offset`` (their bitwise or) from a 16-byte
    boundary."""
    return next(v for v in (16 // itemsize, 2, 1) if n % v == 0 and offset % (v * itemsize) == 0)


def split_n(g: int, n: int) -> tuple:
    """(splits, chunk): as many blocks per g as bring the grid to
    TARGET_BLOCKS, at most one cluster (MAX_CLUSTER) and one TILE each;
    chunks of whole tiles, none empty."""
    tiles = -(-n // TILE)
    want = max(1, min(MAX_CLUSTER, -(-TARGET_BLOCKS // g), tiles))
    chunk = -(-tiles // want) * TILE
    return -(-n // chunk), chunk


class QkPlan(NamedTuple):
    """How P10/P15's fp32 arm covers a (g, c, n) call: grid (splits, g) in
    clusters of ``splits``; block (s, i) sums columns [s * chunk, (s + 1) *
    chunk) of row i, ``vec`` elements a load, and writes entries [s * per,
    (s + 1) * per) of its c x c."""

    splits: int
    chunk: int
    blocks: int
    side_tiles: int
    slices: int
    vec: int
    smem_bytes: int


def check_shape(g: int, c: int, n: int, name: str) -> None:
    if not (1 <= c <= MAX_C and n >= 1 and g >= 1):
        raise ValueError(f"{name}: takes 1 <= c <= {MAX_C} rows, got c={c}, N={n}, G={g}")
    if g > MAX_GRID_Y:
        raise ValueError(f"{name}: G={g} past the grid's limit {MAX_GRID_Y}")


def n_tiles(c: int) -> int:
    """k's 8-row tiles in the bf16 arm (q's 16-row tiles: half as many,
    rounded up)."""
    return -(-c // 8)


def apply_stages(stages: int) -> int:
    """P1's apply ring: v alone is half a stage's bytes, so twice the
    stages, at most MAX_APPLY_STAGES."""
    return min(2 * stages, MAX_APPLY_STAGES)


def reduce_floats(c: int, norms: bool) -> int:
    """fp32 values of the bf16 arm's reduction: the warps' partials, the
    block's sums, the cluster's, and (P1) the c x c softmax."""
    e = entries(c, norms)
    return WARPS * e + 2 * e + (c * c if norms else 0)


def aux_bytes(c: int, norms: bool) -> int:
    """The area after the ring: the realigned q and k tiles (c x MMA_PITCH
    bf16 each) or the reduction, whichever is larger; P1's apply reuses it
    for the realigned v and the output tile."""
    return -(-max(4 * c * MMA_PITCH, 4 * reduce_floats(c, norms)) // 16) * 16


def mma_bytes(c: int, norms: bool, stages: int) -> int:
    """Shared memory of a bf16 block: the ring (q and k, c rows each, a
    stage), the aux area, a zeroed 16-byte line, the rows' int64 offsets,
    the rings' mbarriers."""
    return stages * 4 * c * MMA_PITCH + aux_bytes(c, norms) + 16 + 8 * c + BARRIER_BYTES


def ring_stages(c: int, norms: bool) -> tuple:
    """(stages, blocks an SM): the deepest ring with which two blocks share
    an SM, else the deepest one block takes. (On the card a deeper ring
    bought nothing: a block's stream runs at its own rate, and two blocks
    an SM double it.)"""
    for per_sm in (2, 1):
        budget = min(SMEM_LIMIT, SM_SMEM // per_sm - SMEM_PER_BLOCK)
        fit = [s for s in range(2, MAX_STAGES + 1) if mma_bytes(c, norms, s) <= budget]
        if fit:
            return fit[-1], per_sm
    raise ValueError(f"no ring fits at c={c}")


def mma_split(g: int, n: int, clusters: tuple) -> tuple:
    """(splits, chunk) of the bf16 arm: as many blocks a g (a cluster of at
    most MMA_MAX_CLUSTER) as keep all G clusters within one wave of the
    card's (``clusters[s - 1]``: clusters of s blocks it holds at once; a
    cluster left over would double the time, and a block streams at its own
    rate, so more blocks a g are faster), at most one a stage of MMA_TILE
    columns; chunks of whole stages, none empty."""
    stages = -(-n // MMA_TILE)
    fits = [s for s in range(1, MMA_MAX_CLUSTER + 1) if g <= clusters[s - 1]]
    want = max(1, min(stages, fits[-1] if fits else 1))
    chunk = -(-stages // want) * MMA_TILE
    return -(-n // chunk), chunk


class MmaPlan(NamedTuple):
    """How the bf16 arm of P10/P15 and P1 covers a (g, c, n) call: grid
    (splits, g) in clusters of ``splits``; block (s, i) streams columns
    [s * chunk, (s + 1) * chunk) of row i through a ring of ``stages``
    stages of MMA_TILE columns (P1's apply: ``apply_stages``): one bulk
    copy a row where ``vec`` is 8 (n and every base put each row on a
    16-byte boundary), else (``vec`` 1) cp.async copies of each row's
    aligned cover and a realignment pass. Warp w takes the k16 steps 16 w,
    16 (w + WARPS), ... of a stage: q's 16-row tiles against k's
    ``n_tiles`` 8-row tiles."""

    splits: int
    chunk: int
    blocks: int
    n_tiles: int
    vec: int
    stages: int
    apply_stages: int
    blocks_per_sm: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def mma_plan(g: int, c: int, n: int, clusters: tuple, offset: int = 0, norms: bool = False,
             name: str = "P10/P15") -> MmaPlan:
    """The bf16 arm's plan for (g, c, n) operands whose starts lie
    ``offset`` bytes (or-ed) past 16-byte boundaries; ``clusters``: the
    active clusters by size of the card it runs on (``card_clusters``);
    ``norms``: P1's (the norms, the softmax, the apply)."""
    check_shape(g, c, n, name)
    splits, chunk = mma_split(g, n, clusters)
    stages, per_sm = ring_stages(c, norms)
    vec = 8 if n % 8 == 0 and offset % 16 == 0 else 1
    return MmaPlan(splits, chunk, splits * g, n_tiles(c), vec, stages,
                   apply_stages(stages) if norms else 0, per_sm, mma_bytes(c, norms, stages))


@functools.lru_cache(maxsize=256)
def qk_plan(g: int, c: int, n: int, offset: int = 0) -> QkPlan:
    """P10/P15's fp32 launch plan for (g, c, n) q and k whose starts lie
    ``offset`` bytes (or-ed) past 16-byte boundaries."""
    check_shape(g, c, n, "P10/P15")
    splits, chunk = split_n(g, n)
    return QkPlan(splits, chunk, splits * g, side_tiles(c), slices(c), load_vec(n, 4, offset),
                  core_bytes(c, False, 4))


@functools.lru_cache(maxsize=64)
def card_clusters(device: torch.device, norms: bool, c: int) -> tuple:
    """The clusters of 1..MMA_MAX_CLUSTER blocks of P1's (``norms``) or
    P10/P15's bf16 kernel, at c rows and its plan's shared memory, that
    ``device`` holds at once (``cudaOccupancyMaxActiveClusters``)."""
    from hvi_cidnet_torch.ops._build import library

    fn = getattr(library(), "head_attention_active_clusters" if norms
                 else "batched_qk_active_clusters")
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_int64], ctypes.c_int
    smem = mma_bytes(c, norms, ring_stages(c, norms)[0])
    with torch.cuda.device(device):
        counts = tuple(fn(c, s, smem) for s in range(1, MMA_MAX_CLUSTER + 1))
    if min(counts) < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: cudaError {-min(counts)}")
    return counts


_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
BATCHED_QK = CudaKernel("batched_qk", [_p, _p, _p, _i, _i64, _i, _i64, _i, _i64, _i, _i,
                                       _i64])


def batched_qk_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version: ``q k^T`` of the fp32-widened operands, one fp32
    ``bmm`` (TF32 off)."""
    with exact_fp32():
        return torch.bmm(q.float(), k.float().transpose(1, 2))


def check_qk(q: torch.Tensor, k: torch.Tensor, name: str) -> None:
    """q and k: contiguous (G, c, N) CUDA tensors of one shape and dtype."""
    check_input(q, "q", 3)
    check_input(k, "k", 3)
    if k.shape != q.shape or k.dtype != q.dtype or k.device != q.device:
        raise ValueError(f"{name}: q and k of one shape, dtype and device, got "
                         f"{tuple(q.shape)} {q.dtype}, {tuple(k.shape)} {k.dtype}")


def batched_qk_kernel(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Launch P10/P15 on contiguous (G, c, N) q and k on the card."""
    check_qk(q, k, "P10/P15")
    g, c, n = q.shape
    offset = (q.data_ptr() | k.data_ptr()) % 16
    if q.dtype == torch.bfloat16:
        plan = mma_plan(g, c, n, card_clusters(q.device, False, c), offset)
        stages = plan.stages
    else:
        plan, stages = qk_plan(g, c, n, offset), 0
    out = torch.empty((g, c, c), dtype=torch.float32, device=q.device)
    BATCHED_QK(q.device, q.data_ptr(), k.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype], g, c,
               n, plan.splits, plan.chunk, plan.vec, stages, plan.smem_bytes)
    return out


class _BatchedQk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        return batched_qk_kernel(q, k)

    @staticmethod
    def backward(ctx, grad):
        return twin_backward(batched_qk_plain, ctx.saved_tensors, grad, ctx.needs_input_grad)


def batched_qk(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(G, c, c) fp32 scores ``q k^T`` of (G, c, N) q and k. CPU: plain;
    CUDA: P10/P15."""
    with flops.kernel("P10/P15", q, c=q.shape[1]):
        if q.device.type == "cpu":
            return batched_qk_plain(q, k)
        return _BatchedQk.apply(q, k)


# ---------------------------------------------------------------------------
# The bf16 arm replayed on the CPU (csrc/qk_scores.cuh:mma_block_scores,
# csrc/row_stream.cuh:RowStream), in float64: the tests hold it to the
# plain versions
# ---------------------------------------------------------------------------

LANES = torch.arange(32)


def flat_view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """t's elements as the card addresses them, in float64: ``offset``
    elements past a 16-byte boundary (the boundaries fall on multiples of 8
    here), then one zeroed 16-byte line."""
    return torch.cat([t.new_zeros(offset), t.reshape(-1), t.new_zeros(8)]).double()


def stage_rows(flat: torch.Tensor, offset: int, total: int, rowbase: list, n0: int, stop: int,
               direct: bool, zero_to_16: bool = True) -> torch.Tensor:
    """A staged (rows, MMA_PITCH) tile of columns [n0, stop). Realigned:
    as RowStream leaves it, each row's 16-byte-aligned cover from its shift
    (rowbase + the base's offset, mod 8), chunk by chunk, elements outside
    the tensor as zeros, then moved to shift 0 with the columns at and past
    ``stop`` zeroed. ``direct`` (the shift is 0): one bulk copy a row, the
    columns past ``stop`` stale (NaN here: a product that read one would
    show), but for the 8 zeroed past a stop that ends inside a k16 step
    (``zero_to_16``, the scores')."""
    rb = torch.tensor(rowbase, dtype=torch.int64)[:, None]
    shift = (rb + offset) % 8
    first = rb + n0 - shift
    chunks = ((rb + stop - first + 7) // 8).clamp(max=MMA_TILE // 8 + 1)
    pos = torch.arange(MMA_PITCH)[None, :]
    idx = first + pos
    copied = (pos < 8 * chunks) & (idx >= 0) & (idx < total)
    raw = torch.where(copied, flat[(offset + idx).clamp(0, flat.numel() - 1)], 0.0)
    if direct:
        if shift.any():
            raise AssertionError("a direct stage with a row off the 16-byte grid")
        width = stop - n0
        raw[:, width:] = float("nan")
        if zero_to_16 and width % 16:
            raw[:, width:width + 8] = 0.0
        return raw
    # the realignment: column j of row r from raw[r, shift + j], zero at and past stop
    cols = (shift + pos).clamp(max=MMA_PITCH - 1)
    return torch.where(pos < stop - n0, raw.gather(1, cols), 0.0)


def frag_offsets(c: int, mi: int) -> torch.Tensor:
    """``qk_scores.cuh:frag_offset``: the element offset, from a staged
    tile's start, of the row each lane gives ldmatrix for 16-row tile mi
    (row 16 mi + lane % 16, columns + 8 (lane / 16)); -1 past c (the zero
    line)."""
    r = 16 * mi + (LANES & 15)
    return torch.where(r < c, r * MMA_PITCH + (LANES >> 4) * 8, -1)


def ldmatrix(tile: torch.Tensor, offs: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """ldmatrix .x4 (or .x4.trans: the same rows) from a staged tile at each
    of ``cols``: lane l reads the 8 values at offs[l] + col, or the zero line
    where offs[l] < 0; matrix j's row i is lane 8 j + i's. (len(cols), 4, 8,
    8)."""
    flat = torch.cat([tile.reshape(-1), tile.new_zeros(8)])
    addr = torch.where(offs >= 0, offs[None, :] + cols[:, None], flat.numel() - 8)
    return flat[addr[..., None] + torch.arange(8)].view(-1, 4, 8, 8)


def a_operand(m: torch.Tensor) -> torch.Tensor:
    """mma.sync's m16 x k16 A of registers (m0, m1, m2, m3): rows 0-7 are
    m0 | m2, rows 8-15 m1 | m3."""
    return torch.cat([torch.cat([m[..., 0, :, :], m[..., 2, :, :]], -1),
                      torch.cat([m[..., 1, :, :], m[..., 3, :, :]], -1)], -2)


def b_operand(m0: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """mma.sync's k16 x n8 B of registers (b0, b1) from ldmatrix without
    .trans: B[k][n] = m0[n][k], then m1[n][k - 8]."""
    return torch.cat([m0, m1], -1).transpose(-1, -2)


def fragment_entries(c: int, mi: int, nt: int) -> tuple:
    """Where each lane's 4 accumulators of tile (mi, nt) land: row 16 mi +
    lane / 4 + 8 (e / 2), column 8 nt + 2 (lane % 4) + e % 2; (lane, e)
    pairs inside c x c and their (rows, columns)."""
    e = torch.arange(4)
    i = 16 * mi + (LANES >> 2)[:, None] + 8 * (e >> 1)[None, :]
    j = 8 * nt + 2 * (LANES & 3)[:, None] + (e & 1)[None, :]
    keep = (i < c) & (j < c)
    return i[keep], j[keep]


def replay_sums(q: torch.Tensor, k: torch.Tensor, plan: MmaPlan, offset: int = 0,
                norms: bool = False) -> tuple:
    """The bf16 score core replayed: each g's cluster sums (G, entries), in
    the kernel's layout (q_i . k_j at i c + j, then |q_i|^2, |k_j|^2 with
    ``norms``), and the times each (g, column) fed a product, under
    ``plan``. q and k: (G, c, N) bf16 at ``offset`` elements past a 16-byte
    boundary. Block by
    block: the ring's stages filled and read in the kernel's order, every
    lane's ldmatrix rows, k's n8 operands as halves of its m16 loads, the
    norms as the diagonals of X X^T, fresh sums a stage added into each
    warp's running sums, the fragments' entries, the warps in warp order and
    the blocks in rank order. Products in float64 (the card's are exact in
    fp32 and summed in fp32)."""
    g_count, c, n = q.shape
    direct = plan.vec == 8
    total = q.numel()
    fq, fk = flat_view(q, offset), flat_view(k, offset)
    mt = -(-plan.n_tiles // 2)
    offs = [frag_offsets(c, mi) for mi in range(mt)]
    e_count = entries(c, norms)
    sums = torch.zeros((g_count, e_count), dtype=torch.float64)
    seen = torch.zeros((g_count, n), dtype=torch.int64)
    diag = torch.arange(8)
    for g in range(g_count):
        rowbase = [(g * c + r) * n for r in range(c)]
        for rank in range(plan.splits):
            col0, col_end = rank * plan.chunk, min(n, (rank + 1) * plan.chunk)
            steps = -(-(col_end - col0) // MMA_TILE)
            ring = [None] * plan.stages

            def issue(step):
                if step < steps:
                    n0 = col0 + step * MMA_TILE
                    stop = min(col_end, n0 + MMA_TILE)
                    ring[step % plan.stages] = tuple(
                        stage_rows(f, offset, total, rowbase, n0, stop, direct) for f in (fq, fk))

            for s in range(plan.stages - 1):
                issue(s)
            run = torch.zeros((WARPS, 32, 32), dtype=torch.float64)   # running sums a warp
            run_n = torch.zeros((WARPS, 2, 32), dtype=torch.float64)
            for s in range(steps):
                issue(s + plan.stages - 1)
                tq, tk = ring[s % plan.stages]
                n0 = col0 + s * MMA_TILE
                width = min(MMA_TILE, col_end - n0)
                kk = torch.arange(0, width, 16)   # warp kk / 16 % WARPS takes step kk
                warp = (kk // 16) % WARPS
                for k0 in kk.tolist():
                    seen[g, n0 + k0:n0 + min(width, k0 + 16)] += 1
                am = [ldmatrix(tq, offs[mi], kk) for mi in range(mt)]
                bm = [ldmatrix(tk, offs[mi], kk) for mi in range(mt)]
                acc = torch.zeros((kk.numel(), 32, 32), dtype=torch.float64)
                nacc = torch.zeros((kk.numel(), 2, 32), dtype=torch.float64)
                for mi in range(mt):
                    a = a_operand(am[mi])
                    for nt in range(plan.n_tiles):
                        half = bm[nt >> 1]
                        b = b_operand(half[:, nt & 1], half[:, 2 + (nt & 1)])
                        acc[:, 16 * mi:16 * mi + 16, 8 * nt:8 * nt + 8] += a @ b
                    for h in range(2):
                        if not norms or 2 * mi + h >= plan.n_tiles:
                            continue
                        for z, mats in enumerate((am, bm)):
                            x = a_operand(mats[mi])
                            d = x @ b_operand(mats[mi][:, h], mats[mi][:, 2 + h])
                            r0 = 16 * mi + 8 * h
                            nacc[:, z, r0:r0 + 8] += d[:, 8 * h + diag, diag]
                # this stage's fresh sums a warp, then into its running sums
                run += torch.zeros_like(run).index_add_(0, warp, acc)
                run_n += torch.zeros_like(run_n).index_add_(0, warp, nacc)
            part = torch.zeros((WARPS, e_count), dtype=torch.float64)
            for mi in range(mt):
                for nt in range(plan.n_tiles):
                    i, j = fragment_entries(c, mi, nt)
                    part[:, i * c + j] = run[:, i, j]
            if norms:
                for z in range(2):
                    part[:, c * c + z * c:c * c + (z + 1) * c] = run_n[:, z, :c]
            red = part[0].clone()
            for w in range(1, WARPS):
                red += part[w]
            sums[g] += red
    return sums, seen


def mma_replay(q: torch.Tensor, k: torch.Tensor, clusters: tuple, offset: int = 0) -> tuple:
    """P10/P15's bf16 arm replayed on the CPU (``replay_sums``) under the
    plan a card with ``clusters`` runs, each block of a cluster writing its
    share of the c x c entries: the (G, c, c) scores, the times each (g,
    column) fed a product and each entry was written."""
    g_count, c, n = q.shape
    plan = mma_plan(g_count, c, n, clusters, 2 * offset % 16)
    sums, seen = replay_sums(q, k, plan, offset)
    out = torch.zeros((g_count, c * c), dtype=torch.float64)
    writes = torch.zeros((g_count, c * c), dtype=torch.int64)
    per = -(-c * c // plan.splits)
    for rank in range(plan.splits):
        lo, hi = rank * per, min(c * c, (rank + 1) * per)
        out[:, lo:hi] = sums[:, lo:hi]
        writes[:, lo:hi] += 1
    return out.view(g_count, c, c), seen, writes
