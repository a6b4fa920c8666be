"""K5: the channel-attention kernel, its plain twin and the dispatcher
``channel_attention``.

Counterpart of ``hvi_cidnet_tpu/ops/attention.py``'s ``_attn_kernel`` /
``attention_bcn_pallas``. The kernel is ``csrc/attention.cu``: it takes
contiguous NCHW q, k, v of one dtype (fp32 or bf16) with C <= 192, the
(heads, 1, 1) fp32 temperature and, optionally, the (C, C, 1, 1)
``project_out`` weight to fold. The twin is ``ops/attention.py:
channel_attention`` (the JAX ``channel_attention_xla``).

The kernel's contraction over space is split over ``splits`` blocks per
image, and its apply over ``apply_splits``; the launch plan (tiles,
stages, splits, threads, shared memory, the scratch layout) is
``attention_plan``, which the CPU tests walk. bf16 runs both products on
the tensor cores (``mma.sync``), fp32 on CUDA cores. The wrapper allocates the scratch (fp32 partial
sums, the C x C matrix) as one ``torch.empty`` and drops it on return,
while the kernel may still run: the caching allocator hands that memory out
again only in stream order, after the kernel. The plan depends only on the
shape, so two calls give the same bits.

Dispatch is by device only: a CPU tensor takes the plain twin, a CUDA
tensor the kernel. Backward runs the twin's autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from hvi_cidnet_torch.ops import attention
from hvi_cidnet_torch.ops._build import DTYPE_CODES, CudaKernel, check_input, twin_backward

MAX_CHANNELS = 192      # the apply's A (C16 x C16) and v tiles fit shared memory
SMS = 132               # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448    # shared memory one block may use (227 KB)
SMEM_SM = 233_472       # shared memory of one SM (228 KB)
SMEM_PER_BLOCK = 1024   # reserved by the hardware for each block
SMEM_TARGET = 113 * 1024  # a scores block at most this, so that two share an SM
MAX_THREADS = 512
MAX_GRID_X = 2**31 - 1
MAX_GRID_YZ = 65535
# bf16 arm (csrc/attention.cu: kApplyStages, kRowsThreads, kRowsCluster,
# kItemTiles, kApplyNT, kNormSlots). The scores ring by `direct` (copies in
# flight: stages - 1): on the card wide two-stage steps ran fastest where
# rows start aligned, four stages where they are realigned.
SCORE_STAGES = {True: 2, False: 4}
APPLY_STAGES = 3
ROWS_THREADS = 256
ROWS_CLUSTER = 8        # rows-pass blocks per (head, image), one cluster
ITEM_TILES = 4          # 8-row k tiles per scores work item
APPLY_NT = 4            # 8-column output tiles per warp of the apply
NORM_SLOTS = 3          # norm items per warp of the scores pass
# scores threads by `direct`: the realignment pass wants more warps
SCORE_THREADS = {True: 256, False: 512}
REGS = 128              # registers a thread may take (__launch_bounds__(512))
TILES = (256, 128, 64, 32)  # columns per pipeline step, widest first
# fp32 arm
F32_SCORE_TILE = 32
F32_THREADS = 256
F32_ENTRIES_PER_BLOCK = 4096
F32_APPLY_TILE = 64
F32_TARGET_BLOCKS = 4 * SMS


class AttentionPlan(NamedTuple):
    """How K5 covers a (b, c, n) call (``csrc/attention.cu``).

    Scores: grid (splits, b, score_groups); block (s, i, z) contracts
    columns [s * chunk, (s + 1) * chunk) of image i, ``score_tile`` at a
    time, for work items [z * w * ipw, (z + 1) * w * ipw) (w warps, ipw
    items a warp: warp j takes items j, j + w, ...). bf16 only; the fp32
    arm's groups are ranges of 4096 block-diagonal entries. Rows: grid
    (heads * ROWS_CLUSTER, b) in clusters of ROWS_CLUSTER. Apply: grid
    (apply_splits, b); block (s, i) writes columns
    [s * apply_chunk, (s + 1) * apply_chunk) of image i, ``apply_tile`` at a
    time (bf16: warp (m, j) writes row tiles [m * mt, (m + 1) * mt) and
    columns [32 j, 32 j + 32) of each step).
    """

    splits: int
    chunk: int
    score_tile: int
    score_threads: int
    score_groups: int
    items_per_warp: int
    score_smem: int
    apply_splits: int
    apply_chunk: int
    apply_tile: int
    apply_threads: int
    apply_mt: int
    apply_smem: int
    rows_smem: int
    part_stride: int      # fp32 values per (image, split) of the partials
    a_offset: int         # bytes from the scratch's start to A
    scratch_bytes: int
    direct: int           # bf16: every row starts 16-byte aligned; no realignment pass
    score_stages: int     # bf16: the scores pass's ring (copies in flight: stages - 1)


class _PlanStruct(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int64) for name in AttentionPlan._fields]


def round16(c: int) -> int:
    return -(-c // 16) * 16


def score_items(c: int, cp: int) -> list:
    """The bf16 scores pass's work items (csrc/attention.cu:score_item):
    (16-row q tile, first and past-last 8-row k tile). Tile m needs the k
    rows of every head its rows touch, cut into runs of ITEM_TILES."""
    items = []
    for m in range(-(-c // 16)):
        r1 = min(16 * m + 15, c - 1)
        lo, hi = (16 * m // cp) * cp // 8, -(-((r1 // cp + 1) * cp) // 8)
        items += [(m, n0, min(hi, n0 + ITEM_TILES)) for n0 in range(lo, hi, ITEM_TILES)]
    return items


def scores_smem(c: int, tile: int, direct: bool) -> int:
    """bf16 scores block: SCORE_STAGES stages of q and k (C16 rows, pitch
    tile + 8), the realigned q and k tiles unless ``direct``, the row
    offsets."""
    stages = SCORE_STAGES[bool(direct)]
    return 2 * (stages + (0 if direct else 1)) * 2 * round16(c) * (tile + 8) + 8 * c


def apply_smem(c: int, tile: int) -> int:
    """bf16 apply block: A (C16 x (C16 + 8)), APPLY_STAGES stages of v, the
    output tile (direct) or the realigned v tile, the row offsets."""
    c16 = round16(c)
    return 2 * (c16 * (c16 + 8) + (APPLY_STAGES + 1) * c16 * (tile + 8)) + 8 * c


def _blocks_per_sm(smem: int, threads: int) -> int:
    return max(1, min(SMEM_SM // (smem + SMEM_PER_BLOCK), 2048 // threads,
                      65536 // (threads * REGS)))


def _cover(n: int, tile: int, want: int, at_least: int) -> tuple:
    """(splits, chunk): ``want`` or fewer slices of whole tiles, none empty
    (one wave of long-lived blocks), and ``at_least`` (a block for every SM)
    where that stays within ``want``."""
    tiles = -(-n // tile)
    want = max(1, min(tiles, want))
    per = -(-tiles // want)
    if -(-tiles // per) < at_least and -(-tiles // max(1, tiles // at_least)) <= want:
        per = max(1, tiles // at_least)
    return -(-n // (per * tile)), per * tile


@functools.lru_cache(maxsize=256)
def attention_plan(b: int, c: int, heads: int, n: int, itemsize: int,
                   direct: bool = False) -> AttentionPlan:
    """K5's launch plan for q of shape (b, c, n) in a dtype of ``itemsize``
    bytes (4: the fp32 arm, 2: bf16 on the tensor cores). ``direct`` (bf16
    only): q, k, v and out start 16-byte aligned and n % 8 == 0, so every
    row does and the products read the copied stages as they land.

    bf16: each pass takes the widest tile (128, 64, 32 columns) whose grid
    still has a block for every SM and whose block fits (scores: two blocks
    an SM where some tile allows it, else one; apply: one), and as many
    slices of N per image as fill the SMs with the blocks that fit on each."""
    if not (1 <= c <= MAX_CHANNELS and heads >= 1 and c % heads == 0 and n >= 1):
        raise ValueError(f"K5: takes C <= {MAX_CHANNELS} divisible by heads, got C={c}, "
                         f"heads={heads}, N={n}")
    if b > MAX_GRID_YZ:
        raise ValueError(f"K5: batch {b} past the grid's limit {MAX_GRID_YZ}")
    cp = c // heads
    stride = c * cp + 2 * c
    rows_smem = 4 * (cp * cp + 2 * cp + ROWS_THREADS)
    direct = bool(direct) and itemsize == 2 and n % 8 == 0
    if itemsize == 4:
        groups = -(-c * cp // F32_ENTRIES_PER_BLOCK)
        splits, chunk = _cover(n, F32_SCORE_TILE, -(-F32_TARGET_BLOCKS // (b * groups)), 0)
        cpad = -(-c // 4) * 4
        plan = dict(score_tile=F32_SCORE_TILE, score_threads=F32_THREADS, score_groups=groups,
                    items_per_warp=1, score_smem=2 * F32_SCORE_TILE * (c + 1) * 4,
                    apply_splits=-(-n // F32_APPLY_TILE), apply_chunk=F32_APPLY_TILE,
                    apply_tile=F32_APPLY_TILE, apply_threads=F32_THREADS, apply_mt=1,
                    apply_smem=(c * cpad + cpad * F32_APPLY_TILE) * 4)
    else:
        items = len(score_items(c, cp))
        threads = SCORE_THREADS[direct]
        warps = threads // 32
        ipw = next(i for i in (1, 2, 4) if i * warps >= items or i == 4)
        groups = -(-items // (warps * ipw))

        def pick(fits, blocks):
            ok = [t for t in TILES if fits(t)]
            return next((t for t in ok if blocks(t) >= SMS), ok[-1])

        two_per_sm = any(scores_smem(c, t, direct) <= SMEM_TARGET for t in TILES)
        tile = pick(lambda t: scores_smem(c, t, direct) <= (SMEM_TARGET if two_per_sm else SMEM_LIMIT),
                    lambda t: b * groups * -(-n // t))
        smem = scores_smem(c, tile, direct)
        per_sm = _blocks_per_sm(smem, threads)
        splits, chunk = _cover(n, tile, SMS * per_sm // (b * groups), -(-SMS // (b * groups)))

        mtiles = round16(c) // 16
        mt = min(3, mtiles)
        row_warps = -(-mtiles // mt)
        a_tile = pick(lambda t: apply_smem(c, t) <= SMEM_LIMIT
                      and 32 * row_warps * t // (8 * APPLY_NT) <= MAX_THREADS,
                      lambda t: b * -(-n // t))
        a_threads = 32 * row_warps * a_tile // (8 * APPLY_NT)
        a_smem = apply_smem(c, a_tile)
        a_splits, a_chunk = _cover(n, a_tile, SMS * _blocks_per_sm(a_smem, a_threads) // b,
                                   -(-SMS // b))
        plan = dict(score_tile=tile, score_threads=threads, score_groups=groups,
                    items_per_warp=ipw, score_smem=smem, apply_splits=a_splits,
                    apply_chunk=a_chunk, apply_tile=a_tile, apply_threads=a_threads,
                    apply_mt=mt, apply_smem=a_smem)
    if splits > MAX_GRID_X or plan["apply_splits"] > MAX_GRID_X or plan["score_groups"] > MAX_GRID_YZ:
        raise ValueError(f"K5: N={n} needs a grid past the card's limits")
    a_offset = -(-4 * b * splits * stride // 256) * 256
    # A: (b, c, c) fp32, or the bf16 apply's shared-memory image (b, c16, c16 + 8)
    a_bytes = 4 * b * c * c if itemsize == 4 else 2 * b * round16(c) * (round16(c) + 8)
    return AttentionPlan(splits=splits, chunk=chunk, rows_smem=rows_smem, part_stride=stride,
                         a_offset=a_offset, scratch_bytes=a_offset + a_bytes, direct=int(direct),
                         score_stages=SCORE_STAGES[direct] if itemsize == 2 else 0, **plan)


_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
ATTENTION = CudaKernel(
    "attention_forward",
    [_p, _p, _p, _p, _i, _p, _p, _i, _p, ctypes.POINTER(_PlanStruct), _i64, _i, _i, _i64, _i],
)


@functools.lru_cache(maxsize=256)
def _plan_struct(b: int, c: int, heads: int, n: int, itemsize: int, direct: bool) -> tuple:
    """(plan, its C struct), made once per shape: the host work of a call
    is most of the call at batch 1."""
    plan = attention_plan(b, c, heads, n, itemsize, direct)
    return plan, _PlanStruct(*plan)


def channel_attention_plain(q, k, v, temperature, heads, *, normalize_qk=True, w_proj=None):
    """Twin of K5."""
    return attention.channel_attention(
        q, k, v, temperature, heads, normalize_qk=normalize_qk, w_proj=w_proj
    )


def channel_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    temperature: torch.Tensor,
    heads: int,
    *,
    normalize_qk: bool = True,
    w_proj: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch K5 on contiguous NCHW q, k, v on the card."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check_input(t, name, 4)
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype \
            or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"q, k, v: expected one shape, dtype and device, got {tuple(q.shape)} {q.dtype}, "
            f"{tuple(k.shape)} {k.dtype}, {tuple(v.shape)} {v.dtype}"
        )
    b, c, h, w = q.shape
    if c > MAX_CHANNELS or heads < 1 or c % heads:
        raise ValueError(
            f"q: the attention kernel takes C <= {MAX_CHANNELS} divisible by heads, got C={c}, "
            f"heads={heads}"
        )
    if temperature.dtype != torch.float32 or temperature.numel() != heads \
            or temperature.device != q.device or not temperature.is_contiguous():
        raise ValueError(
            f"temperature: expected {heads} contiguous fp32 values on {q.device}, got "
            f"{tuple(temperature.shape)} {temperature.dtype} on {temperature.device}"
        )
    wp, w_code = None, -1
    if w_proj is not None:
        if tuple(w_proj.shape) != (c, c, 1, 1) or w_proj.dtype not in DTYPE_CODES \
                or w_proj.device != q.device or not w_proj.is_contiguous():
            raise ValueError(
                f"w_proj: expected a contiguous ({c}, {c}, 1, 1) fp32/bf16 weight on {q.device}, "
                f"got {tuple(w_proj.shape)} {w_proj.dtype} on {w_proj.device}"
            )
        wp, w_code = w_proj.data_ptr(), DTYPE_CODES[w_proj.dtype]
    n = h * w
    direct = n % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    plan, struct = _plan_struct(b, c, heads, n, q.element_size(), direct)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=q.device)
    out = torch.empty_like(q)
    ATTENTION(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype],
        temperature.data_ptr(), wp, w_code, scratch.data_ptr(), ctypes.byref(struct),
        b, c, heads, n, int(normalize_qk),
    )
    return out


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, temperature, w_proj, heads, normalize_qk):
        ctx.heads, ctx.normalize_qk, ctx.fold = heads, normalize_qk, w_proj is not None
        ctx.save_for_backward(q, k, v, temperature, *([w_proj] if ctx.fold else []))
        return channel_attention_kernel(
            q, k, v, temperature, heads, normalize_qk=normalize_qk, w_proj=w_proj
        )

    @staticmethod
    def backward(ctx, grad):
        def plain(q, k, v, temperature, w_proj=None):
            return channel_attention_plain(
                q, k, v, temperature, ctx.heads, normalize_qk=ctx.normalize_qk, w_proj=w_proj
            )

        inputs = ctx.saved_tensors
        grads = twin_backward(plain, inputs, grad, ctx.needs_input_grad[: len(inputs)])
        return (*grads, *([None] * (7 - len(grads))))


def channel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    temperature: torch.Tensor,
    heads: int,
    *,
    normalize_qk: bool = True,
    w_proj: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Channel attention of the CAB (and TNSM) blocks. CPU: twin; CUDA: K5."""
    if q.device.type == "cpu":
        return channel_attention_plain(
            q, k, v, temperature, heads, normalize_qk=normalize_qk, w_proj=w_proj
        )
    return _Attention.apply(q, k, v, temperature, w_proj, heads, normalize_qk)
