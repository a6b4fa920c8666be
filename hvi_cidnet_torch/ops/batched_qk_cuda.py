"""P10/P15: the batched score product, its plain version and the dispatcher
``batched_qk``; the launch plan of the score core it shares with P1.

Counterpart of ``experiments/relayout_probe_r5h.py:dot_bcn`` (P10) and
``experiments/mosaic_micro_r5h.py:bdot`` (P15): ``s[g] = q[g] k[g]^T`` over
the last axis, (G, c, N) x (G, c, N) -> (G, c, c) in fp32, for fp32 or
bf16 q and k. P10 as written never zeroes its output before accumulating
into it (its interpret-mode result is NaN); P15, and this port, compute
what it was meant to. The kernel is ``csrc/batched_qk.cu`` on the score
core of ``csrc/qk_scores.cuh``: a cluster of ``splits`` blocks per g, each
summing ``chunk`` columns in loads of ``vec`` elements, met in a fixed
order (two calls give the same bits). The plain version is one fp32
``bmm`` with TF32 off.

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
MAX_CLUSTER = 8         # the portable cluster size
SMS = 132               # streaming multiprocessors of an H100 SXM
TARGET_BLOCKS = 2 * SMS
SMEM_LIMIT = 232_448    # shared memory one block may use (227 KB)
MAX_GRID_Y = 65535


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
    """How P10/P15 covers a (g, c, n) call: grid (splits, g) in clusters of
    ``splits``; block (s, i) sums columns [s * chunk, (s + 1) * chunk) of
    row i, ``vec`` elements a load, and writes entries [s * per, (s + 1) *
    per) of its c x c."""

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


@functools.lru_cache(maxsize=256)
def qk_plan(g: int, c: int, n: int, itemsize: int = 2, offset: int = 0) -> QkPlan:
    """P10/P15's launch plan for (g, c, n) q and k of ``itemsize`` bytes
    whose starts lie ``offset`` bytes (or-ed) past 16-byte boundaries."""
    check_shape(g, c, n, "P10/P15")
    splits, chunk = split_n(g, n)
    return QkPlan(splits, chunk, splits * g, side_tiles(c), slices(c),
                  load_vec(n, itemsize, offset), core_bytes(c, False, itemsize))


_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
BATCHED_QK = CudaKernel("batched_qk", [_p, _p, _p, _i, _i64, _i, _i64, _i, _i64, _i, _i64])


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
    plan = qk_plan(g, c, n, q.element_size(), (q.data_ptr() | k.data_ptr()) % 16)
    out = torch.empty((g, c, c), dtype=torch.float32, device=q.device)
    BATCHED_QK(q.device, q.data_ptr(), k.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype], g, c,
               n, plan.splits, plan.chunk, plan.vec, plan.smem_bytes)
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
