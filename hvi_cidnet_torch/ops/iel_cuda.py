"""K7: the fused IEL-branch kernel ``tanh(dw2(dw1(y))) + dw1(y)``, its plain
twin and the dispatcher ``iel_branch``.

Counterpart of ``hvi_cidnet_tpu/ops/iel_pallas.py``. The kernel is
``csrc/iel.cu`` and takes a contiguous NCHW activation and the two
(C, 1, 3, 3) depthwise weights; the twin is ``ops/iel.py:iel_branch``. Like
the twin's ``dwconv3x3``, the wrapper takes the weights in the activation
dtype (``w.to(y.dtype)``, a no-op in the model, whose conv weights already
hold the compute dtype). The kernel launches by a plan computed here
(``iel_plan``: band height, thread groups, row ranges, shared memory),
which the CPU tests walk.

Dispatch is by device only: a CPU tensor takes the plain twin, a CUDA
tensor the kernel. Backward runs the twin's autograd.

In a row group (``parallel/rows.py``) each shard runs the branch on its
rows with two halo rows each side (none past the image's top and bottom),
and keeps its own rows: the kernel runs unchanged on the band. It zeroes
t1 outside the band, which moves only the halo rows' outputs, and those
are cropped; a band's rows are, bit for bit, the whole plane's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from hvi_cidnet_torch.ops import iel
from hvi_cidnet_torch.ops._build import DTYPE_CODES, CudaKernel, check_input, twin_backward
from hvi_cidnet_torch.parallel import rows

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
IEL_BRANCH = CudaKernel("iel_branch", [_p, _p, _i, _p, _p, _i64, _i, _i, _i] + [_i] * 9)

SMS = 132                    # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232_448         # shared memory one block may use (227 KB)
SMEM_TARGET = 75 * 1024      # at most this much, so that three blocks share an SM
STAGES = 4                   # csrc/iel.cu:kStages
MAX_THREADS = 512            # csrc/iel.cu:kMaxIelThreads
MAX_GRID_X = 2**31 - 1
MIN_RANGE_ROWS = 16          # a row range's two halo rows at each end stay <= 1/4 of it
BANDS = (32, 16, 8, 4, 2)    # band heights, tallest first
GROUP_ROWS = 8               # rows a thread walks per band, where the band allows


class IelPlan(NamedTuple):
    """How K7 covers a (planes, h, w) tensor (``csrc/iel.cu``).

    Block b owns plane b // ranges and output rows [r * rows_per_range,
    (r + 1) * rows_per_range) of it, r = b % ranges; it walks them in
    bands of ``band_rows``. Thread t is in group g = t // group_size (threads
    with g >= groups only copy) and owns, in every band, rows [g * band_rows
    / groups, (g + 1) * band_rows / groups) at the column pairs (c0, c0 + 1),
    c0 = 2 * (q + m * group_size) < w for m < ``pairs_per_thread``, q = t %
    group_size.
    """

    band_rows: int
    groups: int
    group_size: int
    pairs_per_thread: int
    threads: int
    ranges: int
    rows_per_range: int
    stage_elems: int      # elements of one y stage (a band plus 16-byte slack)
    smem_bytes: int
    blocks: int


def iel_smem_bytes(band_rows: int, w: int, itemsize: int) -> tuple:
    """(stage elements, dynamic shared memory in bytes) of one K7 block:
    STAGES y stages, two t1 bands (an even pitch with zero columns on both
    sides), a zero row."""
    vec = 16 // itemsize
    stage = (-(-band_rows * w // vec) + 2) * vec
    t1_pitch = (w + 6) & ~1
    return stage, (STAGES * stage + 2 * band_rows * t1_pitch + w) * itemsize


def iel_plan(planes: int, h: int, w: int, itemsize: int) -> IelPlan:
    """K7's launch plan. The band is the tallest of 32 ... 2 rows whose
    shared memory lets three blocks share an SM (else one); threads are
    whole groups of one row's column pairs, up to 512, each group walking
    at least 8 rows of a band where the band allows; planes are cut into row
    ranges of at least 16 rows until there are four blocks per SM. (Taller
    bands mean fewer barriers per row; a band past a third of the SM's
    shared memory, or groups of 2-4 rows, were slower on the card.)"""
    band = None
    for limit in (SMEM_TARGET, SMEM_LIMIT):
        band = next((b for b in BANDS if iel_smem_bytes(b, w, itemsize)[1] <= limit), None)
        if band is not None:
            break
    if band is None:
        raise ValueError(f"K7: a band of width {w} does not fit in shared memory")
    stage, smem = iel_smem_bytes(band, w, itemsize)
    pairs = -(-w // 2)
    per_thread = -(-pairs // MAX_THREADS)
    group_size = -(-pairs // per_thread)
    groups = 1
    while 2 * groups * min(GROUP_ROWS, band) <= band and 2 * groups * group_size <= MAX_THREADS:
        groups *= 2
    threads = -(-groups * group_size // 32) * 32
    ranges = max(1, min(-(-4 * SMS // planes), h // MIN_RANGE_ROWS))
    rows_per_range = -(-h // ranges)
    ranges = -(-h // rows_per_range)  # no empty range
    blocks = planes * ranges
    if blocks > MAX_GRID_X:
        raise ValueError(f"K7: {planes} planes need {blocks} blocks, past the grid's limit")
    return IelPlan(band, groups, group_size, per_thread, threads, ranges, rows_per_range, stage,
                   smem, blocks)


def iel_branch_plain(y: torch.Tensor, w_dw1: torch.Tensor, w_dw2: torch.Tensor) -> torch.Tensor:
    """Twin of K7."""
    return iel.iel_branch(y, w_dw1, w_dw2)


def _taps(wt: torch.Tensor, y: torch.Tensor, name: str) -> torch.Tensor:
    c = y.shape[1]
    if tuple(wt.shape) != (c, 1, 3, 3) or wt.device != y.device:
        raise ValueError(
            f"{name}: expected a ({c}, 1, 3, 3) depthwise weight on {y.device}, got "
            f"{tuple(wt.shape)} on {wt.device}"
        )
    wt = wt.to(y.dtype)
    if not wt.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return wt


def iel_branch_kernel(y: torch.Tensor, w_dw1: torch.Tensor, w_dw2: torch.Tensor) -> torch.Tensor:
    """Launch K7 on contiguous NCHW ``y`` on the card."""
    check_input(y, "y", 4)
    b, c, h, w = y.shape
    w1, w2 = _taps(w_dw1, y, "w_dw1"), _taps(w_dw2, y, "w_dw2")
    if h * w >= 2**31:
        raise ValueError(f"y: K7 takes planes below 2**31 elements, got {h} x {w}")
    plan = iel_plan(b * c, h, w, y.element_size())
    out = torch.empty_like(y)
    IEL_BRANCH(y.device, y.data_ptr(), out.data_ptr(), DTYPE_CODES[y.dtype], w1.data_ptr(),
               w2.data_ptr(), b * c, c, h, w, plan.band_rows, plan.groups, plan.group_size,
               plan.pairs_per_thread, plan.threads, plan.ranges, plan.rows_per_range,
               plan.stage_elems, plan.smem_bytes)
    return out


class _IelBranch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, w_dw1, w_dw2):
        ctx.save_for_backward(y, w_dw1, w_dw2)
        return iel_branch_kernel(y, w_dw1, w_dw2)

    @staticmethod
    def backward(ctx, grad):
        return twin_backward(iel_branch_plain, ctx.saved_tensors, grad, ctx.needs_input_grad)


def iel_branch(y: torch.Tensor, w_dw1: torch.Tensor, w_dw2: torch.Tensor) -> torch.Tensor:
    """The IEL gate branch. CPU: twin; CUDA: K7. In a row group, on the
    shard's band (forward only)."""
    shard = rows.current()
    if shard is not None:
        band, top = shard.extend(y, 2, 2)
        if y.device.type == "cpu":
            with rows.suspended():  # the twin's convs take the band as it is
                out = iel_branch_plain(band, w_dw1, w_dw2)
        else:
            out = iel_branch_kernel(band, w_dw1, w_dw2)
        return out[..., top:top + y.shape[-2], :]
    if y.device.type == "cpu":
        return iel_branch_plain(y, w_dw1, w_dw2)
    return _IelBranch.apply(y, w_dw1, w_dw2)
