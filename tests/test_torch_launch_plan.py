"""The host-side launch plans of K4 (``ops/resize_cuda.py:double_plan``) and
K7 (``ops/iel_cuda.py:iel_plan``), checked on the CPU.

Each test walks the plan the way the kernel walks it (the mapping that
``DoublePlan`` and ``IelPlan`` document, as ``csrc/resize.cu`` and
``csrc/iel.cu`` implement it) and checks that every output row and column
is written exactly once, that the shared memory fits, that the batch-1
level-1 K7 site fills the card, and that no grid dimension overflows.
"""

import numpy as np
import pytest

from hvi_cidnet_torch.ops import iel_cuda as ic
from hvi_cidnet_torch.ops import resize_cuda as rc

# (h, w) of the forward's K4 inputs (600 x 400: block3, block2, block1),
# 1280 x 720's, and small odd ones
K4_SIZES = [(50, 75), (100, 150), (200, 300), (90, 160), (180, 320), (360, 640),
            (1, 1), (7, 3), (25, 75), (13, 151), (33, 8)]
# (h, w) of the forward's K7 levels at 600 x 400 and 1280 x 720, and odd ones
K7_SIZES = [(200, 300), (100, 150), (50, 75), (360, 640), (180, 320), (90, 160),
            (1, 1), (17, 33), (40, 70), (37, 151), (2, 640), (123, 1)]
ITEMSIZES = [4, 2]  # fp32, bf16


def _double_writes(plan, h, w):
    """Times each output (row, column) of one plane is written."""
    _, gy, gz = plan.grid
    rows = np.zeros(2 * h, np.int64)
    cols = np.zeros(2 * w, np.int64)
    for by in range(gy):
        for ty in range(plan.ty):
            j0 = (by * plan.ty + ty) * plan.rows_per_thread
            for j in range(j0, min(h, j0 + plan.rows_per_thread)):
                rows[2 * j] += 1
                rows[2 * j + 1] += 1
    for bz in range(gz):
        for tx in range(plan.tx):
            c0 = (bz * plan.tx + tx) * plan.chunk
            for v in range(0, plan.chunk, plan.store):  # one vector store each
                if c0 + v < 2 * w:
                    cols[c0 + v:c0 + v + plan.store] += 1
    return rows, cols


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("h,w", K4_SIZES)
def test_k4_plan_covers_each_output_once(h, w, itemsize):
    plan = rc.double_plan(3, h, w, itemsize)
    rows, cols = _double_writes(plan, h, w)
    assert (rows == 1).all() and (cols == 1).all()
    # every store is an aligned vector inside the row, at most 16 bytes
    assert plan.chunk * itemsize == 16 and plan.chunk % plan.store == 0
    assert (2 * w) % plan.store == 0 and plan.store * itemsize <= 16
    assert (plan.tx, plan.ty) == rc.DOUBLE_BLOCK


@pytest.mark.parametrize("itemsize,w,store_bytes", [
    (2, 300, 16), (2, 150, 8), (2, 75, 4), (2, 640, 16), (2, 151, 4),
    (4, 300, 16), (4, 75, 8), (4, 1, 8),
])
def test_k4_plan_takes_the_widest_store_the_row_pitch_allows(itemsize, w, store_bytes):
    assert rc.double_plan(1, 8, w, itemsize).store * itemsize == store_bytes


def test_k4_plan_grid_stays_in_limits():
    planes, gy, gz = rc.double_plan(128 * 72, 50, 75, 2).grid
    assert planes == 128 * 72 and planes * gy * gz <= rc.MAX_GRID_X
    planes, gy, gz = rc.double_plan(1, 65535 * 8, 65535 * 4, 4).grid
    assert planes * gy * gz <= rc.MAX_GRID_X
    with pytest.raises(ValueError, match="blocks"):
        rc.double_plan(2**20, 4096, 4096, 4)


def _iel_writes(plan, h, w):
    """Times each output (row, column) of one plane is written, following
    the block's steps: step k writes rows [ob - 4 + k * bh, ob - 4 + (k + 1)
    * bh) of its range [ob, oe), each thread its group's rows and its column
    pairs (the second column of a pair at c0 = w - 1 is not written)."""
    bh, rg = plan.band_rows, plan.band_rows // plan.groups
    writes = np.zeros((h, w), np.int64)
    for r in range(plan.ranges):
        ob = r * plan.rows_per_range
        oe = min(h, ob + plan.rows_per_range)
        assert ob < oe  # no empty range
        steps = -(-(oe - ob + 4) // bh)
        for k in range(steps):
            first = ob - 2 + k * bh
            for g in range(plan.groups):
                for q in range(plan.group_size):
                    cols = [c0 + i for m in range(plan.pairs_per_thread)
                            for c0 in [2 * (q + m * plan.group_size)] for i in (0, 1)]
                    for row in range(g * rg, (g + 1) * rg):
                        o = first - 2 + row
                        if ob <= o < oe:
                            for col in cols:
                                if col < w:
                                    writes[o, col] += 1
    return writes


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("h,w", K7_SIZES)
def test_k7_plan_covers_each_output_once(h, w, itemsize):
    plan = ic.iel_plan(5, h, w, itemsize)
    assert (_iel_writes(plan, h, w) == 1).all()
    assert plan.band_rows >= 2 and plan.band_rows % plan.groups == 0
    assert plan.groups * plan.group_size <= plan.threads <= ic.MAX_THREADS
    assert plan.threads % 32 == 0
    # a stage holds a band plus the 16-byte alignment slack at both ends
    vec = 16 // itemsize
    assert plan.stage_elems % vec == 0 and plan.stage_elems >= plan.band_rows * w + 2 * vec


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("w", [1, 2, 3, 31, 64, 75, 150, 151, 300, 320, 511, 512, 513, 639, 640])
def test_k7_plan_shared_memory_fits_an_sm(w, itemsize):
    plan = ic.iel_plan(8, 64, w, itemsize)
    assert plan.smem_bytes <= ic.SMEM_LIMIT
    assert plan.smem_bytes == ic.iel_smem_bytes(plan.band_rows, w, itemsize)[1]
    # every width up to 640 gets a band tall enough for two blocks per SM
    assert 2 * plan.smem_bytes <= ic.SMEM_LIMIT


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_k7_plan_shared_memory_fits_at_every_width_to_640(itemsize):
    for w in range(1, 641):
        plan = ic.iel_plan(95, 200, w, itemsize)
        assert 2 * plan.smem_bytes <= ic.SMEM_LIMIT, w


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_k7_plan_fills_the_card_at_batch_1(itemsize):
    # level 1 of the 600 x 400 forward at batch 1: 95 planes of 200 x 300
    plan = ic.iel_plan(95, 200, 300, itemsize)
    assert plan.blocks == 95 * plan.ranges
    assert plan.blocks >= 2 * ic.SMS
    # batch 8 needs no cut: 760 planes are over five blocks per SM already
    assert ic.iel_plan(760, 200, 300, itemsize).ranges == 1


def test_k7_plan_grid_stays_in_limits():
    plan = ic.iel_plan(128 * 383, 50, 75, 2)
    assert plan.blocks <= ic.MAX_GRID_X
    with pytest.raises(ValueError, match="grid"):
        ic.iel_plan(2**31, 64, 8, 2)
    with pytest.raises(ValueError, match="shared memory"):
        ic.iel_plan(1, 4, 20_000, 4)
