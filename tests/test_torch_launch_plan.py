"""The host-side launch plans of K1 (``ops/hvi_cuda.py:rgb_to_hvi_plan``), K2
(``ops/hvi_cuda.py:hvi_to_rgb_plan``), K3
(``ops/resize_cuda.py:half_plan``), K4 (``ops/resize_cuda.py:double_plan``), K5
(``ops/attention_cuda.py:attention_plan``), K6 (``ops/norm_cuda.py:
layer_norm_plan``) and K7 (``ops/iel_cuda.py:iel_plan``), checked on the CPU.

Each test walks the plan the way the kernel walks it (the mapping that
``DoublePlan``, ``AttentionPlan``, ``LayerNormPlan`` and ``IelPlan``
document, as the ``csrc/*.cu`` kernels implement it) and checks that every
output (and, for K5, every column of the contraction and every entry of the
score matrix) is covered exactly once, that the shared memory fits, that the
batch-1 sites fill the card, and that no grid dimension overflows; for K1,
K2 and K3 also that loads and stores take the widest vector the row
pitches and the base allow. The fused block route's kernels too: P2/P3
(``ops/ln_iel_cuda.py:ln_iel_plan``), P4 (``ops/conv3x3_cuda.py:
conv3x3_plan``) and P5 (``ops/conv3x3_cuda.py:half_plan``); and the probe
route's: P10/P15 and P1 (``ops/batched_qk_cuda.py:qk_plan``,
``ops/head_attention_cuda.py:head_attention_plan``: the cluster size, the
split of N, the entries' threads, shared memory, the load width) and P6
(``ops/im2col_cuda.py:im2col_plan``: the N tail, the C_out and K padding,
the load width) at every site shape and at batch 1, 8 and 32.
"""

import itertools
import math

import numpy as np
import pytest

from hvi_cidnet_torch.ops import conv3x3_cuda as cc
from hvi_cidnet_torch.ops import hvi_cuda as hc
from hvi_cidnet_torch.ops import ln_iel_cuda as lc
from hvi_cidnet_torch.ops import iel_cuda as ic
from hvi_cidnet_torch.ops import relayout_cuda as rl
from hvi_cidnet_torch.ops import resize_cuda as rc

# (h, w) of the forward's K4 inputs (600 x 400: block3, block2, block1),
# 1280 x 720's, and small odd ones
K4_SIZES = [(50, 75), (100, 150), (200, 300), (90, 160), (180, 320), (360, 640),
            (1, 1), (7, 3), (25, 75), (13, 151), (33, 8)]
# (h, w) of the forward's K7 levels at 600 x 400 and 1280 x 720, and odd ones
K7_SIZES = [(200, 300), (100, 150), (50, 75), (360, 640), (180, 320), (90, 160),
            (1, 1), (17, 33), (40, 70), (37, 151), (2, 640), (123, 1)]
ITEMSIZES = [4, 2]  # fp32, bf16


# K3's inputs (C, h, w) at 600 x 400 (block1, block2, block3), and (h, w)
# of odd and small widths: odd source widths (output 75 from 150 and 151),
# 7, 2, 75 (output 37), h = 2 and odd heights, 1280 x 720's block1
K3_SITES = [(36, 400, 600), (72, 200, 300), (144, 100, 150)]
K3_SIZES = [(50, 150), (51, 151), (9, 7), (2, 2), (2, 14), (3, 75), (31, 4), (720, 1280),
            (2, 600), (17, 2)]


def _half_walk(plan, h, w, itemsize, offset):
    """Times each output (row, column) of one plane is written, following
    the plan's threads; checks each thread's loads and stores on the way."""
    ho, wo = h // 2, w // 2
    _, gy, gz = plan.grid
    rows = np.zeros(ho, np.int64)
    cols = np.zeros(wo, np.int64)
    for by in range(gy):
        for ty in range(plan.ty):
            i0 = (by * plan.ty + ty) * plan.rows_per_thread
            for i in range(i0, min(ho, i0 + plan.rows_per_thread)):
                rows[i] += 1
    for bz in range(gz):
        for tx in range(plan.tx):
            c0 = (bz * plan.tx + tx) * plan.chunk
            if c0 >= wo:
                continue
            s0 = 2 * c0  # whole vectors inside the row, aligned in every row and plane
            vec = plan.load * itemsize
            assert s0 + 2 * plan.chunk <= w and (2 * plan.chunk) % plan.load == 0
            assert (offset + s0 * itemsize) % vec == 0 and (w * itemsize) % vec == 0
            # one aligned vector store of the chunk, inside the row
            assert c0 + plan.chunk <= wo and wo % plan.chunk == 0
            cols[c0:c0 + plan.chunk] += 1
    return rows, cols


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("site", K3_SITES, ids=str)
def test_k3_plan_covers_each_output_once_at_the_sites(site, b, itemsize):
    c, h, w = site
    plan = rc.half_plan(b * c, h, w, itemsize)
    rows, cols = _half_walk(plan, h, w, itemsize, 0)
    assert (rows == 1).all() and (cols == 1).all()
    assert plan.grid[0] == b * c and plan.tx * plan.ty <= rc.HALF_MAX_THREADS
    assert plan.chunk == max(1, plan.load // 2)


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("h,w", K3_SIZES)
def test_k3_plan_covers_each_output_once_at_odd_sizes(h, w, b, itemsize):
    for offset in (0, itemsize, 4, 8):
        plan = rc.half_plan(b * 3, h, w, itemsize, offset)
        rows, cols = _half_walk(plan, h, w, itemsize, offset)
        assert (rows == 1).all() and (cols == 1).all()
        assert plan.tx * plan.ty <= rc.HALF_MAX_THREADS


def _widest(size, offset, itemsize):
    """The widest of 16, 8, 4, 2 bytes that divides a row of ``size``
    elements and the base offset (the kernels' rule, written out)."""
    return next(vec for vec in (16, 8, 4, 2, 1)
                if (size * itemsize) % vec == 0 and offset % vec == 0 and vec % itemsize == 0)


# (itemsize, w, base offset, load bytes, store bytes): a thread's chunk is
# half its load and its store; at the sites (600, 300, 150) the store is the
# widest the output pitch allows
@pytest.mark.parametrize("itemsize,w,offset,load_bytes,store_bytes", [
    (2, 600, 0, 16, 8), (2, 300, 0, 8, 4), (2, 150, 0, 4, 2), (2, 151, 0, 2, 2),
    (2, 600, 2, 2, 2), (2, 600, 4, 4, 2), (2, 600, 8, 8, 4), (2, 1280, 0, 16, 8),
    (2, 14, 0, 4, 2), (2, 2, 0, 4, 2), (2, 7, 0, 2, 2),
    (4, 600, 0, 16, 8), (4, 300, 0, 16, 8), (4, 150, 0, 8, 4), (4, 151, 0, 4, 4),
    (4, 600, 4, 4, 4), (4, 600, 8, 8, 4), (4, 2, 0, 8, 4),
])
def test_k3_plan_takes_the_widest_vectors_the_pitches_and_base_allow(itemsize, w, offset,
                                                                     load_bytes, store_bytes):
    plan = rc.half_plan(4, 8, w, itemsize, offset)
    assert plan.load * itemsize == load_bytes == _widest(w, offset, itemsize)
    assert plan.chunk * itemsize == store_bytes == max(itemsize, load_bytes // 2)
    assert (w // 2) % plan.chunk == 0


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("site", K3_SITES, ids=str)
def test_k3_plan_fills_the_card_at_batch_1(site, itemsize):
    c, h, w = site
    plan = rc.half_plan(c, h, w, itemsize)
    _, gy, gz = plan.grid
    assert c * gy * gz >= rc.SMS  # at least one block per SM, block3 included
    threads = c * -(-(w // 2) // plan.chunk) * -(-(h // 2) // plan.rows_per_thread)
    assert threads >= rc.HALF_MIN_THREADS or plan.rows_per_thread == 1


def test_k3_plan_is_cached_and_stays_in_the_grid():
    assert rc.half_plan(288, 400, 600, 2) is rc.half_plan(288, 400, 600, 2)
    planes, gy, gz = rc.half_plan(128 * 144, 100, 150, 2).grid
    assert planes * gy * gz <= rc.MAX_GRID_X
    planes, gy, gz = rc.half_plan(1, 2 * 65535 * 8, 2 * 65535 * 4, 4).grid
    assert planes * gy * gz <= rc.MAX_GRID_X
    with pytest.raises(ValueError, match="blocks"):
        rc.half_plan(2**24, 4096, 4096, 2)


# K2's images (H * W): 600 x 400, 1280 x 720, odd (19 x 23), a multiple of
# 4 but not 8 (6 x 10), of 8 but not of a block's run (24 x 41 = 984)
K2_SIZES = [400 * 600, 720 * 1280, 19 * 23, 6 * 10, 24 * 41, 1, 2, 16]


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("b", [1, 3, 8, 32])
@pytest.mark.parametrize("hw", K2_SIZES)
def test_k2_plan_covers_each_pixel_once(hw, b, itemsize):
    for offset in (0, itemsize, 8):
        plan = hc.hvi_to_rgb_plan(b, hw, itemsize, offset)
        runs, images = plan.grid
        run, threads, vec = plan.run, hc.RGB_THREADS, plan.vec
        assert images == b and runs * run >= hw > (runs - 1) * run
        assert run % vec == 0 and run % threads == 0 and (3 * run * itemsize) % 16 == 0
        x = np.arange(runs)[:, None, None]
        n = np.minimum(run, hw - x * run)  # pixels of each run
        # the loads: thread t takes vectors t, t + threads, ... of the run,
        # each whole and aligned in every plane
        q = (np.arange(threads)[None, :, None] + threads * np.arange(run // (threads * vec) + 1)) * vec
        active = np.broadcast_to(q < n, (runs, threads, q.shape[-1]))
        assert np.broadcast_to(q + vec <= n, active.shape)[active].all()
        starts = np.broadcast_to(x * run + q, active.shape)[active]
        for c in range(3):
            assert (((c * hw + starts) * itemsize + offset) % (vec * itemsize) == 0).all()
        loaded = np.bincount((starts[:, None] + np.arange(vec)).ravel(), minlength=hw)
        # the pixels: thread t converts t, t + threads, ...
        p = np.arange(threads)[None, :, None] + threads * np.arange(run // threads)
        done = np.broadcast_to(p < n, (runs, threads, p.shape[-1]))
        converted = np.bincount(np.broadcast_to(x * run + p, done.shape)[done], minlength=hw)
        assert (loaded == 1).all() and (converted == 1).all()
        assert plan.smem_bytes == (6 * run + 16 // itemsize) * itemsize <= hc.RGB_SMEM


@pytest.mark.parametrize("itemsize,hw,offset,vec_bytes", [
    (2, 240000, 0, 16), (2, 60, 0, 8), (2, 437, 0, 2), (2, 240000, 2, 2), (2, 240000, 4, 4),
    (2, 240000, 8, 8), (4, 240000, 0, 16), (4, 60, 0, 16), (4, 30, 0, 8), (4, 437, 0, 4),
    (4, 240000, 4, 4), (4, 240000, 8, 8),
])
def test_k2_plan_takes_the_widest_load_the_pitch_and_base_allow(itemsize, hw, offset, vec_bytes):
    plan = hc.hvi_to_rgb_plan(2, hw, itemsize, offset)
    assert plan.vec * itemsize == vec_bytes == _widest(hw, offset, itemsize)


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_k2_plan_fills_the_card_at_batch_1(itemsize):
    # one pixel a thread: 938 blocks of 256 threads, over seven per SM
    plan = hc.hvi_to_rgb_plan(1, 400 * 600, itemsize)
    assert plan.run == hc.RGB_THREADS and plan.grid[0] >= 7 * hc.SMS
    # batch 8 takes two pixels a thread, batch 32 four
    plan = hc.hvi_to_rgb_plan(8, 400 * 600, itemsize)
    assert plan.run == 2 * hc.RGB_THREADS and 8 * plan.grid[0] >= hc.RGB_MIN_BLOCKS
    assert hc.hvi_to_rgb_plan(32, 400 * 600, itemsize).run == 4 * hc.RGB_THREADS


def test_k2_plan_is_cached_and_stays_in_the_grid():
    assert hc.hvi_to_rgb_plan(8, 240000, 2) is hc.hvi_to_rgb_plan(8, 240000, 2)
    assert hc.hvi_to_rgb_plan(hc.MAX_GRID_Y, 64, 2).grid[1] == hc.MAX_GRID_Y
    with pytest.raises(ValueError, match="grid"):
        hc.hvi_to_rgb_plan(hc.MAX_GRID_Y + 1, 64, 2)


# (input, output) itemsizes of K1: fp32 and bf16, and the two mixed pairs
K1_ITEMSIZES = [(4, 4), (2, 2), (4, 2), (2, 4)]


def _k1_walk(plan, b, hw, in_itemsize, out_itemsize, in_offset, out_offset):
    """Follows K1's threads over the images of ``plan`` (``csrc/hvi.cu``)
    whose tensors start ``in_offset`` / ``out_offset`` bytes past a 16-byte
    boundary: checks that every input element is loaded once, in aligned
    16-byte vectors where the vector lies inside the block's line and
    element by element at its ragged ends, that every pixel is converted
    once, and that every plane element is stored once in an aligned
    ``plan.vec`` vector. The line's offset from a 16-byte boundary repeats
    every 16 / gcd(16, 3 * hw * in_itemsize) images: so many are walked."""
    runs, images = plan.grid
    run, threads, vec = plan.run, hc.RGB_THREADS, plan.vec
    v16 = 16 // in_itemsize
    x = np.arange(runs)[:, None]
    n = np.minimum(run, hw - x * run)  # pixels of each run
    for y in range(min(images, 16 // math.gcd(16, 3 * hw * in_itemsize))):
        start = (y * hw + x * run) * 3  # the line's first element
        shift = (in_offset + start * in_itemsize) % 16 // in_itemsize
        end = shift + 3 * n
        # the loads: thread t takes the whole 16-byte vectors t, t + threads,
        # ... from `first` (the line's first 16-byte boundary at or after
        # `shift`) to `last`; threads 0, 1, ... take one element each of the
        # head [shift, min(first, end)) and the tail [max(last, head_end), end)
        first, last = np.where(shift > 0, v16, 0), end // v16 * v16
        head_end = np.minimum(first, end)
        tail = np.maximum(last, head_end)
        assert (head_end - shift < v16).all() and (end - tail < v16).all()
        slot = np.arange(-(-3 * run // (threads * v16)) * threads)
        t, it = slot % threads, slot // threads
        e0 = first + ((t + threads * it) * v16)[None, :]
        whole = e0 < last
        g0 = start - shift + e0  # element of the tensor at e0
        assert ((in_offset + g0[whole] * in_itemsize) % 16 == 0).all()
        vec_elems = np.broadcast_to(g0[..., None] + np.arange(v16), whole.shape + (v16,))
        e = np.arange(v16)[None, :]  # thread t's element of the head and the tail
        ends = [(shift + e, shift + e < head_end), (tail + e, tail + e < end)]
        elem = np.concatenate([vec_elems[whole].ravel()]
                              + [np.broadcast_to(start - shift + i, i.shape)[m] for i, m in ends])
        assert (np.bincount(elem - y * hw * 3, minlength=3 * hw) == 1).all()
        # the pixels: thread t converts t, t + threads, ...
        p = np.arange(run)[None, :]
        assert (np.bincount(np.broadcast_to(x * run + p, (runs, run))[p < n],
                            minlength=hw) == 1).all()
        # the stores: thread t takes vectors t, t + threads, ... of each plane
        q = (np.arange(threads)[None, :, None]
             + threads * np.arange(run // (threads * vec) + 1)) * vec
        xq = x[..., None]
        done = np.broadcast_to(q < n[..., None], (runs, threads, q.shape[-1]))
        assert np.broadcast_to(q + vec <= n[..., None], done.shape)[done].all()
        first = np.broadcast_to(xq * run + q, done.shape)[done]
        for c in range(3):
            assert (((out_offset + ((y * 3 + c) * hw + first) * out_itemsize)
                     % (vec * out_itemsize)) == 0).all()
        stored = np.bincount((first[:, None] + np.arange(vec)).ravel(), minlength=hw)
        assert (stored == 1).all()


@pytest.mark.parametrize("itemsizes", K1_ITEMSIZES, ids=str)
@pytest.mark.parametrize("b", [1, 3, 8, 32])
@pytest.mark.parametrize("hw", K2_SIZES)
def test_k1_plan_loads_and_stores_each_element_once(hw, b, itemsizes):
    in_itemsize, out_itemsize = itemsizes
    for in_offset, out_offset in ((0, 0), (in_itemsize, out_itemsize), (8, 8),
                                  (16 - in_itemsize, 0)):
        plan = hc.rgb_to_hvi_plan(b, hw, in_itemsize, out_itemsize, out_offset)
        runs, images = plan.grid
        assert images == b and runs * plan.run >= hw > (runs - 1) * plan.run
        # what the C entry demands of a plan
        assert plan.run % plan.vec == 0 and plan.run % 8 == 0
        line_bytes = (3 * plan.run + 16 // in_itemsize) * in_itemsize
        assert plan.smem_bytes == 3 * plan.run * out_itemsize + line_bytes <= hc.RGB_SMEM
        _k1_walk(plan, b, hw, in_itemsize, out_itemsize, in_offset, out_offset)


@pytest.mark.parametrize("in_itemsize,out_itemsize,hw,offset,vec_bytes", [
    (2, 2, 240000, 0, 16), (2, 2, 60, 0, 8), (2, 2, 437, 0, 2), (2, 2, 240000, 2, 2),
    (2, 2, 240000, 4, 4), (2, 2, 240000, 8, 8), (4, 4, 240000, 0, 16), (4, 4, 30, 0, 8),
    (4, 4, 437, 0, 4), (4, 4, 240000, 4, 4), (4, 4, 240000, 8, 8), (4, 2, 240000, 0, 16),
    (4, 2, 437, 0, 2), (2, 4, 240000, 0, 16), (2, 4, 30, 8, 8),
])
def test_k1_plan_takes_the_widest_store_the_pitch_and_base_allow(in_itemsize, out_itemsize, hw,
                                                                 offset, vec_bytes):
    plan = hc.rgb_to_hvi_plan(2, hw, in_itemsize, out_itemsize, offset)
    assert plan.vec * out_itemsize == vec_bytes == _widest(hw, offset, out_itemsize)


@pytest.mark.parametrize("itemsizes", K1_ITEMSIZES, ids=str)
def test_k1_plan_fills_the_card_at_batch_1(itemsizes):
    # one pixel a thread: 938 blocks of 256 threads, over seven per SM
    plan = hc.rgb_to_hvi_plan(1, 400 * 600, *itemsizes)
    assert plan.run == hc.RGB_THREADS and plan.grid[0] >= 7 * hc.SMS
    # batch 8 takes two pixels a thread, batch 32 four
    plan = hc.rgb_to_hvi_plan(8, 400 * 600, *itemsizes)
    assert plan.run == 2 * hc.RGB_THREADS and 8 * plan.grid[0] >= hc.RGB_MIN_BLOCKS
    assert hc.rgb_to_hvi_plan(32, 400 * 600, *itemsizes).run == 4 * hc.RGB_THREADS


def test_k1_plan_is_cached_and_stays_in_the_grid():
    assert hc.rgb_to_hvi_plan(8, 240000, 2, 2) is hc.rgb_to_hvi_plan(8, 240000, 2, 2)
    assert hc.rgb_to_hvi_plan(hc.MAX_GRID_Y, 64, 4, 2).grid[1] == hc.MAX_GRID_Y
    with pytest.raises(ValueError, match="grid"):
        hc.rgb_to_hvi_plan(hc.MAX_GRID_Y + 1, 64, 2, 2)


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


# ---------------------------------------------------------------------------
# K5 (ops/attention_cuda.py:attention_plan) and K6 (ops/norm_cuda.py:
# layer_norm_plan)
# ---------------------------------------------------------------------------

from hvi_cidnet_torch.ops import attention_cuda as ac  # noqa: E402
from hvi_cidnet_torch.ops import norm_cuda as nc  # noqa: E402

# (C, heads, H, W): the LCA levels at 600 x 400 (cp = 18 at each), the same
# C at odd N, C = 192 (the wrapper's maximum) with one and with 8 heads
K5_SITES = [(36, 2, 200, 300), (72, 4, 100, 150), (144, 8, 50, 75), (36, 2, 7, 9),
            (144, 8, 7, 9), (192, 1, 50, 75), (192, 8, 7, 9), (12, 3, 1, 1), (36, 1, 3, 37)]


def _k5_columns(splits, chunk, tile, n):
    """Times each column of one image is visited: block s walks [s * chunk,
    min(n, (s + 1) * chunk)) in steps of ``tile``."""
    seen = np.zeros(n, np.int64)
    for s in range(splits):
        end = min(n, (s + 1) * chunk)
        assert s * chunk < end  # no empty slice
        for n0 in range(s * chunk, end, tile):
            seen[n0:min(end, n0 + tile)] += 1
    return seen


def _k5_entries(plan, c, cp):
    """Times each (row, column) of the score matrix is written by the bf16
    scores pass: block group z, warp j, item slot i take item z * w * ipw +
    j + i * w; an item's tiles cover rows 16 m .. 16 m + 15 and columns 8 t ..
    8 t + 7, of which the block-diagonal entries below C are written."""
    items = ac.score_items(c, cp)
    warps = plan.score_threads // 32
    per_block = warps * plan.items_per_warp
    written = np.zeros((c, c), np.int64)
    for z in range(plan.score_groups):
        for j in range(warps):
            for i in range(plan.items_per_warp):
                idx = z * per_block + j + i * warps
                if j + i * warps >= per_block or idx >= len(items):
                    continue
                m, t0, t1 = items[idx]
                for t in range(t0, t1):
                    for r in range(16 * m, min(c, 16 * m + 16)):
                        for col in range(8 * t, min(c, 8 * t + 8)):
                            if col // cp == r // cp:
                                written[r, col] += 1
    return written


def _k5_apply_outputs(plan, c):
    """Times each (row, column) of one bf16 apply tile is written: warp (m,
    j) writes row tiles [m * mt, (m + 1) * mt) below C16 / 16 and columns
    [32 j, 32 j + 32) (four 8-column tiles, two columns a lane)."""
    c16 = ac.round16(c)
    wn = plan.apply_tile // (8 * ac.APPLY_NT)
    assert plan.apply_threads % (32 * wn) == 0
    written = np.zeros((c16, plan.apply_tile), np.int64)
    for warp in range(plan.apply_threads // 32):
        m, j = divmod(warp, wn)
        for mi in range(m * plan.apply_mt, min(c16 // 16, (m + 1) * plan.apply_mt)):
            written[16 * mi:16 * mi + 16, 32 * j:32 * j + 32] += 1
    return written[:c]


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("site", K5_SITES, ids=str)
@pytest.mark.parametrize("direct", [False, True])
def test_k5_plan_covers_each_column_and_entry_once(site, b, itemsize, direct):
    c, heads, h, w = site
    n, cp = h * w, c // heads
    p = ac.attention_plan(b, c, heads, n, itemsize, direct)
    assert p.direct == int(direct and itemsize == 2 and n % 8 == 0)
    assert (_k5_columns(p.splits, p.chunk, p.score_tile, n) == 1).all()
    assert (_k5_columns(p.apply_splits, p.apply_chunk, p.apply_tile, n) == 1).all()
    assert p.part_stride == c * cp + 2 * c
    assert p.a_offset % 256 == 0 and p.a_offset >= 4 * b * p.splits * p.part_stride
    a_bytes = 4 * c * c if itemsize == 4 else 2 * ac.round16(c) * (ac.round16(c) + 8)
    assert p.scratch_bytes == p.a_offset + b * a_bytes
    if itemsize == 2:
        assert p.chunk % 8 == 0 and p.apply_chunk % 8 == 0  # 16-byte chunks per row
        want = np.equal.outer(np.arange(c) // cp, np.arange(c) // cp).astype(np.int64)
        assert (_k5_entries(p, c, cp) == want).all()
        # no block group without an item
        assert (p.score_groups - 1) * (p.score_threads // 32) * p.items_per_warp < len(
            ac.score_items(c, cp))
        assert (_k5_apply_outputs(p, c) == 1).all()
        assert p.score_smem == ac.scores_smem(c, p.score_tile, p.direct)
        assert p.apply_smem == ac.apply_smem(c, p.apply_tile)
        # every norm item has a slot: 2 C16 / 16 <= kNormSlots x warps
        assert 2 * ac.round16(c) // 16 <= ac.NORM_SLOTS * p.score_threads // 32
    else:
        assert p.score_tile == ac.F32_SCORE_TILE and p.apply_tile == ac.F32_APPLY_TILE


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("c,heads", [(36, 2), (72, 4), (144, 8), (192, 1), (192, 8), (192, 192),
                                     (180, 10), (1, 1)])
def test_k5_plan_fits_shared_memory_and_the_grid(c, heads, itemsize):
    for (b, n), direct in itertools.product(
            [(1, 1), (1, 3750), (8, 60000), (128, 60000), (65535, 9)], [False, True]):
        p = ac.attention_plan(b, c, heads, n, itemsize, direct)
        for smem in (p.score_smem, p.apply_smem, p.rows_smem):
            assert smem <= ac.SMEM_LIMIT
        assert p.splits <= ac.MAX_GRID_X and p.apply_splits <= ac.MAX_GRID_X
        assert p.score_groups <= ac.MAX_GRID_YZ and heads <= ac.MAX_GRID_YZ
        assert 32 <= p.score_threads <= ac.MAX_THREADS and p.score_threads % 32 == 0
        assert 32 <= p.apply_threads <= ac.MAX_THREADS and p.apply_threads % 32 == 0
    if itemsize == 2 and c <= 72:  # two scores blocks share an SM, aligned or not
        assert 2 * (ac.scores_smem(c, 32, False) + ac.SMEM_PER_BLOCK) <= ac.SMEM_SM
    with pytest.raises(ValueError, match="grid"):
        ac.attention_plan(65536, c, heads, 9, itemsize)


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("site", K5_SITES[:3], ids=str)
def test_k5_plan_fills_the_card_at_batch_1(site, itemsize):
    c, heads, h, w = site
    n = h * w
    # as the forward runs it: fresh (aligned) tensors, direct where n % 8 == 0
    p = ac.attention_plan(1, c, heads, n, itemsize, n % 8 == 0)
    # as many blocks as there are SMs, or one for every 32 columns
    assert p.splits * p.score_groups >= min(ac.SMS, -(-n // 32))
    if itemsize == 2:
        assert p.apply_splits >= min(ac.SMS, -(-n // 32))
        # realigned (one 512-thread block an SM): one wave over 3/4 of the SMs
        p = ac.attention_plan(1, c, heads, n, itemsize, False)
        assert 3 * ac.SMS // 4 <= p.splits * p.score_groups <= ac.SMS
    # batch 8: one wave of long-lived scores blocks over at least 3/4 of the
    # SMs (whole tiles per image set the granularity)
    p8 = ac.attention_plan(8, c, heads, n, itemsize, n % 8 == 0)
    if itemsize == 2:
        per_sm = ac._blocks_per_sm(p8.score_smem, p8.score_threads)
        assert 3 * ac.SMS // 4 <= 8 * p8.splits * p8.score_groups <= ac.SMS * per_sm


def test_k5_plan_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="C <= 192"):
        ac.attention_plan(1, 200, 1, 64, 2)
    with pytest.raises(ValueError, match="divisible"):
        ac.attention_plan(1, 36, 5, 64, 2)


# (b, C, H, W) of the LayerNorm sites at 600 x 400, odd N, C = 256
K6_SITES = [(36, 200, 300), (72, 100, 150), (144, 50, 75), (36, 7, 9), (144, 7, 9), (256, 50, 75),
            (256, 1, 1), (5, 1, 1), (192, 3, 130)]


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("site", K6_SITES, ids=str)
def test_k6_plan_covers_each_pixel_and_channel_once(site, b, itemsize):
    c, h, w = site
    hw = h * w
    p = nc.layer_norm_plan(b, c, hw, itemsize)
    pixels = p.lanes * p.vec
    assert hw % p.vec == 0 and p.tiles == -(-hw // pixels) and p.blocks == b * p.tiles
    seen = np.zeros(hw, np.int64)
    for t in range(p.tiles):
        for lane in range(p.lanes):
            p0 = t * pixels + lane * p.vec
            if p0 < hw:
                seen[p0:p0 + p.vec] += 1
    assert (seen == 1).all()
    chans = np.zeros(c, np.int64)
    for g in range(p.groups):
        for i in range(p.channels_per_thread):
            if g + i * p.groups < c:
                chans[g + i * p.groups] += 1
    assert (chans == 1).all()
    assert p.threads == p.lanes * p.groups and p.threads % 32 == 0 and p.threads <= nc.MAX_THREADS
    assert p.channels_per_thread in nc.CHANNELS_PER_THREAD
    assert p.smem_bytes == (2 * p.groups * pixels + 2 * pixels) * 4 <= ac.SMEM_LIMIT


@pytest.mark.parametrize("itemsize,hw,address,vec", [
    (2, 60000, 0, 4), (2, 15000, 0, 4), (2, 3750, 0, 2), (4, 3750, 0, 2), (4, 15000, 0, 2),
    (2, 63, 0, 1), (2, 60000, 2, 1), (2, 60000, 4, 2), (4, 60000, 8, 2), (2, 60000, 0, 4),
])
def test_k6_plan_takes_the_widest_load_the_pitch_and_base_allow(itemsize, hw, address, vec):
    p = nc.layer_norm_plan(8, 36, hw, itemsize, address)
    assert p.vec == vec
    assert p.vec * itemsize <= nc.LOAD_BYTES and address % (p.vec * itemsize) == 0


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("site", K6_SITES[:3], ids=str)
def test_k6_plan_fills_the_card_at_batch_1(site, itemsize):
    c, h, w = site
    p = nc.layer_norm_plan(1, c, h * w, itemsize)
    assert p.blocks >= nc.SMS
    # a warp reads at least one 32-byte sector of each channel row
    assert p.lanes * p.vec * itemsize >= nc.MIN_ROW_BYTES


def test_k6_plan_grid_stays_in_limits():
    assert nc.layer_norm_plan(128, 36, 400 * 600, 2).blocks <= nc.MAX_GRID_X
    with pytest.raises(ValueError, match="grid"):
        nc.layer_norm_plan(2**20, 8, 2**22, 4)
    with pytest.raises(ValueError, match="C must be"):
        nc.layer_norm_plan(1, 257, 64, 2)


# ---------------------------------------------------------------------------
# the fused block route: P2/P3, P4, P5
# ---------------------------------------------------------------------------

# (C, h, w) of the LCA levels at 600 x 400 and 1280 x 720, and odd ones
LN_IEL_SITES = [(36, 200, 300), (72, 100, 150), (144, 50, 75), (36, 360, 640), (144, 90, 160),
                (12, 20, 36), (8, 1, 1), (256, 7, 33), (95, 17, 3)]


def _tiles_cover(n: int, tile: int, tiles: int) -> None:
    """Tiles [t * tile, (t + 1) * tile) for t < tiles cover [0, n) once, none
    of them empty."""
    seen = np.zeros(n, np.int64)
    for t in range(tiles):
        assert t * tile < n
        seen[t * tile:(t + 1) * tile] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("site", LN_IEL_SITES, ids=str)
def test_p23_plan_covers_each_pixel_once(site, b):
    c, h, w = site
    p = lc.ln_iel_plan(b, c, h, w)
    _tiles_cover(h, p.tile_h, p.tiles_y)
    _tiles_cover(w, lc.TILE_W, p.tiles_x)
    assert p.blocks == b * p.tiles_y * p.tiles_x <= lc.MAX_GRID_X
    # the project_out step gives each thread one pixel of the tile
    assert lc.THREADS % (p.tile_h * lc.TILE_W) == 0
    assert p.smem_bytes == lc.ln_iel_smem_bytes(c, p.tile_h) <= lc.SMEM_LIMIT
    # the tallest tile that fits
    taller = [t for t in lc.TILE_HEIGHTS if t > p.tile_h]
    assert all(lc.ln_iel_smem_bytes(c, t) > lc.SMEM_LIMIT for t in taller)


def test_p23_plan_tiles_of_the_forward():
    """8-row tiles at C = 36 and 72, 4-row at 144: C = 144's 8-row tile
    would take 289 KB, past a block's 227 KB."""
    assert [lc.ln_iel_plan(8, c, 50, 75).tile_h for c in (36, 72, 144)] == [8, 8, 4]
    assert lc.ln_iel_smem_bytes(144, 8) > lc.SMEM_LIMIT >= lc.ln_iel_smem_bytes(144, 4)
    with pytest.raises(ValueError, match="shared memory"):
        lc.ln_iel_plan(1, 400, 8, 8)
    with pytest.raises(ValueError, match="grid"):
        lc.ln_iel_plan(2**16, 8, 2**12, 2**12)


# (C_in, C_out, h, w) of the forward's P4 sites at 600 x 400 (stems, heads,
# NormUpsample's folded convs), of P5's (NormDownsample), and odd ones
P4_SITES = [(3, 36, 400, 600), (1, 36, 400, 600), (36, 2, 400, 600), (36, 1, 400, 600),
            (144, 72, 50, 75), (72, 36, 100, 150), (36, 36, 200, 300), (12, 8, 20, 36),
            (5, 13, 1, 1), (7, 25, 9, 33)]
P5_SITES = [(36, 36, 400, 600), (36, 72, 200, 300), (72, 144, 100, 150), (12, 8, 20, 36),
            (8, 16, 2, 2), (3, 5, 7, 9), (8, 16, 16, 24)]


def _check_conv_plan(p, b, cout, oh, ow) -> None:
    _tiles_cover(oh, p.tile_h, p.tiles_y)
    _tiles_cover(ow, p.tile_w, p.tiles_x)
    _tiles_cover(cout, p.co_tile, p.groups)
    assert p.co_tile in cc.CO_TILES
    # no other instantiation leaves fewer channels idle
    idle = lambda t: -(-cout // t) * t - cout
    assert idle(p.co_tile) == min(idle(t) for t in cc.CO_TILES)
    assert p.blocks == b * p.groups * p.tiles_y * p.tiles_x <= cc.MAX_GRID_X
    assert p.conv_pixels <= cc.THREADS  # one conv output a thread
    assert p.smem_bytes <= 48 * 1024  # static shared memory


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("site", P4_SITES, ids=str)
def test_p4_plan_covers_each_output_once(site, b):
    _, cout, h, w = site
    p = cc.conv3x3_plan(b, cout, h, w)
    _check_conv_plan(p, b, cout, h, w)
    assert (p.tile_h, p.tile_w) == cc.TILE and p.conv_pixels == p.tile_h * p.tile_w


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("site", P5_SITES, ids=str)
def test_p5_plan_covers_each_output_once(site, b):
    """Each half-size output (i, j) reads conv rows 2i .. 2i + 2 and columns
    2j .. 2j + 2; a tile's conv rectangle holds them for its whole tile."""
    _, cout, h, w = site
    p = cc.half_plan(b, cout, h, w)
    _check_conv_plan(p, b, cout, h // 2, w // 2)
    assert (p.tile_h, p.tile_w) == cc.HALF_TILE
    assert p.conv_pixels == (2 * p.tile_h + 1) * (2 * p.tile_w + 1)
    for ty in range(p.tiles_y):
        rows = range(2 * ty * p.tile_h, 2 * ty * p.tile_h + 2 * p.tile_h + 1)
        for i in range(ty * p.tile_h, min(h // 2, (ty + 1) * p.tile_h)):
            assert {2 * i, 2 * i + 1, 2 * i + 2} <= set(rows)


def test_conv_plans_pick_the_narrow_tile_for_the_heads():
    assert [cc.conv3x3_plan(8, c, 400, 600).co_tile for c in (1, 2, 36, 72)] == [4, 4, 12, 12]
    with pytest.raises(ValueError, match="grid"):
        cc.conv3x3_plan(2**20, 144, 2**10, 2**10)


# ---------------------------------------------------------------------------
# the probe route: the score core of P1 and P10/P15, and P6
# ---------------------------------------------------------------------------

from hvi_cidnet_torch.ops import batched_qk_cuda as bq  # noqa: E402
from hvi_cidnet_torch.ops import head_attention_cuda as ha  # noqa: E402
from hvi_cidnet_torch.ops import im2col_cuda as icol  # noqa: E402

# (c, heads, N) of the attention sites at 600 x 400 (c = C / heads = 18 at
# every level) and at 1280 x 720 level 1, and odd ones
HEAD_SITES = [(18, 2, 60000), (18, 4, 15000), (18, 8, 3750), (18, 2, 230400), (4, 2, 96),
              (1, 1, 1), (32, 1, 129), (5, 3, 300), (20, 1, 127)]
BATCHES = [1, 8, 32]


def _score_plans(b, site):
    c, heads, n = site
    g = b * heads
    return g, c, n, (bq.qk_plan(g, c, n), ha.head_attention_plan(g, c, n))


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("site", HEAD_SITES, ids=str)
def test_score_core_plan_covers_each_column_and_entry_once(site, b):
    g, c, n, plans = _score_plans(b, site)
    for p in plans:
        # one cluster of `splits` blocks per g, each a chunk of whole tiles, none empty
        assert 1 <= p.splits <= bq.MAX_CLUSTER and p.blocks == p.splits * g <= bq.MAX_GRID_Y * 8
        assert p.chunk % bq.TILE == 0
        _tiles_cover(n, p.chunk, p.splits)
        # every entry of the c x c matrix in one thread's 3 x 3 tile, the
        # tiles side by side in `slices` column slices within the block
        assert (p.side_tiles - 1) * bq.RT < c <= p.side_tiles * bq.RT
        assert p.slices * p.side_tiles**2 <= bq.THREADS < (p.slices + 1) * p.side_tiles**2
        cols = np.zeros(bq.TILE, np.int64)
        for s in range(p.slices):
            cols[s::p.slices] += 1
        assert (cols == 1).all()
    # P10/P15: block r of the cluster writes entries [r * per, (r + 1) * per)
    per = -(-c * c // plans[0].splits)
    seen = np.zeros(c * c, np.int64)
    for r in range(plans[0].splits):
        seen[r * per:(r + 1) * per] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("site", HEAD_SITES, ids=str)
def test_score_core_plan_shared_memory(site, itemsize):
    c, heads, n = site
    qk = bq.qk_plan(8 * heads, c, n, itemsize)
    p1 = ha.head_attention_plan(8 * heads, c, n, itemsize)
    rows = 3 * qk.side_tiles
    # q and k in the input's type, rows 16 bytes past TILE wide (16-byte stores)
    tiles = 2 * rows * (bq.TILE * itemsize + 16)
    assert bq.pitch(itemsize) * itemsize % 16 == 0
    assert qk.smem_bytes == tiles + 4 * (qk.slices + 1) * c * c <= bq.SMEM_LIMIT
    e = c * c + 2 * c  # P1: the scores and both norms; the cluster's sums; A^T from 16 bytes
    a_at = ha.at_offset(c, itemsize)
    assert a_at % 16 == 0 and 0 <= a_at - (tiles + 4 * (p1.slices + 2) * e) < 16
    assert p1.cm == bq.c_max(c) >= c and p1.cm % 4 == 0
    assert p1.smem_bytes == a_at + 4 * c * p1.cm <= bq.SMEM_LIMIT


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n, elements", [(60000, 0), (15000, 0), (3750, 0), (63, 0), (264, 1),
                                         (264, 2), (264, 4)])
def test_score_core_plan_takes_the_widest_load_n_and_the_bases_allow(itemsize, n, elements):
    """16 bytes' worth of elements, else 2, else 1 (the kernels'
    instantiations); ``elements``: the bases' start past a 16-byte
    boundary."""
    offset = elements * itemsize % 16
    for p in (bq.qk_plan(8, 18, n, itemsize, offset), ha.head_attention_plan(8, 18, n, itemsize,
                                                                             offset)):
        assert p.vec in (16 // itemsize, 2, 1)
        assert n % p.vec == 0 and offset % (p.vec * itemsize) == 0
        wider = [v for v in (16 // itemsize, 2) if v > p.vec]
        assert all(n % v or offset % (v * itemsize) for v in wider)


def test_score_core_plan_of_the_forward():
    """c = 18 at every site; the clusters fill the card as far as 8 blocks
    a g allow: 128, 256, 320 blocks at batch 8 (levels 1-3), 16, 32, 64 at
    batch 1."""
    got = {b: [bq.qk_plan(b * h, 18, n).splits for _, h, n in HEAD_SITES[:3]] for b in BATCHES}
    assert got == {1: [8, 8, 8], 8: [8, 8, 5], 32: [5, 3, 2]}
    assert [ha.head_attention_plan(8 * h, 18, n).blocks for _, h, n in HEAD_SITES[:3]] == \
        [128, 256, 320]
    # the forward's sites (c = 18, bf16) need no more than the default 48 KB
    assert ha.head_attention_plan(16, 18, 60000).smem_bytes < 48 * 1024
    assert bq.qk_plan(16, 18, 60000).smem_bytes < 48 * 1024
    # bf16 rows of 60,000 and 15,000 take 16-byte loads, of 3,750 4-byte ones
    assert [bq.qk_plan(8, 18, n).vec for _, _, n in HEAD_SITES[:3]] == [8, 8, 2]
    with pytest.raises(ValueError, match="c <= 32"):
        bq.qk_plan(8, 33, 100)
    with pytest.raises(ValueError, match="grid"):
        ha.head_attention_plan(65536, 18, 100)


# (C_in, C_out, h, w) of P6's sites at 600 x 400: the stems and heads, the
# NormUpsamples' folded convs, the NormDownsamples; and odd ones
P6_SITES = [(3, 36, 400, 600), (1, 36, 400, 600), (36, 2, 400, 600), (36, 1, 400, 600),
            (144, 72, 50, 75), (72, 36, 100, 150), (36, 36, 200, 300), (36, 36, 400, 600),
            (36, 72, 200, 300), (72, 144, 100, 150), (5, 13, 1, 1), (3, 36, 19, 37),
            (144, 144, 7, 9), (8, 17, 16, 16)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("site", P6_SITES, ids=str)
def test_p6_plan_covers_each_output_once(site, b, itemsize):
    cin, cout, h, w = site
    k, n = 9 * cin, h * w
    p = icol.im2col_plan(b, cout, k, n, itemsize)
    _tiles_cover(n, icol.N_TILE, p.n_tiles)
    assert p.blocks == p.n_tiles * b and b <= icol.MAX_GRID_Y and p.n_tiles <= icol.MAX_GRID_X
    # C_out padded to 16-row tiles, K to whole steps, with zero weights
    assert (p.m_tiles - 1) * 16 < cout <= p.m_tiles * 16 <= icol.MAX_COUT
    assert p.k_step == icol.K_STEP[itemsize] and (p.k_steps - 1) * p.k_step < k <= p.k_steps * p.k_step
    # each thread loads whole vectors of each step's tile
    assert (p.k_step * icol.N_TILE // p.vec) % icol.THREADS == 0
    assert p.smem_bytes == icol.smem_bytes(itemsize, p.m_tiles) <= 48 * 1024


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("n, elements", [(240000, 0), (60000, 0), (15000, 0), (3750, 0), (703, 0),
                                         (264, 1), (264, 2), (264, 4), (1, 0)])
def test_p6_plan_takes_the_widest_load_n_and_the_start_allow(itemsize, n, elements):
    """``elements``: the operand's start, in elements past a 16-byte boundary."""
    offset = elements * itemsize % 16
    vec = icol.im2col_plan(1, 36, 27, n, itemsize, offset).vec
    assert vec * itemsize <= 16 and n % vec == 0 and offset % (vec * itemsize) == 0
    wider = 2 * vec
    assert wider * itemsize > 16 or n % wider or offset % (wider * itemsize)


def test_p6_plan_of_the_forward():
    """bf16: 16-byte loads at N = 240,000, 60,000, 15,000, 4-byte at 3,750;
    C_out 1, 2, 36, 72, 144 in 1, 1, 3, 5, 9 tiles; K 9 and 27 in one step."""
    assert [icol.im2col_plan(8, 36, 27, n, 2).vec for n in (240000, 60000, 15000, 3750)] == \
        [8, 8, 8, 2]
    assert [icol.im2col_plan(8, c, 324, 3750, 2).m_tiles for c in (1, 2, 36, 72, 144)] == \
        [1, 1, 3, 5, 9]
    assert [icol.im2col_plan(8, 36, k, 3750, 2).k_steps for k in (9, 27, 324, 1296)] == \
        [1, 1, 6, 21]
    with pytest.raises(ValueError, match="C_out <= 144"):
        icol.im2col_plan(1, 145, 27, 100, 2)
    with pytest.raises(ValueError, match="grid"):
        icol.im2col_plan(65536, 36, 27, 100, 2)


# ---------------------------------------------------------------------------
# P7, P8/P9/P11, P12/P13, P14: the relayout (ops/relayout_cuda.py)
# ---------------------------------------------------------------------------


def _relayout_walk(p, itemsize, in_offset=0, out_offset=0):
    """The output of csrc/relayout.cu under plan ``p`` on the input 0, 1, 2,
    ..., walked thread by thread as the kernel's loops run, and the times
    each output element is written. Checks on the way: every global vector
    starts aligned to its width, a shared vector store too, and the store
    side reads only what the same work item's load side wrote."""
    g, x, m, y = p.g, p.x, p.m, p.y
    n = g * x * m * y
    out, writes = np.full(n, -1, np.int64), np.zeros(n, np.int64)
    threads = rl.THREADS
    if p.copy:
        v, stride = p.vi, p.blocks * threads * p.vi
        for t in range(p.blocks * threads):
            for i in range(t * v, n, stride):
                assert (i * itemsize + in_offset) % (v * itemsize) == 0
                assert (i * itemsize + out_offset) % (v * itemsize) == 0
                out[i:i + v] = np.arange(i, i + v)
                writes[i:i + v] += 1
        return out, writes
    groups = -(-g * m // p.slabs)
    for w in range(p.work):  # block b takes items b, b + blocks, ...: each once
        tile_i, grp = divmod(w, groups)
        gm = grp * p.slabs
        gg, mm = divmod(gm, m)
        tx_i, ty_i = divmod(tile_i, p.tiles_y)
        x0, y0 = tx_i * p.tx, ty_i * p.ty
        nx, ny = min(p.tx, x - x0), min(p.ty, y - y0)
        ns = min(p.slabs, g * m - gm)
        smem = np.full(p.tx * p.pitch, -1, np.int64)
        src0 = ((gg * x + x0) * m + mm) * y + y0
        for t in range(threads):
            l_col, l_row = t % p.lx, t // p.lx
            for r in range(l_row, ns * nx, threads // p.lx):
                sl, xr = divmod(r, nx)
                for v in range(l_col * p.vi, ny, p.lx * p.vi):
                    a = src0 + r * m * y + v
                    assert (a * itemsize + in_offset) % (p.vi * itemsize) == 0
                    s = xr * p.pitch + sl * ny + v
                    assert p.pitch % p.vi or s % p.vi == 0  # a shared vector store
                    smem[s:s + p.vi] = np.arange(a, a + p.vi)
        dst0 = ((gg * y + y0) * m + mm) * x + x0
        for t in range(threads):
            s_col, s_row = t % p.sx, t // p.sx
            for r in range(s_row, ns * ny, threads // p.sx):
                for v in range(s_col * p.vo, nx, p.sx * p.vo):
                    vals = smem[(v + np.arange(p.vo)) * p.pitch + r]
                    assert (vals >= 0).all(), "read a shared element this item did not load"
                    d = dst0 + r * m * x + v
                    assert (d * itemsize + out_offset) % (p.vo * itemsize) == 0
                    out[d:d + p.vo] = vals
                    writes[d:d + p.vo] += 1
    return out, writes


# (G, X, M, Y): the relayouts' mappings at small and odd sizes (P8, P12,
# P7 steps 1, P11, slabs of 36 x 8 and 5 x 3 several to a work item, the
# last one cut, the HWCB entry and exit at batch 3), Y = 1 and X = 1
# (unit axes dropped: a copy, or a transpose of X or Y with M), both axes
# long (64 x 64 tiles cut at the edges), tiles cut along one long axis
RELAYOUT_SHAPES = [(1, 24, 4, 8), (3, 6, 4, 8), (1, 21, 3, 5), (7, 3, 1, 5), (1, 5, 3, 21),
                   (40, 36, 1, 8), (300, 5, 1, 3),
                   (1, 300, 1, 3), (1, 3, 1, 300), (1, 100, 1, 1), (2, 1, 1, 7), (1, 1, 3, 50),
                   (1, 40, 3, 1), (1, 130, 2, 70), (1, 4100, 1, 2), (1, 2, 1, 4100),
                   (1, 17, 5, 33), (2, 96, 1, 64)]


@pytest.mark.parametrize("offsets", [(0, 0), (2, 0), (0, 1)], ids=["aligned", "in+2", "out+1"])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", RELAYOUT_SHAPES, ids=str)
def test_relayout_plan_covers_each_output_once(shape, itemsize, offsets):
    """``offsets``: the input's and the output's starts, in elements past a
    16-byte boundary."""
    in_off, out_off = (e * itemsize % 16 for e in offsets)
    p = rl.relayout_plan(*shape, itemsize, in_off, out_off)
    out, writes = _relayout_walk(p, itemsize, in_off, out_off)
    g, x, m, y = shape
    want = np.arange(g * x * m * y).reshape(g, x, m, y).transpose(0, 3, 2, 1).ravel()
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, want)
    assert p.smem_bytes <= rl.SMEM_LIMIT and 1 <= p.blocks <= rl.SMS * rl.BLOCKS_PER_SM


@pytest.mark.parametrize("name, shape, kw", [
    ("P7", (24, 4, 8), {"steps": 0}), ("P7", (24, 4, 8), {"steps": 1}),
    ("P7", (24, 4, 8), {"steps": 2}), ("P7", (21, 3, 5), {"steps": 3}),
    ("P8", (21, 3, 5), {}), ("P9", (24, 4, 8), {}), ("P11", (5, 3, 21), {}),
    ("P12", (24, 4, 8), {"n_blk": 6}), ("P13", (21, 3, 5), {"n_blk": 7}),
    ("P14", (24, 4, 8), {"n_blk": 6}), ("P14", (24, 3, 5), {"n_blk": 24})], ids=str)
def test_relayout_geometry_is_each_p(name, shape, kw):
    """Each P's mapping onto (G, X, M, Y): the input viewed as (G, X, M, Y)
    and transposed to (G, Y, M, X) is its plain version's output; so is its
    canonical form's."""
    import torch

    from hvi_cidnet_torch.ops import relayout as plain

    x = np.arange(int(np.prod(shape))).reshape(shape)
    gxmy, out_shape = rl.geometry(name, shape, **kw)
    fn = {"P7": lambda t: plain.transpose_steps(t, None, kw["steps"]), "P8": plain.relayout_t3,
          "P9": plain.relayout_t2, "P11": plain.relayout_t2_rev,
          "P12": lambda t: plain.t3_blocked(t, kw["n_blk"]),
          "P13": lambda t: plain.t2_blocked(t, kw["n_blk"]),
          "P14": lambda t: plain.pack_blocked(t, kw["n_blk"])}[name]
    ref = fn(torch.from_numpy(x)).numpy()
    assert ref.shape == tuple(out_shape)
    for dims in (gxmy, rl.canonical(*gxmy)):
        got = x.reshape(dims).transpose(0, 3, 2, 1).reshape(out_shape)
        np.testing.assert_array_equal(got, ref)


# (G, X, M, Y) of the relayouts the main path and chip_smoke run, at 600 x
# 400: the HWCB entry (P14, one block) and exit (P11 on NHWC) at batch 1,
# 8 and 32, TNSM's noise map (P11), and P8 at the three LCA levels
def _main_path_relayouts():
    hw = 400 * 600
    for b in (1, 8, 32):
        yield "entry", b, rl.geometry("P14", (hw, 3, b), n_blk=hw)[0]
        yield "exit", b, rl.geometry("P11", (b, 1, 3 * hw))[0]
        yield "noise", b, rl.geometry("P11", (b, 3, hw))[0]
    for n, c in ((60000, 36), (15000, 72), (3750, 144)):
        for b in (1, 8):
            yield "level", b, rl.geometry("P8", (n, c, b))[0]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("site, b, gxmy", list(_main_path_relayouts()), ids=str)
def test_relayout_plan_of_the_forward(site, b, gxmy, itemsize):
    """At batch 1 the entry and exit are copies (and still launch); else the
    tiles cover each slab once, the vectors are the widest the extents
    allow, the shared tile fits without opting in, the grid fills the card
    and the load side keeps at least half the threads busy."""
    p = rl.relayout_plan(*gxmy, itemsize)
    assert p.copy == (b == 1 and site in ("entry", "exit"))
    assert p.smem_bytes <= rl.SMEM_LIMIT
    if p.copy:
        assert p.vi * itemsize == 16 and p.blocks == min(p.work, rl.SMS * rl.BLOCKS_PER_SM)
        assert p.blocks >= rl.SMS
        return
    assert (p.tiles_x - 1) * p.tx < p.x <= p.tiles_x * p.tx
    assert (p.tiles_y - 1) * p.ty < p.y <= p.tiles_y * p.ty
    assert p.work == p.g * p.m * p.tiles_x * p.tiles_y
    assert p.blocks == min(p.work, rl.SMS * rl.BLOCKS_PER_SM) >= rl.SMS
    assert p.ty % p.vi == 0 and p.tx % p.vo == 0 and p.pitch >= p.ty
    widest = lambda n: next(v for v in (8, 4, 2, 1) if v * itemsize <= 16 and n % v == 0)
    assert (p.vi, p.vo) == (widest(p.y), widest(p.x))
    assert min(p.tx, rl.THREADS // p.lx) * min(p.ty // p.vi, p.lx) >= rl.THREADS // 2


def test_relayout_plan_of_the_hwcb_ends_at_batch_8():
    """bf16, batch 8: the entry's 512 x 8 tiles take a 10-element pitch (a
    load's 16 bytes stored element by element, the columns read without
    conflicts), the exit's 8 x 512 tiles no padding (a load's 16 bytes
    stored whole, the columns read by 32 rows); each side's first warp
    meets no bank conflict."""
    hw = 400 * 600
    entry = rl.relayout_plan(*rl.geometry("P14", (hw, 3, 8), n_blk=hw)[0], 2)
    exit_ = rl.relayout_plan(*rl.geometry("P11", (8, 1, 3 * hw))[0], 2)
    assert (entry.tx, entry.ty, entry.pitch, entry.vi, entry.vo) == (512, 8, 10, 8, 8)
    assert (exit_.tx, exit_.ty, exit_.pitch, exit_.vi, exit_.vo) == (8, 512, 512, 8, 8)
    for p in (entry, exit_):
        _, l_waves, _ = rl.side_cost(p.lx, p.tx, p.vi, p.ty // p.vi, p.m * p.y, 2, p.pitch,
                                     (p.tx, p.ty))
        _, s_waves, _ = rl.side_cost(p.sx, p.ty, p.vo, p.tx // p.vo, p.m * p.x, 2, p.pitch)
        # conflict-free: 32 lanes of 2 bytes a wavefront, or 8 of 16 bytes
        assert (l_waves, s_waves) == (1 / 64 if p.pitch % p.vi == 0 else 1 / 32, 1 / 32)


def test_relayout_plan_is_cached_and_rejects_what_the_kernel_does_not_take():
    rl.relayout_plan.cache_clear()
    rl.relayout_plan(1, 720000, 1, 8, 2)
    rl.relayout_plan(1, 720000, 1, 8, 2)
    assert rl.relayout_plan.cache_info().hits == 1
    with pytest.raises(TypeError, match="2 or 4"):
        rl.relayout_plan(1, 8, 1, 8, 8)
    with pytest.raises(ValueError, match=">= 1"):
        rl.relayout_plan(1, 0, 1, 8, 2)
    # a plan's 64-bit extents: G X M Y past 2**31 elements
    big = rl.relayout_plan(1, 60000 * 36, 1, 1024, 2)
    assert big.g * big.x * big.m * big.y > 2**31 and big.work == big.tiles_x * big.tiles_y
