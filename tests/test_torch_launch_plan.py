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
(``ops/ln_iel_cuda.py:ln_iel_plan`` in fp32; ``ln_iel_mma_plan`` in bf16,
the tensor-core arm: its arms, tiles, the expansion's n8 tiles, the
depthwise phases' strips and column ranges, project_out's warps, shared
memory), P4 (``ops/conv3x3_cuda.py:
conv3x3_plan`` in fp32; ``conv3x3_mma_plan`` in bf16, the tensor-core arm:
its persistent blocks, channel groups, ring and shared memory, the
alignment of every ldmatrix row, and ``mma_replay``, its addressing
replayed on the CPU against the plain conv) and P5 (``ops/conv3x3_cuda.py:
half_plan`` in fp32; ``half_mma_plan`` in bf16: P4's groups, walkers and
ring over tiles whose conv regions hold their outputs' taps, the region's
m16 tiles, the epilogue's passes); and the probe route's: P10/P15 and P1
(``ops/batched_qk_cuda.py:qk_plan`` and ``ops/head_attention_cuda.py:
head_attention_plan`` in fp32, ``mma_plan`` of each in bf16: the cluster
size, the split of N, shared memory; fp32 the entries' threads and the
load width; bf16, the tensor-core arm, its clusters fitted to one wave of
an H100's, ring, stages filled straight or realigned, fragments' entries,
and ``replay_sums`` / ``mma_replay``, its addressing replayed on the CPU
against the plain versions) and P6 (``ops/im2col_cuda.py:
im2col_plan``: the N tail, the C_out and K padding, the load width, the
bf16 arm's persistent blocks, groups and ring, and its stages' layouts
read back as wgmma's canonical ones) at every site shape and at batch 1, 8
and 32.
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


# P4 in bf16: the tensor-core arm (ops/conv3x3_cuda.py:conv3x3_mma_plan). The
# forward's sites, ragged widths (75, 150: tiles past the edge), batch 1,
# C_out 1, 2, 13, 73 and 144 (two groups), C_in past a chunk
P4_MMA_SITES = P4_SITES + [(36, 144, 9, 150), (20, 73, 17, 75), (1, 2, 8, 32), (17, 13, 33, 31)]


def _walks(plan, tiles):
    """The tiles each group's blocks visit, block i walking i // groups,
    i // groups + blocks // groups, ...: a count per (group, tile)."""
    seen = np.zeros((plan.groups, tiles), np.int64)
    walkers = plan.blocks // plan.groups
    for i in range(plan.blocks):
        seen[i % plan.groups, range(i // plan.groups, tiles, walkers)] += 1
    return seen


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("site", P4_MMA_SITES, ids=str)
def test_p4_mma_plan_covers_each_output_once(site, b):
    """Tiles cover rows and columns once; channel groups cover C_out once;
    every group's blocks visit every tile once."""
    cin, cout, h, w = site
    p = cc.conv3x3_mma_plan(b, cin, cout, h, w)
    _tiles_cover(h, p.tile_h, p.tiles_y)
    _tiles_cover(w, p.tile_w, p.tiles_x)
    _tiles_cover(cout, p.co_group, p.groups)
    assert (p.tile_h, p.tile_w) == cc.MMA_TILE
    assert p.co_group <= 8 * p.n_tiles < p.co_group + 8 and p.co_group <= cc.MAX_GROUP
    assert (p.chunks - 1) * cc.CHUNK < cin <= p.chunks * cc.CHUNK
    assert p.blocks % p.groups == 0 and p.groups <= p.blocks
    assert (_walks(p, b * p.tiles_y * p.tiles_x) == 1).all()
    assert p.pack_elements == p.groups * p.chunks * 9 * 8 * p.n_tiles * cc.ROW
    # the output's stores: whole vectors of a plane's rows (the width's)
    assert w % p.vec == 0 and p.tile_w % p.vec == 0 and p.vec in (1, 2, 4, 8)


def test_p4_mma_plan_splits_wide_outputs_into_groups():
    """C_out <= 72 in one block; more in groups of equal size."""
    got = {c: (cc.conv3x3_mma_plan(8, 36, c, 50, 75).groups,
               cc.conv3x3_mma_plan(8, 36, c, 50, 75).co_group) for c in (1, 2, 36, 72, 73, 144)}
    assert got == {1: (1, 1), 2: (1, 2), 36: (1, 36), 72: (1, 72), 73: (2, 37), 144: (2, 72)}
    with pytest.raises(ValueError, match="grid"):
        cc.conv3x3_mma_plan(2**20, 36, 36, 2**10, 2**10)


@pytest.mark.parametrize("site", P4_MMA_SITES, ids=str)
def test_p4_mma_plan_shared_memory_and_ring(site):
    """Dynamic shared memory within a block's 227 KB, and blocks_per_sm
    blocks within an SM's 228 KB (1 KB reserved a block); at least three
    stages; every chunk's weights resident when they fit beside three
    stages on the plan's blocks per SM, else one chunk a stage."""
    cin, cout, h, w = site
    p = cc.conv3x3_mma_plan(8, cin, cout, h, w)
    assert cc.MIN_STAGES <= p.stages <= cc.MAX_STAGES
    assert p.smem_bytes == cc.mma_smem_bytes(p.n_tiles, p.stages,
                                             p.chunks if p.resident else p.stages)
    assert p.smem_bytes <= cc.SMEM_LIMIT
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= cc.SM_SMEM
    assert p.blocks_per_sm in (1, 2)
    budget = min(cc.SMEM_LIMIT, cc.SM_SMEM // p.blocks_per_sm - 1024)
    if not p.resident:  # all chunks beside three stages would not fit
        assert cc.mma_smem_bytes(p.n_tiles, cc.MIN_STAGES, p.chunks) > budget
    # a deeper ring would not fit
    if p.stages < cc.MAX_STAGES:
        slots = p.chunks if p.resident else p.stages + 1
        assert cc.mma_smem_bytes(p.n_tiles, p.stages + 1, slots) > budget


def test_p4_mma_plan_of_the_forward():
    """Stems and heads two blocks an SM with the weights resident; up1 and
    up2 likewise; up3 (72 channels, 9 chunks) one block with a chunk a
    stage."""
    got = [(p.blocks_per_sm, p.resident, p.n_tiles) for p in
           (cc.conv3x3_mma_plan(8, ci, co, h, w) for ci, co, h, w in P4_SITES[:7])]
    assert got == [(2, True, 5), (2, True, 5), (2, True, 1), (2, True, 1), (1, False, 9),
                   (2, False, 5), (2, True, 5)]


def test_p4_mma_rows_start_16_byte_aligned_and_conflict_free():
    """Every ldmatrix row (A's halo pixels, a tap's weights) and every
    16-byte store of the staging pass starts on a 16-byte boundary, and the
    8 rows one ldmatrix phase reads, at any start, fall on 8 distinct
    16-byte bank groups of a 128-byte line."""
    th, tw = cc.MMA_TILE
    halo = (th + 2) * (tw + 2)
    for rows in (halo, 8 * cc.MAX_GROUP):
        offsets = {2 * cc.swz(r, h) for r in range(rows) for h in (0, 1)}
        assert all(o % 16 == 0 for o in offsets)
        assert len(offsets) == 2 * rows  # a bijection: no two halves share a slot
        for start in range(rows - 7):
            for h in (0, 1):
                assert len({(2 * cc.swz(start + i, h)) % 128 // 16 for i in range(8)}) == 8
    # the staged rows: whole 16-byte granules
    assert 8 * cc.RAW_GRANULES * 2 % 16 == 0 and (tw + 2) * 2 + 14 <= 16 * cc.RAW_GRANULES


def test_p4_bf16_arm_of_each_site():
    """The heads (C_out <= 2) on the CUDA cores, every other site on the
    tensor cores."""
    assert [cc.uses_small_arm(ci, co) for ci, co, _, _ in P4_SITES[:7]] == \
        [False, False, True, True, False, False, False]
    with pytest.raises(ValueError, match="C_out 1 or 2"):
        cc.conv3x3_small_plan(8, 36, 3, 40, 40)


# the CUDA-core arm's sites: the heads at 600 x 400 and 1280 x 720, ragged
# widths, C_in below, at and past a chunk
P4_SMALL_SITES = [(36, 2, 400, 600), (36, 1, 400, 600), (36, 2, 720, 1280), (36, 1, 13, 75),
                  (144, 2, 9, 150), (3, 1, 17, 37), (16, 2, 8, 32), (5, 1, 1, 1)]


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("site", P4_SMALL_SITES, ids=str)
def test_p4_small_plan_covers_each_output_once(site, b):
    """Tiles cover rows and columns once, the blocks visit every tile once,
    the threads' 2 x 2 pixel blocks cover a tile once (each in the four
    parts of the input channels); shared memory within its limits."""
    cin, cout, h, w = site
    p = cc.conv3x3_small_plan(b, cin, cout, h, w)
    _tiles_cover(h, p.tile_h, p.tiles_y)
    _tiles_cover(w, p.tile_w, p.tiles_x)
    assert (p.tile_h, p.tile_w) == cc.MMA_TILE
    assert (p.chunks - 1) * cc.CHUNK < cin <= p.chunks * cc.CHUNK
    seen = np.zeros(b * p.tiles_y * p.tiles_x, np.int64)
    for i in range(p.blocks):
        seen[i::p.blocks] += 1
    assert (seen == 1).all()
    pixels = np.zeros((cc.SMALL_PARTS,) + cc.MMA_TILE, np.int64)
    for t in range(cc.SMALL_THREADS):
        part, q = divmod(t, 64)
        r, c = 2 * (q // 16), 2 * (q % 16)
        pixels[part, r:r + 2, c:c + 2] += 1
    assert (pixels == 1).all() and cc.SMALL_THREADS == 64 * cc.SMALL_PARTS
    assert cc.MIN_STAGES <= p.stages <= cc.MAX_STAGES
    assert p.smem_bytes == cc.small_smem_bytes(cout, p.chunks, p.stages) <= cc.SMEM_LIMIT
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= cc.SM_SMEM
    if p.stages < cc.MAX_STAGES:  # a deeper ring would not fit on as many blocks an SM
        assert p.blocks_per_sm * (cc.small_smem_bytes(cout, p.chunks, p.stages + 1) + 1024) > \
            cc.SM_SMEM


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("pad", ["zero", "edge"])
@pytest.mark.parametrize("case", [((1, 18, 9, 37), 2), ((1, 20, 9, 75), 1), ((1, 3, 8, 40), 2),
                                  ((1, 5, 1, 1), 1)], ids=str)
def test_p4_small_replay_equals_the_plain_conv(case, pad, offset):
    """The CUDA-core arm's addressing replayed on the CPU (the staged rows'
    granules at the tensor's own offset, each 2 x 2 block's 4 x 4 window,
    clamped or zeroed) equals ``conv3x3_plain`` within 1e-6, in float64;
    every output written once."""
    import torch

    shape, cout = case
    g = torch.Generator().manual_seed(sum(shape) + cout)
    x = torch.rand(shape, generator=g, dtype=torch.float64) * 2 - 1
    w = (torch.rand((cout, shape[1], 3, 3), generator=g, dtype=torch.float64) - 0.5) * 0.4
    got, writes = cc.small_replay(x, w, pad, offset)
    assert (writes == 1).all()
    assert (got - cc.conv3x3_plain(x, w, pad)).abs().max().item() <= 1e-6


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("pad", ["zero", "edge"])
@pytest.mark.parametrize("case", [((2, 3, 19, 37), 36), ((1, 20, 9, 75), 2), ((1, 17, 8, 33), 73),
                                  ((1, 5, 1, 1), 1), ((1, 36, 10, 40), 13)], ids=str)
def test_p4_mma_replay_equals_the_plain_conv(case, pad, offset):
    """The tensor-core arm's addressing replayed on the CPU (granules of
    the staged rows at the tensor's own offset, the clamped or zeroed halo,
    taps as pixel shifts of the swizzled channel-minor tile, the packed
    weights) equals ``conv3x3_plain`` within 1e-6, in float64; every output
    written once."""
    import torch

    shape, cout = case
    g = torch.Generator().manual_seed(sum(shape) + cout)
    x = (torch.rand(shape, generator=g, dtype=torch.float64) * 2 - 1)
    w = (torch.rand((cout, shape[1], 3, 3), generator=g, dtype=torch.float64) - 0.5) * 0.4
    got, writes = cc.mma_replay(x, w, pad, offset)
    assert (writes == 1).all()
    assert (got - cc.conv3x3_plain(x, w, pad)).abs().max().item() <= 1e-6


# P5 in bf16: the tensor-core arm (ops/conv3x3_cuda.py:half_mma_plan). The
# forward's sites, ragged half-size outputs (rows 100 and 37, columns 75,
# 35 and 17: tiles past the edge), C_out 5, 16, 73 and 144 (two groups)
P5_MMA_SITES = P5_SITES + [(36, 73, 14, 70), (17, 36, 200, 34), (36, 144, 74, 150),
                           (20, 16, 10, 34), (3, 5, 2, 2)]


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("site", P5_MMA_SITES, ids=str)
def test_p5_mma_plan_covers_each_output_once(site, b):
    """Tiles cover the half-size rows and columns once, channel groups C_out
    once, every group's blocks visit every tile once; a tile's conv region
    (7 x 33 from conv row 2 o0, column 2 q0) holds the three rows and
    columns each of its outputs reads; every region pixel lies in one m16
    tile of one warp (256 threads: tiles w and w + 8; 512: tile w); the
    epilogue's passes take every n8 tile once; shared memory fits the
    blocks an SM."""
    cin, cout, h, w = site
    p = cc.half_mma_plan(b, cin, cout, h, w)
    ho, wo = h // 2, w // 2
    _tiles_cover(ho, p.tile_h, p.tiles_y)
    _tiles_cover(wo, p.tile_w, p.tiles_x)
    _tiles_cover(cout, p.co_group, p.groups)
    assert (p.tile_h, p.tile_w) == cc.DN_TILE
    assert cc.DN_REGION == (2 * p.tile_h + 1, 2 * p.tile_w + 1)
    assert (_walks(p, b * p.tiles_y * p.tiles_x) == 1).all()
    rh, rw = cc.DN_REGION
    for ty in range(p.tiles_y):
        for i in range(ty * p.tile_h, min(ho, (ty + 1) * p.tile_h)):
            assert 0 <= 2 * i - 2 * ty * p.tile_h and 2 * i + 2 - 2 * ty * p.tile_h < rh
    for tx in range(p.tiles_x):
        for j in range(tx * p.tile_w, min(wo, (tx + 1) * p.tile_w)):
            assert 0 <= 2 * j - 2 * tx * p.tile_w and 2 * j + 2 - 2 * tx * p.tile_w < rw
    m_tiles = -(-rh * rw // 16)
    owner = np.zeros(rh * rw, np.int64)
    assert p.threads == (256 if p.blocks_per_sm == 2 else 512)
    for warp in range(p.threads // 32):
        for t in ((warp, warp + 8) if p.threads == 256 else (warp,)):
            if t < m_tiles:
                owner[16 * t:16 * (t + 1)] += 1
    assert (owner == 1).all()
    passes = [range(j0, min(j0 + cc.DN_EPI_NT, p.n_tiles))
              for j0 in range(0, p.n_tiles, cc.DN_EPI_NT)]
    assert sorted(j for ps in passes for j in ps) == list(range(p.n_tiles))
    # 35 halo columns at any 2-byte offset fit the staged row's granules
    assert cc.DN_HALO[1] + 7 <= 8 * cc.RAW_GRANULES
    assert p.n_tiles * 8 >= p.co_group and p.n_tiles <= cc.MAX_GROUP // 8
    assert cc.MIN_STAGES <= p.stages <= cc.MAX_STAGES
    assert p.smem_bytes == cc.half_mma_smem_bytes(p.n_tiles, p.stages,
                                                   p.chunks if p.resident else p.stages)
    assert p.smem_bytes <= min(cc.SMEM_LIMIT, cc.SM_SMEM // p.blocks_per_sm - 1024)
    assert p.pack_elements == p.groups * p.chunks * 9 * 8 * p.n_tiles * cc.ROW
    assert p.blocks % p.groups == 0 and p.blocks <= cc.MAX_GRID_X


def test_p5_mma_plan_of_the_forward():
    """down1 (36 -> 36) two blocks of 256 threads an SM with every chunk's
    weights resident; down2 and down3 (72 channels a group) one block of 512
    an SM; down3's 144 channels in two groups of 72."""
    plans = [cc.half_mma_plan(8, *s, sms=132) for s in P5_SITES[:3]]
    assert [(p.blocks_per_sm, p.threads, p.groups, p.n_tiles, p.resident) for p in plans] == [
        (2, 256, 1, 5, True), (1, 512, 1, 9, True), (1, 512, 2, 9, True)]
    assert [p.blocks for p in plans] == [264, 132, 132]
    with pytest.raises(ValueError, match="grid"):
        cc.half_mma_plan(2**20, 36, 36, 2**10, 2**10)


# P2/P3 in bf16: the tensor-core arm (ops/ln_iel_cuda.py:ln_iel_mma_plan), at
# the LCA sites, ragged widths and C from 1 to 144
LN_IEL_MMA_SITES = [s for s in LN_IEL_SITES if s[0] <= 144] + [
    (48, 9, 33), (49, 8, 16), (72, 13, 75), (73, 5, 17), (5, 3, 7), (1, 2, 2), (100, 17, 33)]


def _ranges(n: int, q: int) -> list:
    """csrc/ln_iel.cu's column ranges: range i is [i n / q, (i + 1) n / q)."""
    return [range(i * n // q, (i + 1) * n // q) for i in range(q)]


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("site", LN_IEL_MMA_SITES, ids=str)
def test_p23_mma_plan_covers_each_pixel_once(site, b):
    """Tiles cover rows and columns once; the expansion's n8 tile pairs
    cover the ring's pixels once; the first depthwise conv's warps (two
    strips of 5 rows, column ranges) cover the 1-pixel ring's region once
    and the gates' (two strips of 4 rows) the tile once; project_out's
    warps cover every (pixel, channel) of the tile once; shared memory fits
    the arm's blocks an SM; the output's vector divides W."""
    c, h, w = site
    hid = int(c * 2.66) or 1
    p = lc.ln_iel_mma_plan(b, c, h, w, hid)
    th, tw = p.tile_h, p.tile_w
    _tiles_cover(h, th, p.tiles_y)
    _tiles_cover(w, tw, p.tiles_x)
    assert p.blocks == b * p.tiles_y * p.tiles_x <= lc.MAX_GRID_X
    warps = p.threads // 32
    p2, rw1 = (th + 4) * (tw + 4), tw + 2
    ring = np.zeros(p2 // 8, np.int64)
    for warp in range(warps):
        for t0 in range(2 * warp, p2 // 8, 2 * warps):
            ring[t0:t0 + 2] += 1
    assert (ring == 1).all() and p2 % 8 == 0
    for rows, strips, width in ((th + 2, 2, rw1), (th, 2, tw)):
        seen = np.zeros((rows, width), np.int64)
        for warp in range(warps):
            s, cols = warp % strips, _ranges(width, warps // strips)[warp // strips]
            seen[s * rows // strips:(s + 1) * rows // strips, cols.start:cols.stop] += 1
        assert (seen == 1).all()
    m_tiles = th * tw // 16
    nh = warps // m_tiles
    assert warps % m_tiles == 0 and p.npad == 8 * p.n_tiles_warp * nh >= c
    out = np.zeros((th * tw, p.npad), np.int64)
    for warp in range(warps):
        mt, nt0 = warp % m_tiles, (warp // m_tiles) * p.n_tiles_warp
        out[16 * mt:16 * (mt + 1), 8 * nt0:8 * (nt0 + p.n_tiles_warp)] += 1
    assert (out == 1).all()
    assert p.cpad % 16 == 0 and c <= p.cpad < c + 16
    assert p.chunks * lc.HALF >= hid > (p.chunks - 1) * lc.HALF
    assert p.pack_bytes == p.chunks * lc.chunk_bytes(p.cpad, p.npad) and p.pack_bytes % 16 == 0
    assert p.smem_bytes == lc.ln_iel_mma_smem_bytes(tw, p.cpad, p.npad)
    assert p.smem_bytes <= min(lc.SMEM_LIMIT, lc.SM_SMEM // p.blocks_per_sm - 1024)
    assert lc.epilogue_fits(c, tw, p.cpad, p.npad)
    assert w % p.vec == 0 and p.vec in (1, 2, 4, 8)


def test_p23_mma_plan_arms_of_the_forward():
    """C = 36: two blocks of 256 threads an SM on 8 x 16 tiles (107 KB each);
    72: one block of 512 on 8 x 32 (213 KB); 144: one block of 512 on 8 x
    16 (its sums, 144 channels, split over two warps an m16 tile); past 144
    there is no arm."""
    arms = [lc.ln_iel_mma_plan(8, c, h, w, int(c * 2.66))
            for c, h, w in ((36, 200, 300), (72, 100, 150), (144, 50, 75))]
    assert [(p.tile_w, p.threads, p.blocks_per_sm, p.n_tiles_warp) for p in arms] == [
        (16, 256, 2, 5), (32, 512, 1, 9), (16, 512, 1, 9)]
    with pytest.raises(ValueError, match="C <= 144"):
        lc.ln_iel_mma_plan(1, 145, 8, 8, 385)
    with pytest.raises(ValueError, match="grid"):
        lc.ln_iel_mma_plan(2**16, 8, 2**12, 2**12, 21)


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


def _mma_plans(g, c, n, offset=0):
    """P10/P15's and P1's bf16 plans on an H100."""
    return (bq.mma_plan(g, c, n, bq.H100_CLUSTERS, offset),
            ha.mma_plan(g, c, n, bq.H100_CLUSTERS, offset))


def _score_plans(b, site):
    c, heads, n = site
    g = b * heads
    return g, c, n, (bq.qk_plan(g, c, n), ha.head_attention_plan(g, c, n)), _mma_plans(g, c, n)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("site", HEAD_SITES, ids=str)
def test_score_core_plan_covers_each_column_and_entry_once(site, b):
    """fp32 (the CUDA-core arm): one cluster of at most 8 blocks a g, each a
    chunk of whole 256-column tiles; every entry of the c x c scores in one
    thread's 3 x 3 tile, a tile's columns each in one slice. bf16 (the
    tensor-core arm): one cluster a g, each block a chunk of whole stages,
    all the clusters in one wave of the card's; a stage's columns each in
    one warp's k16 step and (P1's apply) one warp's 32 columns; every entry
    of the c x c scores in one lane's accumulator of one (m16, n8) tile,
    every norm in one lane's diagonal of one half tile."""
    g, c, n, f32_plans, plans = _score_plans(b, site)
    for p in f32_plans:
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
    for p in plans:
        # one cluster of `splits` blocks per g, each a chunk of whole stages, none empty
        assert 1 <= p.splits <= bq.MMA_MAX_CLUSTER and p.blocks == p.splits * g
        assert p.chunk % bq.MMA_TILE == 0
        _tiles_cover(n, p.chunk, p.splits)
        # the G clusters in one wave, as many blocks a g as that allows (or a stage each)
        fits = [s for s in range(1, bq.MMA_MAX_CLUSTER + 1) if g <= bq.H100_CLUSTERS[s - 1]]
        if fits:
            assert g <= bq.H100_CLUSTERS[p.splits - 1]
            assert p.splits == -(-n // p.chunk) and p.chunk == -(-(-(-n // bq.MMA_TILE)) // min(
                fits[-1], -(-n // bq.MMA_TILE))) * bq.MMA_TILE
        # warp w takes the k16 steps 16 w, 16 (w + WARPS), ... of each stage, and
        # the columns 32 w, 32 (w + WARPS), ... of P1's apply
        for width in (16, 32):
            cols = np.zeros(bq.MMA_TILE, np.int64)
            for w in range(bq.WARPS):
                for kk in range(width * w, bq.MMA_TILE, width * bq.WARPS):
                    cols[kk:kk + width] += 1
            assert (cols == 1).all()
        # k's 8-row tiles cover c; q's 16-row tiles are half as many
        assert (p.n_tiles - 1) * 8 < c <= p.n_tiles * 8
        entries = np.zeros((c, c), np.int64)
        for mi in range(-(-p.n_tiles // 2)):
            for nt in range(p.n_tiles):
                i, j = bq.fragment_entries(c, mi, nt)
                np.add.at(entries, (i.numpy(), j.numpy()), 1)
        assert (entries == 1).all()
    # P1's norms: row 16 mi + 8 h + lane / 4 of the lanes with lane / 8 == lane % 4,
    # for the halves 2 mi + h < n_tiles
    rows = np.zeros(c, np.int64)
    for mi in range(-(-plans[1].n_tiles // 2)):
        for h in range(2):
            if 2 * mi + h >= plans[1].n_tiles:
                continue
            for lane in range(32):
                r = 16 * mi + 8 * h + lane // 4
                if lane // 8 == lane % 4 and r < c:
                    rows[r] += 1
    assert (rows == 1).all()
    # P10/P15, both arms: block r of the cluster writes entries [r * per, (r + 1) * per)
    for p in (f32_plans[0], plans[0]):
        per = -(-c * c // p.splits)
        seen = np.zeros(c * c, np.int64)
        for r in range(p.splits):
            seen[r * per:(r + 1) * per] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("site", HEAD_SITES, ids=str)
def test_score_core_plan_shared_memory(site, itemsize):
    c, heads, n = site
    if itemsize == 2:
        qk, p1 = _mma_plans(8 * heads, c, n)
        # the ring (q and k, c rows of MMA_PITCH a stage), the aux area, the zero
        # line, the row offsets, the mbarriers; as many blocks an SM as the plan says
        for p, norms in ((qk, False), (p1, True)):
            aux = bq.aux_bytes(c, norms)
            assert aux % 16 == 0 and aux >= 4 * c * bq.MMA_PITCH  # the realigned q and k
            assert aux >= 4 * bq.reduce_floats(c, norms)          # partials, sums, softmax
            assert p.smem_bytes == (p.stages * 4 * c * bq.MMA_PITCH + aux + 16 + 8 * c
                                    + 8 * (bq.MAX_STAGES + bq.MAX_APPLY_STAGES))
            assert p.smem_bytes == bq.mma_bytes(c, norms, p.stages) <= bq.SMEM_LIMIT
            assert p.blocks_per_sm * (p.smem_bytes + bq.SMEM_PER_BLOCK) <= bq.SM_SMEM
            assert 2 <= p.stages <= bq.MAX_STAGES
            budget = min(bq.SMEM_LIMIT, bq.SM_SMEM // p.blocks_per_sm - bq.SMEM_PER_BLOCK)
            if p.stages < bq.MAX_STAGES:  # a deeper ring would not fit
                assert bq.mma_bytes(c, norms, p.stages + 1) > budget
            if p.blocks_per_sm == 1:  # two blocks an SM would take fewer than 3 stages
                assert bq.mma_bytes(c, norms, 3) > bq.SM_SMEM // 2 - bq.SMEM_PER_BLOCK
        # staged rows start 16-byte aligned, an ldmatrix's 8 rows on 8 bank groups
        assert bq.MMA_PITCH * 2 % 16 == 0
        assert len({r * bq.MMA_PITCH * 2 % 128 // 16 for r in range(8)}) == 8
        # P1's apply: v's stages (c rows each) in the ring, the realigned v and
        # the output tile in the aux area
        assert qk.apply_stages == 0
        assert p1.apply_stages == min(2 * p1.stages, bq.MAX_APPLY_STAGES)
        assert p1.apply_stages * c * bq.MMA_PITCH <= p1.stages * 2 * c * bq.MMA_PITCH
        assert 2 * (2 * c * bq.MMA_PITCH) <= bq.aux_bytes(c, True)
        return
    qk, p1 = bq.qk_plan(8 * heads, c, n), ha.head_attention_plan(8 * heads, c, n)
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
    """fp32: 16 bytes' worth of elements, else 2, else 1 (the kernels'
    instantiations); bf16: the stages filled straight (vec 8) where N and
    the bases put every row on a 16-byte boundary, else realigned (vec 1);
    ``elements``: the bases' start past a 16-byte boundary."""
    offset = elements * itemsize % 16
    plans = (_mma_plans(8, 18, n, offset) if itemsize == 2 else
             (bq.qk_plan(8, 18, n, offset), ha.head_attention_plan(8, 18, n, offset)))
    for p in plans:
        if itemsize == 2:
            assert p.vec == (8 if n % 8 == 0 and offset == 0 else 1)
            continue
        assert p.vec in (16 // itemsize, 2, 1)
        assert n % p.vec == 0 and offset % (p.vec * itemsize) == 0
        wider = [v for v in (16 // itemsize, 2) if v > p.vec]
        assert all(n % v or offset % (v * itemsize) for v in wider)


def test_score_core_plan_of_the_forward():
    """c = 18 at every site. bf16: clusters of as many blocks a g as keep
    all G clusters in one wave of an H100's (16 of 12, 39 of 7, 79 of 3, 14
    of 16): 15 (level 1's 118 stages over 16), 15, 8 at batch 1 (30, 60, 64
    blocks), 12, 6 (level 2's 30 stages over 7), 3 at batch 8 (192, 192,
    192); a ring of 2 stages of 512 columns
    (P1's apply 4), two blocks an SM, past the default 48 KB of shared
    memory (``raise_smem_cap``); the stages of levels 1 and 2 filled
    straight, level 3's (N = 3,750) realigned. fp32: as many blocks a g as
    bring the grid to two an SM, at most 8: 128, 256, 320 blocks at batch 8;
    16-byte loads at levels 1 and 2, 8-byte ones at level 3."""
    got = {b: [_mma_plans(b * h, 18, n)[0].splits for _, h, n in HEAD_SITES[:3]]
           for b in BATCHES}
    assert got == {1: [15, 15, 8], 8: [12, 6, 3], 32: [3, 2, 1]}
    assert [_mma_plans(8 * h, 18, n)[1].blocks for _, h, n in HEAD_SITES[:3]] == \
        [192, 192, 192]
    got = {b: [bq.qk_plan(b * h, 18, n).splits for _, h, n in HEAD_SITES[:3]] for b in BATCHES}
    assert got == {1: [8, 8, 8], 8: [8, 8, 5], 32: [5, 3, 2]}
    assert [ha.head_attention_plan(8 * h, 18, n).blocks for _, h, n in HEAD_SITES[:3]] == \
        [128, 256, 320]
    assert [bq.qk_plan(8, 18, n).vec for _, _, n in HEAD_SITES[:3]] == [4, 4, 2]
    for p in _mma_plans(16, 18, 60000):
        assert (p.stages, p.blocks_per_sm, p.n_tiles) == (2, 2, 3)
        assert 48 * 1024 < p.smem_bytes <= bq.SM_SMEM // 2 - bq.SMEM_PER_BLOCK
    assert _mma_plans(16, 18, 60000)[1].apply_stages == 4
    assert [_mma_plans(8, 18, n)[0].vec for _, _, n in HEAD_SITES[:3]] == [8, 8, 1]
    for plan in (bq.qk_plan, lambda g, c, n: _mma_plans(g, c, n)[0]):
        with pytest.raises(ValueError, match="c <= 32"):
            plan(8, 33, 100)
    for plan in (ha.head_attention_plan, lambda g, c, n: _mma_plans(g, c, n)[1]):
        with pytest.raises(ValueError, match="grid"):
            plan(65536, 18, 100)


# P1's and P10/P15's bf16 arm replayed on the CPU (ops/batched_qk_cuda.py:
# replay_sums, mma_replay; ops/head_attention_cuda.py:mma_replay): the
# forward's three sites (one g each; level 3's N = 3,750 ends in a ragged
# stage and realigns), odd N, c at the m16 / n8 padding edges, and starts 1
# to 7 elements past a 16-byte boundary. (G, c, N, heads, offset)
MMA_REPLAY_CASES = [(1, 18, 60000, 1, 0), (1, 18, 15000, 1, 0), (2, 18, 3750, 2, 0),
                    (2, 18, 3750, 2, 1), (1, 18, 600, 1, 2), (3, 17, 257, 3, 3), (1, 32, 255, 1, 5),
                    (2, 8, 264, 1, 7), (1, 1, 1, 1, 0), (1, 24, 9, 1, 1)]


def _bf16_qkv(case):
    import torch

    g, c, n, heads, _ = case
    gen = torch.Generator().manual_seed(g * 1000 + c * 10 + n)
    q = torch.rand((g, c, n), generator=gen) * 2 - 1
    k = q + 0.3 * torch.rand((g, c, n), generator=gen)  # shared structure: a wrong pairing shows
    v = torch.rand((g, c, n), generator=gen) * 2 - 1
    temps = torch.rand(heads, generator=gen) * 20 + 1
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), temps


@pytest.mark.parametrize("case", MMA_REPLAY_CASES, ids=str)
def test_p10_p15_mma_replay_equals_the_plain_version(case):
    """The bf16 score core's addressing replayed in float64 (the ring's
    stages in the kernel's order, RowStream's covers and shifts, the zero
    line past c, k's n8 operands as halves of its m16 loads, fresh sums a
    stage, the warps and then the blocks in order, each block's share of
    the entries) equals ``batched_qk_plain`` within 1e-5 |q_r| |k_c|; every
    column feeds one product, every entry is written once."""
    q, k, _, _ = _bf16_qkv(case)
    got, seen, writes = bq.mma_replay(q, k, bq.H100_CLUSTERS, case[-1])
    assert (seen == 1).all() and (writes == 1).all()
    ref = bq.batched_qk_plain(q, k).double()
    nq, nk = (t.double().square().sum(-1).sqrt() for t in (q, k))
    assert ((got - ref).abs() - 1e-5 * nq[:, :, None] * nk[:, None, :]).max().item() <= 0


@pytest.mark.parametrize("case", MMA_REPLAY_CASES, ids=str)
def test_p1_mma_replay_equals_the_plain_version(case):
    """P1's bf16 arm replayed (the score core and its norms as the
    diagonals of X X^T, the softmax, A's fragments, v through the apply's
    ring and ldmatrix.trans rows, the output tile at each row's shift and
    its chunks written out) equals ``head_attention_plain`` within two bf16
    ulps at the apply's scale; every column feeds one product, every output
    element is written once."""
    import torch

    q, k, v, temps = _bf16_qkv(case)
    got, seen, writes = ha.mma_replay(q, k, v, temps, bq.H100_CLUSTERS, case[-1])
    assert (seen == 1).all() and (writes == 1).all()
    assert got.dtype == torch.bfloat16
    ref = ha.head_attention_plain(q, k, v, temps).float()
    a = ha.attention_matrix(q, k, temps).to(v.dtype).float()
    scale = torch.bmm(a, v.float().abs())
    _, e = torch.frexp(torch.maximum(torch.maximum(got.float().abs(), ref.abs()), scale))
    allowed = torch.ldexp(torch.full_like(ref, 2.0), e - 8)
    assert ((got.float() - ref).abs() - allowed).max().item() <= 0


def test_mma_replays_reject_a_wrong_pairing():
    """The replays' bars see a fault: k's rows permuted fail both."""
    import torch

    q, k, v, temps = _bf16_qkv((1, 18, 600, 1, 2))
    flipped = k.flip(1)
    got, _, _ = bq.mma_replay(q, flipped, bq.H100_CLUSTERS, 2)
    ref = bq.batched_qk_plain(q, k).double()
    nq, nk = (t.double().square().sum(-1).sqrt() for t in (q, k))
    assert ((got - ref).abs() - 1e-5 * nq[:, :, None] * nk[:, None, :]).max().item() > 0
    got, _, _ = ha.mma_replay(q, flipped, v, temps, bq.H100_CLUSTERS, 2)
    ref = ha.head_attention_plain(q, k, v, temps).float()
    assert (got.float() - ref).abs().max().item() > 0.05


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
    """fp32: a block a (column tile, image); bf16: every group's persistent
    blocks visit every (image, column tile) once, and the groups cover
    C_out once. C_out padded to 16-row tiles, K to whole steps."""
    cin, cout, h, w = site
    k, n = 9 * cin, h * w
    p = icol.im2col_plan(b, cout, k, n, itemsize)
    _tiles_cover(n, icol.N_TILE[itemsize], p.n_tiles)
    assert b <= icol.MAX_GRID_Y and p.blocks <= icol.MAX_GRID_X
    assert p.k_step == icol.K_STEP[itemsize] and (p.k_steps - 1) * p.k_step < k <= p.k_steps * p.k_step
    # each thread copies whole vectors of each step's tile
    assert (p.k_step * icol.N_TILE[itemsize] // p.vec) % icol.THREADS == 0
    if itemsize == 4:
        assert p.blocks == p.n_tiles * b and p.groups == 1
        assert (p.m_tiles - 1) * 16 < cout <= p.m_tiles * 16 <= icol.MAX_COUT
        assert p.smem_bytes == icol.smem_bytes(itemsize, p.m_tiles) <= 48 * 1024
        return
    rows = -(-cout // p.groups)
    _tiles_cover(cout, rows, p.groups)
    assert rows <= 16 * p.m_tiles < rows + 64 and p.m_tiles in (4, 8)  # one or two m64 tiles
    assert (_walks(p, b * p.n_tiles) == 1).all()
    assert p.pack_elements == p.groups * p.k_steps * 16 * p.m_tiles * p.k_step


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
    """bf16: 16-byte loads (the TMA unit) at N = 240,000, 60,000, 15,000,
    4-byte cp.async at 3,750; C_out 1, 2, 36 in one m64 tile of W, 72 in
    two, 144 in two groups of two; K 9 and 27 in one 64-deep step."""
    assert [icol.im2col_plan(8, 36, 27, n, 2).vec for n in (240000, 60000, 15000, 3750)] == \
        [8, 8, 8, 2]
    assert [(icol.im2col_plan(8, c, 324, 3750, 2).m_tiles, icol.im2col_plan(8, c, 324, 3750, 2)
             .groups) for c in (1, 2, 36, 72, 144)] == [(4, 1), (4, 1), (4, 1), (8, 1), (8, 2)]
    assert [icol.im2col_plan(8, 36, k, 3750, 2).k_steps for k in (9, 27, 324, 1296)] == \
        [1, 1, 6, 21]
    with pytest.raises(ValueError, match="C_out <= 144"):
        icol.im2col_plan(1, 145, 27, 100, 2)
    with pytest.raises(ValueError, match="grid"):
        icol.im2col_plan(65536, 36, 27, 100, 2)


@pytest.mark.parametrize("site", P6_SITES, ids=str)
def test_p6_mma_plan_shared_memory_and_ring(site):
    """bf16: one block an SM within 227 KB; as many stages as fit (3 to 6),
    with the staged output tile and a barrier a stage where the TMA unit
    loads (vec 8); the persistent grid at most the card's SMs."""
    cin, cout, h, w = site
    for b in (1, 8):
        p = icol.im2col_plan(b, cout, 9 * cin, h * w, 2)
        tma = p.vec == 8
        assert icol.MIN_STAGES <= p.stages <= icol.MAX_STAGES
        assert p.smem_bytes == icol.smem_bytes(2, p.m_tiles, p.stages, tma) <= icol.SMEM_LIMIT
        assert p.stages == icol.MAX_STAGES or \
            icol.smem_bytes(2, p.m_tiles, p.stages + 1, tma) > icol.SMEM_LIMIT
        assert p.blocks <= icol.SMS and p.blocks == p.groups * min(b * p.n_tiles,
                                                                   icol.SMS // p.groups)


def _swizzled_offset(r: int, c: int) -> int:
    """Element offset of the 8-element chunk c of 128-byte row r under the
    128-byte swizzle: chunk c ^ (r % 8)."""
    return r * 64 + 8 * (c ^ (r % 8))


def test_p6_mma_layouts_are_wgmma_canonical():
    """The operand's stage (MN-major) and W's packed slice (K-major), as the
    kernel writes them, read back through the descriptors' canonical
    128-byte-swizzled layouts (CUTLASS cute/atom/mma_traits_sm90_gmma.hpp:
    MN-major ((8,n),(8,k)):((1,LBO),(8,SBO)), K-major ((8,n),2):((8,SBO),1)
    in 16-byte units, LBO = an atom of 64 columns, SBO = 8 rows) give back
    the operand and W, and their product equals W a."""
    import torch

    g = torch.Generator().manual_seed(5)
    kstep, ncols, rows = icol.K_STEP[2], icol.N_TILE[2], 128
    a = torch.randn((kstep, ncols), generator=g, dtype=torch.float64)
    wmat = torch.randn((rows, kstep), generator=g, dtype=torch.float64)
    # the stage: atom = 64 columns of 64 rows x 128 bytes
    stage = torch.zeros(kstep * ncols, dtype=torch.float64)
    for k in range(kstep):
        for col in range(0, ncols, 8):
            at = (col // 64) * kstep * 64 + _swizzled_offset(k, (col % 64) // 8)
            stage[at:at + 8] = a[k, col:col + 8]
    # W's slice: im2col_pack_kernel's layout, rows of 64 K-elements
    wslice = torch.zeros(rows * kstep, dtype=torch.float64)
    for r in range(rows):
        for c in range(8):
            at = _swizzled_offset(r, c)
            wslice[at:at + 8] = wmat[r, 8 * c:8 * c + 8]
    lbo, sbo = kstep * 64, 8 * 64  # in elements: an atom of columns; 8 rows
    swz = lambda off: off - off % 64 + ((off % 64 // 8) ^ (off // 64 % 8)) * 8 + off % 8
    b_read = torch.zeros_like(a)
    for k in range(kstep):   # MN-major B: column = 8 (atom offset) + chunk
        for col in range(ncols):
            off = (col // 64) * lbo + (k // 8) * sbo + (k % 8) * 64 + col % 64
            b_read[k, col] = stage[swz(off)]
    a_read = torch.zeros_like(wmat)
    for r in range(rows):    # K-major A: rows 128 bytes apart, 8-row groups SBO apart
        for k in range(kstep):
            off = (r // 8) * sbo + (r % 8) * 64 + k
            a_read[r, k] = wslice[swz(off)]
    assert torch.equal(b_read, a) and torch.equal(a_read, wmat)
    assert torch.allclose(a_read @ b_read, wmat @ a)


# ---------------------------------------------------------------------------
# P7, P8/P9/P11, P12/P13, P14: the relayout (ops/relayout_cuda.py)
# ---------------------------------------------------------------------------


ZERO = -2  # a box element loaded from past the tensor's edge


def _chunk_at(p, side, s, a, m, bc, itemsize):
    """Byte offsets in a bulk-arm buffer of 16-byte chunk ``bc`` of row (s,
    a, m) of ``side`` ("in": a = x, b = y; "out": a = y, b = x), as
    csrc/relayout.cu:chunk_at computes them (numpy arrays broadcast)."""
    box, ta, tb, run, pr = ((p.in_box, p.tx, p.ty, p.in_run, p.in_pr) if side == "in" else
                            (p.out_box, p.ty, p.tx, p.out_run, p.out_pr))
    if box == rl.NARROW_BOX:
        region = -(-pr * p.tmb * min(ta, rl.BOX_ROWS) // rl.RING_ALIGN) * rl.RING_ALIGN
        im, ab = m // p.tmb, -(-ta // rl.BOX_ROWS)
        return ((im * ab + a // rl.BOX_ROWS) * region
                + (a % rl.BOX_ROWS * p.tmb + m % p.tmb) * pr + bc * 16)
    if box:
        nbb = tb * itemsize // rl.LINE
        region = -(-rl.LINE * p.tmb * ta // rl.RING_ALIGN) * rl.RING_ALIGN
        im, line = m // p.tmb, a * p.tmb + m % p.tmb
        return (im * nbb + bc // 8) * region + line * rl.LINE + ((bc % 8) ^ (line % 8)) * 16
    rho, rb = s * ta + a, p.tm * tb * itemsize
    at = rho // run * pr + rho % run * rb if run else rho * rb
    return at + m * tb * itemsize + bc * 16


def _waves(addresses):
    """Wavefronts of each 8-lane phase of 16-byte shared accesses (a phase a
    row, its lanes along the row): the most distinct addresses any 16-byte
    bank group holds."""
    addresses = np.asarray(addresses)
    srt = np.sort(addresses, axis=1)
    fresh = np.concatenate([np.ones((len(srt), 1), bool), srt[:, 1:] != srt[:, :-1]], axis=1)
    group = srt // 16 % 8
    counts = np.stack([((group == gi) & fresh).sum(axis=1) for gi in range(8)], axis=1)
    return counts.max(axis=1)


def _box_moves(p, side, item, shape, itemsize):
    """(tensor flat indices, in-bounds mask, buffer element indices) of the
    boxes of one side of an item; ``shape`` the side's tensor as (G, A, M,
    B)."""
    g, a_ext, m, b_ext = shape
    g0, m0, x0, y0, ns, nm, nx, ny = item
    box, ta, a0, b0, nb, na, pr = ((p.in_box, p.tx, x0, y0, ny, nx, p.in_pr) if side == "in" else
                                   (p.out_box, p.ty, y0, x0, nx, ny, p.out_pr))
    v = 16 // itemsize
    if box == rl.NARROW_BOX:  # the narrow axis padded to pr bytes, BOX_ROWS rows a box
        rows = min(ta, rl.BOX_ROWS)
        im, ia, a, ml, bb = np.meshgrid(np.arange(-(-nm // p.tmb)), np.arange(-(-na // rows)),
                                        np.arange(rows), np.arange(p.tmb),
                                        np.arange(pr // itemsize), indexing="ij")
        ga, gm, gb = a0 + ia * rows + a, m0 + im * p.tmb + ml, bb
        inside = (ga < a_ext) & (gm < m) & (gb < b_ext)
        flat = ((g0 * a_ext + ga) * m + gm) * b_ext + gb
        at = _chunk_at(p, side, 0, ia * rows + a, im * p.tmb + ml, bb // v, itemsize)
        return flat, inside, at // itemsize + bb % v
    unit = rl.LINE // itemsize
    im, bi, a, ml, bb = np.meshgrid(np.arange(-(-nm // p.tmb)), np.arange(-(-nb // unit)),
                                    np.arange(ta), np.arange(p.tmb), np.arange(unit),
                                    indexing="ij")
    ga, gm, gb = a0 + a, m0 + im * p.tmb + ml, b0 + bi * unit + bb
    inside = (ga < a_ext) & (gm < m) & (gb < b_ext)
    flat = ((g0 * a_ext + ga) * m + gm) * b_ext + gb
    at = _chunk_at(p, side, 0, a, im * p.tmb + ml, bi * 8 + bb // v, itemsize)
    return flat, inside, at // itemsize + bb % v


def _bulk_moves(p, side, item, shape, itemsize):
    """(tensor flat indices, buffer element indices) of the bulk copies of
    one side of an item (``shape``: the side's tensor as (G, A, M, B)), each
    checked: 16-byte aligned at both ends, a whole number of 16-byte chunks,
    several rows a copy only where they follow each other in the tensor."""
    g, a_ext, m, b_ext = shape
    g0, m0, x0, y0, ns, nm, nx, ny = item
    ta, a0, na, run, pr = ((p.tx, x0, nx, p.in_run, p.in_pr) if side == "in" else
                           (p.ty, y0, ny, p.out_run, p.out_pr))
    rows = (ns - 1) * ta + na
    run = run or rows  # run 0: all rows one copy; else a power of two (a shift in the kernel)
    assert run == rows or run & (run - 1) == 0
    flats, ats = [], []
    for u in range(-(-rows // run)):
        s, a = divmod(u * run, ta)
        start = (((g0 + s) * a_ext + a0 + a) * m + m0) * b_ext
        n = min(run, rows - u * run) * nm * b_ext
        assert start * itemsize % 16 == 0 and n * itemsize % 16 == 0 and u * pr % 16 == 0
        assert run == 1 or (nm == m and (p.k == 1 or ta == a_ext))
        flats.append(np.arange(start, start + n))
        ats.append(u * pr // itemsize + np.arange(n))
    return np.concatenate(flats), np.concatenate(ats)


def _bulk_blocks(p, item, itemsize):
    """Each transposition block's input-row and output-row chunk offsets, in
    the order the kernel takes them, and the most wavefronts an 8-lane phase
    meets (2-byte: one 8 x 8 block a phase; 4-byte: two 4 x 4 blocks, an odd
    run's last block paired with itself)."""
    g0, m0, x0, y0, ns, nm, nx, ny = item
    v = 16 // itemsize
    nbx, nby = nx // v, ny // v
    pair_y = itemsize == 4 and p.pair_y
    fast, slow = (nby, nbx) if pair_y else (nbx, nby)
    fast_even = fast + (fast & 1) if itemsize == 4 else fast  # the last of an odd run repeats
    q = np.arange(ns * nm * slow * fast_even)
    f, t = np.minimum(q % fast_even, fast - 1), q // fast_even
    mm, t = t % nm, t // nm
    sl, s = t % slow, t // slow
    xo, yo = (sl, f) if pair_y else (f, sl)
    r = np.arange(v)
    src = _chunk_at(p, "in", s[:, None], v * xo[:, None] + r, mm[:, None], yo[:, None], itemsize)
    dst = _chunk_at(p, "out", s[:, None], v * yo[:, None] + r, mm[:, None], xo[:, None], itemsize)
    pad = (-len(q)) % (8 // v)  # the tail repeats the last block
    phases = lambda a: np.concatenate([a, a[-1:].repeat(pad, 0)]).reshape(-1, 8)
    return src, dst, int(max(_waves(phases(src)).max(), _waves(phases(dst)).max()))


def _items(p, pick=None):
    """(g0, m0, x0, y0, ns, nm, nx, ny) of the bulk arm's work items, x-tiles
    fastest (csrc/relayout.cu:item_of); ``pick``: only these."""
    tiles_x, tiles_y, chunks = -(-p.x // p.tx), -(-p.y // p.ty), -(-p.m // p.tm)
    for w in range(p.work) if pick is None else pick:
        t, tx_i = divmod(w, tiles_x)
        t, ty_i = divmod(t, tiles_y)
        gc, mc = divmod(t, chunks)
        g0, m0, x0, y0 = gc * p.k, mc * p.tm, tx_i * p.tx, ty_i * p.ty
        yield (g0, m0, x0, y0, min(p.k, p.g - g0), min(p.tm, p.m - m0), min(p.tx, p.x - x0),
               min(p.ty, p.y - y0))


def _relayout_replay(p, itemsize, in_offset=0, out_offset=0, pick=None):
    """The output of csrc/relayout.cu under plan ``p`` on the input 0, 1, 2,
    ..., replayed with numpy arrays (every copy, block and store of a work
    item at once), the times each output element is written, and the most
    shared-memory wavefronts an 8-lane phase of the bulk arm's transposition
    met (1: no bank conflict). Checked on the way: copies and vectors aligned
    and whole, every element stored one the item loaded. ``pick``: only these
    work items (the rest of the output unwritten)."""
    g, x, m, y = p.g, p.x, p.m, p.y
    n = g * x * m * y
    src = np.arange(n)
    out, writes = np.full(n, -1, np.int64), np.zeros(n, np.int64)
    if p.copy:
        assert in_offset % (p.vi * itemsize) == 0 and out_offset % (p.vi * itemsize) == 0
        assert p.y % p.vi == 0
        return src.copy(), writes + 1, 1
    if p.arm == rl.ASYNC:
        groups, tiles_y = -(-g * m // p.k), -(-y // p.ty)
        for w in range(p.work) if pick is None else pick:
            tile_i, grp = divmod(w, groups)
            tx_i, ty_i = divmod(tile_i, tiles_y)
            gm0, x0, y0 = grp * p.k, tx_i * p.tx, ty_i * p.ty
            nx, ny, ns = min(p.tx, x - x0), min(p.ty, y - y0), min(p.k, g * m - gm0)
            tile = np.full(p.tx * p.pitch, -1, np.int64)
            r = np.arange(ns * nx)[:, None]
            gg, mm = np.divmod(gm0 + r // nx, m)
            a = ((gg * x + x0 + r % nx) * m + mm) * y + y0 + np.arange(0, ny, p.vi)
            assert ((a * itemsize + in_offset) % (p.vi * itemsize) == 0).all()
            at = r % nx * p.pitch + r // nx * ny + np.arange(0, ny, p.vi)
            assert p.pitch % p.vi or (at % p.vi == 0).all()  # cp.async's shared destination
            for k in range(p.vi):
                tile[at + k] = src[a + k]
            r = np.arange(ns * ny)[:, None]
            gg, mm = np.divmod(gm0 + r // ny, m)
            d = ((gg * y + y0 + r % ny) * m + mm) * x + x0 + np.arange(0, nx, p.vo)
            assert ((d * itemsize + out_offset) % (p.vo * itemsize) == 0).all()
            for k in range(p.vo):
                vals = tile[(np.arange(0, nx, p.vo) + k) * p.pitch + r]
                assert (vals >= 0).all(), "read a shared element this item did not load"
                out[d + k] = vals
                np.add.at(writes, d + k, 1)
        return out, writes, 1
    assert (in_offset, out_offset) == (0, 0)
    waves, v = 1, 16 // itemsize
    for item in _items(p, pick):
        buf_in = np.full(p.in_bytes // itemsize, -1, np.int64)
        if p.in_box:
            flat, inside, at = _box_moves(p, "in", item, (g, x, m, y), itemsize)
            buf_in[at] = np.where(inside, src[np.where(inside, flat, 0)], ZERO)
        else:
            flat, at = _bulk_moves(p, "in", item, (g, x, m, y), itemsize)
            buf_in[at] = src[flat]
        rows_in, rows_out, item_waves = _bulk_blocks(p, item, itemsize)
        waves = max(waves, item_waves)
        buf_out = np.full(p.out_bytes // itemsize, -1, np.int64)
        block = buf_in[rows_in[:, :, None] // itemsize + np.arange(v)]  # (block, x, y)
        buf_out[rows_out[:, :, None] // itemsize + np.arange(v)] = block.transpose(0, 2, 1)
        if p.out_box:
            flat, inside, at = _box_moves(p, "out", item, (g, y, m, x), itemsize)
            flat, at = flat[inside], at[inside]
        else:
            flat, at = _bulk_moves(p, "out", item, (g, y, m, x), itemsize)
        vals = buf_out[at]
        assert (vals >= 0).all(), "stored a buffer element the item did not load"
        out[flat] = vals
        np.add.at(writes, flat, 1)
    return out, writes, waves


def _box_rules(p, itemsize):
    """Each box side's tensor map as csrc/relayout.cu:encode_side makes it
    meets the TMA unit's rules: the tensor (G, A, M, B) with strides
    (B, M B, A M B) elements, each a multiple of 16 bytes (so, both tensors
    16-byte aligned, every base too), a box of at most 256 along each axis,
    its inner extent a multiple of 16 bytes (128 with the 128-byte
    swizzle)."""
    for box, ta, a_ext, b_ext, pr in ((p.in_box, p.tx, p.x, p.y, p.in_pr),
                                      (p.out_box, p.ty, p.y, p.x, p.out_pr)):
        if not box:
            continue
        strides = (b_ext, p.m * b_ext, a_ext * p.m * b_ext)
        inner = rl.LINE if box == rl.LONG_BOX else pr
        dims = (inner // itemsize, p.tmb, min(ta, rl.BOX_ROWS) if box == rl.NARROW_BOX else ta, 1)
        assert all(st * itemsize % 16 == 0 for st in strides)
        assert all(1 <= d <= 256 for d in dims) and inner % 16 == 0
        assert box == rl.NARROW_BOX or inner == rl.LINE


def _bulk_can_run(shape, itemsize, in_offset=0, out_offset=0):
    """Where the plan takes the bulk arm: M > 1 (canonical) with M rows of
    the narrow axis MIN_ROW bytes or more (the cp.async arm was the faster
    on an H100 at every M = 1 shape timed and at TNSM's noise map, M = 3,
    in fp32), and its copies can run: both tensors 16-byte aligned, X and Y
    whole 16-byte vectors, not a copy."""
    g, x, m, y = rl.canonical(*shape)
    v = 16 // itemsize
    return (m > 1 and m * min(x, y) * itemsize >= rl.MIN_ROW and (in_offset, out_offset) == (0, 0)
            and x % v == 0 and y % v == 0)


def _ring(p, itemsize):
    """Whether the cp.async arm's plan should take its two-stage ring: the
    pitch a whole number of input vectors and at least half the blocks
    taking a second item (blocks as two stages' shared memory allows)."""
    per_sm = min(2048 // rl.THREADS, rl.SMEM_SM // (2 * p.tx * p.pitch * itemsize + 1024))
    return p.pitch % p.vi == 0 and p.work >= rl.RING_ITEMS * min(p.work, rl.SMS * per_sm)


# (G, X, M, Y): the relayouts' mappings at small and odd sizes (P8, P12,
# P7 steps 1, P11, slabs of 36 x 8 and 5 x 3 several to a work item, the
# last one cut, the HWCB entry and exit at batch 3), Y = 1 and X = 1
# (unit axes dropped: a copy, or a transpose of X or Y with M), both axes
# long (64 x 64 tiles cut at the edges), tiles cut along one long axis;
# then the bulk arm's: M past 256 (prime: one channel a box, and 260 = 4 x
# 65), a long Y or X with boxes of 65 channels, both long (boxes on both
# sides), G > 1 with a long tile cut, whole slabs several to an item (M =
# 1 and 2: the cp.async arm; M = 32 and, in fp32, 16: the bulk arm), both
# narrow with M = 3
RELAYOUT_SHAPES = [(1, 24, 4, 8), (3, 6, 4, 8), (1, 21, 3, 5), (7, 3, 1, 5), (1, 5, 3, 21),
                   (40, 36, 1, 8), (300, 5, 1, 3),
                   (1, 300, 1, 3), (1, 3, 1, 300), (1, 100, 1, 1), (2, 1, 1, 7), (1, 1, 3, 50),
                   (1, 40, 3, 1), (1, 130, 2, 70), (1, 4100, 1, 2), (1, 2, 1, 4100),
                   (1, 17, 5, 33), (2, 96, 1, 64),
                   (1, 64, 257, 8), (1, 8, 260, 264), (1, 264, 260, 8), (1, 272, 3, 264),
                   (3, 200, 9, 16), (5, 32, 1, 24), (5, 16, 2, 24), (2, 96, 3, 64),
                   (5, 8, 32, 8), (5, 8, 16, 8)]


@pytest.mark.parametrize("offsets", [(0, 0), (2, 0), (0, 1)], ids=["aligned", "in+2", "out+1"])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", RELAYOUT_SHAPES, ids=str)
def test_relayout_plan_covers_each_output_once(shape, itemsize, offsets):
    """``offsets``: the input's and the output's starts, in elements past a
    16-byte boundary. The bulk arm exactly where M > 1 and its copies can
    run (else cp.async, its ring exactly where half the blocks take a second
    item), each output element written once, the buffers within a block's
    shared memory, the grid within the card."""
    in_off, out_off = (e * itemsize % 16 for e in offsets)
    p = rl.relayout_plan(*shape, itemsize, in_off, out_off)
    assert p.copy or (p.arm == rl.BULK) == _bulk_can_run(shape, itemsize, in_off, out_off)
    out, writes, waves = _relayout_replay(p, itemsize, in_off, out_off)
    g, x, m, y = shape
    want = np.arange(g * x * m * y).reshape(g, x, m, y).transpose(0, 3, 2, 1).ravel()
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, want)
    assert p.smem <= rl.SMEM_CAP and 1 <= p.blocks <= rl.SMS * rl.BLOCKS_PER_SM
    if p.arm == rl.BULK:
        assert p.smem == rl.RING_ALIGN + p.stages * (p.in_bytes + p.out_bytes) + rl.BARS
        assert 2 <= p.stages <= rl.MAX_STAGES and p.tmb % 2 == 1 and p.tm % p.tmb == 0
        _box_rules(p, itemsize)
    if p.arm == rl.ASYNC:
        assert p.stages == (2 if _ring(p, itemsize) else 1)
        assert p.smem == p.stages * p.tx * p.pitch * itemsize


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
    bulk arm wherever M > 1 and X and Y are whole 16-byte vectors (the
    levels at batch 8 but level 3's N = 3,750), cp.async elsewhere (the
    HWCB ends and the noise map, M = 1; the levels at batch 1, M = 1 once
    unit axes go). The bulk arm: work items that cover the
    extents, the narrow axis whole, the long one in whole 128-byte lines,
    boxes on the long side, tmb channels (odd, dividing M) a box, 2 to
    MAX_STAGES stages in a block's shared memory, the grid filling the card
    from batch 8, and a transposition free of bank conflicts (replayed on
    the first, a middle and the last work item). The cp.async arm: the
    widest vectors, its ring exactly where half the blocks take a second
    item, the grid filling the card and the load side keeping at least
    half the threads busy."""
    p = rl.relayout_plan(*gxmy, itemsize)
    assert p.copy == (b == 1 and site in ("entry", "exit"))
    assert p.smem <= rl.SMEM_CAP
    if p.copy:
        assert p.vi * itemsize == 16 and p.blocks == min(p.work, rl.SMS * rl.BLOCKS_PER_SM)
        assert p.blocks >= rl.SMS
        return
    assert (p.arm == rl.BULK) == _bulk_can_run(gxmy, itemsize)
    g, x, m, y = p.g, p.x, p.m, p.y
    if p.arm == rl.ASYNC:
        widest = lambda n: next(v for v in (8, 4, 2, 1) if v * itemsize <= 16 and n % v == 0)
        assert (p.vi, p.vo) == (widest(y), widest(x))
        assert p.stages == (2 if _ring(p, itemsize) else 1)
        assert p.smem == p.stages * p.tx * p.pitch * itemsize
        assert p.blocks >= rl.SMS  # the grid fills the card
        # the load side keeps at least half the threads busy
        assert min(p.k * p.tx, rl.THREADS // p.lx) * min(p.ty // p.vi, p.lx) >= rl.THREADS // 2
        return
    unit = rl.LINE // itemsize
    assert p.work == -(-g // p.k) * -(-m // p.tm) * -(-x // p.tx) * -(-y // p.ty)
    long_x, long_y = x * itemsize > rl.NARROW_BYTES, y * itemsize > rl.NARROW_BYTES
    assert (p.in_box == rl.LONG_BOX, p.out_box == rl.LONG_BOX) == (long_y, long_x)
    assert p.tx % unit == 0 if long_x else p.tx == x
    assert p.ty % unit == 0 if long_y else p.ty == y
    assert p.tmb % 2 == 1 and m % p.tmb == 0 and p.tm % p.tmb == 0
    assert 2 <= p.stages <= rl.MAX_STAGES
    assert b == 1 or p.blocks >= rl.SMS
    _box_rules(p, itemsize)
    _, _, waves = _relayout_replay(p, itemsize, pick=sorted({0, p.work // 2, p.work - 1}))
    assert waves == 1


def test_relayout_plan_of_the_hwcb_ends_at_batch_8():
    """bf16, batch 8: M = 1, so both ends take the cp.async arm (on an H100
    the bulk arm was 1.05-1.12x slower there, its 704 items on 396 blocks),
    as PR 10's tiles.
    The entry's 512 x 8 tiles take a 10-element pitch (a load's 16 bytes
    stored element by element, the columns read without conflicts), the
    exit's 8 x 512 tiles no padding (a load's 16 bytes stored whole, the
    columns read by 32 rows); 1,407 items on 1,056 blocks: under one and a
    half a block, so one stage, loaded through registers (PR 10's kernel;
    the fp32 exit, 1,407 on 792 two-stage blocks, takes the ring); each
    side's first warp
    meets no bank conflict."""
    hw = 400 * 600
    entry = rl.relayout_plan(*rl.geometry("P14", (hw, 3, 8), n_blk=hw)[0], 2)
    exit_ = rl.relayout_plan(*rl.geometry("P11", (8, 1, 3 * hw))[0], 2)
    assert (entry.name, exit_.name) == ("tiles", "tiles")
    assert (entry.tx, entry.ty, entry.pitch, entry.vi, entry.vo) == (512, 8, 10, 8, 8)
    assert (exit_.tx, exit_.ty, exit_.pitch, exit_.vi, exit_.vo) == (8, 512, 512, 8, 8)
    assert entry.stages == exit_.stages == 1 and entry.work == exit_.work == 1407
    assert rl.relayout_plan(*rl.geometry("P11", (8, 1, 3 * hw))[0], 4).stages == 2
    for p in (entry, exit_):
        _, l_waves, _ = rl.side_cost(p.lx, p.tx, p.vi, p.ty // p.vi, p.m * p.y, 2, p.pitch,
                                     (p.tx, p.ty))
        _, s_waves, _ = rl.side_cost(p.sx, p.ty, p.vo, p.tx // p.vo, p.m * p.x, 2, p.pitch)
        # conflict-free: 32 lanes of 2 bytes a wavefront, or 8 of 16 bytes
        assert (l_waves, s_waves) == (1 / 64 if p.pitch % p.vi == 0 else 1 / 32, 1 / 32)
        _, writes, _ = _relayout_replay(p, 2, pick=[0, 1, p.work - 1])
        assert writes.max() == 1


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
    assert big.g * big.x * big.m * big.y > 2**31
    assert big.work == -(-big.x // big.tx) * -(-big.y // big.ty)
