"""P4 and P5: the dense 3x3 conv kernel and the fused NormDownsample kernel
(conv 3x3 -> bilinear x0.5 -> PReLU), their plain versions and the
dispatchers ``conv3x3`` and ``conv3x3_half_prelu``.

Counterpart of ``experiments/conv_pallas_nhcw.py:_pallas_conv3x3`` (P4,
``pad_mode`` "zero" or "edge") and ``experiments/fused_pallas_nhcw.py:
_pallas_down`` (P5). Both kernels are ``csrc/conv3x3.cu`` and take a
contiguous NCHW activation and the OIHW weight in the activation dtype (the
wrapper casts it with ``.to(x.dtype)``, a no-op in the model); P5 also
takes K3's float64-derived band weights (``ops/resize.py:axis_weights``)
and the PReLU's fp32 slope on the card. Plain versions: P4's is the port's
``conv3x3_same`` / ``conv3x3_replpad`` (``ops/conv.py``); P5's is
``conv3x3_same`` in fp32 (TF32 off), then K3's x0.5 with the TPU kernel's
two bf16 rounding points and the PReLU, cast once at the end. They launch
by plans computed here, which the CPU tests walk: P4 in bf16 by
``conv3x3_mma_plan`` (an implicit GEMM on the tensor cores, fed by cp.async
copies of its halo rows) or, for the heads (C_out <= 2),
``conv3x3_small_plan`` (the CUDA cores on the same staged rows) -
``mma_replay`` and ``small_replay`` repeat their addressing on the CPU -, P4
in fp32 by ``conv3x3_plan``; P5 in bf16 by ``half_mma_plan`` (P4's
tensor-core conv over the region its 3 x 16 output tile reads, with an
epilogue of the x0.5 and the PReLU), in fp32 by ``half_plan`` (the CUDA
cores).

Dispatch is by device only: a CPU tensor takes the plain version, a CUDA
tensor the kernel. Backward runs the plain version's autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from hvi_cidnet_torch.ops._build import (
    DTYPE_CODES,
    CudaKernel,
    check_input,
    scalar_pointer,
    sm_count,
    twin_backward,
    widest_vector,
)
from hvi_cidnet_torch.ops.conv import conv3x3_replpad, conv3x3_same, exact_fp32, prelu
from hvi_cidnet_torch.ops.resize import axis_weights, scale_half_f32
from hvi_cidnet_torch.utils import flops

_p, _i = ctypes.c_void_p, ctypes.c_int
CONV3X3 = CudaKernel("conv3x3", [_p] * 4 + [_i] * 17)
CONV3X3_HALF_PRELU = CudaKernel("conv3x3_half_prelu", [_p] * 4 + [_i] + [_p] * 3 + [_i] * 14)

PAD_MODES = ("zero", "edge")
MAX_GRID_X = 2**31 - 1
THREADS = 256                 # csrc/conv3x3.cu:kConvThreads, one conv pixel a thread
CI_STEP = 8                   # csrc/conv3x3.cu:kCiStep
CO_TILES = (12, 4)            # output channels a block (the kernel's instantiations)
TILE = (8, 32)                # P4: output rows x columns a block (kTileH, kTileW)
HALF_TILE = (3, 16)           # P5: half-size output rows x columns a block (kHalfH, kHalfW)
# P4 in bf16, the tensor-core arm (csrc/conv3x3.cu:conv3x3_mma_kernel)
MMA_TILE = (8, 32)            # output rows x columns a tile (kMmaTileH, kMmaTileW)
CHUNK = 16                    # input channels a chunk (kChunk)
MAX_GROUP = 72                # output channels a block (kMaxNT n8 tiles)
ROW = 16                      # elements a row of A and of a tap's weights (kRow): 32 bytes
RAW_GRANULES = 6              # 16-byte granules a staged row (kRawGran)
RAW_STAGE_BYTES = 2 * CHUNK * (MMA_TILE[0] + 2) * 8 * RAW_GRANULES + 4 * CHUNK * (MMA_TILE[0] + 2)
OUT_PITCH = MMA_TILE[0] * MMA_TILE[1] + 8   # the epilogue's [channel][pixel] (kOutPitch)
MIN_STAGES, MAX_STAGES = 3, 8  # the ring's (kMinStages, kMaxStages)
SMEM_LIMIT = 227 * 1024       # dynamic shared memory a block may take
SM_SMEM = 228 * 1024          # an SM's shared memory, 1 KB of it reserved a block
SMS = 132                     # H100 SXM; the wrapper passes the card's own count
SMALL_THREADS = 256           # the CUDA-core arm (kSmallThreads): 2 x 2 pixels a thread,
SMALL_PARTS = 4               # ... the input channels in 4 parts
# P5 in bf16, the tensor-core arm (csrc/conv3x3.cu:conv3x3_half_mma_kernel)
DN_TILE = (3, 16)             # half-size output rows x columns a tile (kDnTo, kDnTq)
DN_REGION = (2 * DN_TILE[0] + 1, 2 * DN_TILE[1] + 1)   # conv rows x columns it reads
DN_HALO = (DN_REGION[0] + 2, DN_REGION[1] + 2)         # input rows x columns it stages
DN_RAW_STAGE_BYTES = 2 * CHUNK * DN_HALO[0] * 8 * RAW_GRANULES + 4 * CHUNK * DN_HALO[0]
DN_EPI_NT = 3                 # n8 tiles the epilogue stages at a time (kDnEpiNT)
DN_EPI_PITCH = 260            # floats a channel's region there (kDnEpiPitch)


class ConvPlan(NamedTuple):
    """How P4 or P5 covers its output (``csrc/conv3x3.cu``).

    Block i owns output channels [g * co_tile, (g + 1) * co_tile) (those
    below C_out) of image i // (groups * tiles_y * tiles_x), with g = (i //
    (tiles_y * tiles_x)) % groups, and the tile_h x tile_w output tile at
    tile row (i // tiles_x) % tiles_y and column i % tiles_x (P5: of the
    half-size output); parts past the output are not written. P4 computes
    its tile's conv outputs one pixel a thread; P5 the (2 tile_h + 1) x
    (2 tile_w + 1) conv outputs that its tile's bilinear taps read."""

    co_tile: int
    tile_h: int
    tile_w: int
    tiles_y: int
    tiles_x: int
    groups: int
    blocks: int
    conv_pixels: int      # conv outputs a block computes (at most THREADS)
    smem_bytes: int       # static shared memory of a block


def _co_tile(cout: int) -> int:
    """12 output channels a block, or 4 where that leaves fewer idle (C_out
    of 1 to 4, the heads)."""
    return min(CO_TILES, key=lambda t: (-(-cout // t) * t - cout, -t))


def _plan(b: int, cout: int, oh: int, ow: int, tile: tuple, conv: tuple, smem_floats) -> ConvPlan:
    co_tile = _co_tile(cout)
    tiles_y, tiles_x = -(-oh // tile[0]), -(-ow // tile[1])
    groups = -(-cout // co_tile)
    blocks = b * groups * tiles_y * tiles_x
    if blocks > MAX_GRID_X:
        raise ValueError(f"conv3x3: {blocks} blocks, past the grid's limit")
    return ConvPlan(co_tile, *tile, tiles_y, tiles_x, groups, blocks, conv[0] * conv[1],
                    4 * smem_floats(co_tile))


@functools.lru_cache(maxsize=256)
def conv3x3_plan(b: int, cout: int, h: int, w: int) -> ConvPlan:
    """P4's launch plan for a (b, *, h, w) -> (b, cout, h, w) conv."""
    th, tw = TILE
    return _plan(b, cout, h, w, TILE, TILE,
                 lambda co: CI_STEP * (th + 2) * (tw + 2) + CI_STEP * 9 * co)


class MmaConvPlan(NamedTuple):
    """How P4's tensor-core arm (bf16) covers its output.

    Output channels go in ``groups`` groups of ``co_group`` (every channel
    in one where C_out <= 72), ``n_tiles`` n8 tiles each; the output in
    tiles of 8 x 32 pixels, ``tiles_y`` x ``tiles_x`` an image. ``blocks``
    persistent blocks: block i takes group i % groups and walks the tiles
    t = i // groups, i // groups + blocks // groups, ... (image t //
    (tiles_y tiles_x), tile row (t // tiles_x) % tiles_y, column t %
    tiles_x), one step a tile and chunk of 16 input channels (``chunks``
    a tile), through a ring of ``stages`` stages; every chunk's weights
    stay in shared memory where ``resident``, else each stage takes its
    chunk's. ``vec``: the elements of each output store (it divides W);
    ``pack_elements``: the packed weights' scratch."""

    co_group: int
    n_tiles: int
    groups: int
    chunks: int
    tile_h: int
    tile_w: int
    tiles_y: int
    tiles_x: int
    blocks: int
    vec: int
    smem_bytes: int
    blocks_per_sm: int
    pack_elements: int
    stages: int
    resident: bool
    threads: int = 256


def weights_bytes(n_tiles: int) -> int:
    """One chunk's weights in shared memory: 9 taps x 8 n_tiles channels x
    16 input channels."""
    return 2 * 9 * 8 * n_tiles * ROW


def epilogue_bytes(n_tiles: int) -> int:
    """The region of A[pixel][16] (10 x 34 pixels) and, over it after a
    tile's products, the epilogue's [channel][pixel] (csrc/conv3x3.cu:
    mma_epi_bytes)."""
    th, tw = MMA_TILE
    return 2 * max((th + 2) * (tw + 2) * ROW, 8 * n_tiles * OUT_PITCH)


def mma_smem_bytes(n_tiles: int, stages: int, wslots: int) -> int:
    """Dynamic shared memory of the tensor-core arm: ``wslots`` chunks of
    weights, ``stages`` stages of staged rows (16 channels x 10 rows x 6
    granules) and their offsets, the A / epilogue region."""
    return wslots * weights_bytes(n_tiles) + stages * RAW_STAGE_BYTES + epilogue_bytes(n_tiles)


def _mma_ring(n_tiles: int, chunks: int, stage_bytes: int = RAW_STAGE_BYTES,
              region_bytes: int = 0) -> tuple:
    """(blocks an SM, stages, resident): two blocks an SM where each keeps
    MIN_STAGES stages (the weights resident if they fit beside them, else a
    chunk a stage), else one block with as many as fit. ``stage_bytes``:
    a stage's staged rows and offsets; ``region_bytes``: the A / epilogue
    region (P4's by default)."""
    region = region_bytes or epilogue_bytes(n_tiles)
    for per_sm in (2, 1):
        budget = min(SMEM_LIMIT, SM_SMEM // per_sm - 1024)
        for resident in (True, False):
            fixed = region + (chunks * weights_bytes(n_tiles) if resident else 0)
            per_stage = stage_bytes + (0 if resident else weights_bytes(n_tiles))
            stages = min(MAX_STAGES, (budget - fixed) // per_stage)
            if stages >= MIN_STAGES:
                return per_sm, stages, resident
    raise AssertionError("unreachable: 72 channels stream in three stages")


@functools.lru_cache(maxsize=256)
def conv3x3_mma_plan(b: int, cin: int, cout: int, h: int, w: int, sms: int = SMS) -> MmaConvPlan:
    """P4's launch plan in bf16 for a (b, cin, h, w) -> (b, cout, h, w) conv
    on a card of ``sms`` SMs."""
    groups = -(-cout // MAX_GROUP)
    co_group = -(-cout // groups)
    n_tiles = -(-co_group // 8)
    th, tw = MMA_TILE
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    tiles, chunks = b * tiles_y * tiles_x, -(-cin // CHUNK)
    if tiles * chunks > MAX_GRID_X:
        raise ValueError(f"conv3x3: {tiles} tiles x {chunks} chunks, past the grid's limit")
    per_sm, stages, resident = _mma_ring(n_tiles, chunks)
    walkers = max(1, min(tiles, sms * per_sm // groups))
    return MmaConvPlan(co_group, n_tiles, groups, chunks, th, tw, tiles_y, tiles_x,
                       walkers * groups, widest_vector(w, 0, 2),
                       mma_smem_bytes(n_tiles, stages, chunks if resident else stages), per_sm,
                       groups * chunks * 9 * 8 * n_tiles * ROW, stages, resident)


class SmallConvPlan(NamedTuple):
    """How P4's CUDA-core arm (bf16; the heads, C_out <= 2) covers its
    output: the tensor arm's 8 x 32 tiles, chunks and ring of staged rows,
    ``blocks`` persistent blocks of 256 threads, block i walking the tiles
    i, i + blocks, ...; thread t computes the 2 x 2 pixels at output rows 2
    (t % 64 // 16) + {0, 1}, columns 2 (t % 16) + {0, 1} of a tile over the
    input channels of parity t // 64 modulo 4, the four parts summed at the
    tile's end."""

    chunks: int
    tile_h: int
    tile_w: int
    tiles_y: int
    tiles_x: int
    blocks: int
    smem_bytes: int
    blocks_per_sm: int
    stages: int


def uses_small_arm(cin: int, cout: int) -> bool:
    """The heads (C_out <= 2) take the CUDA-core arm: on the tensor cores N
    would be padded to 8 and every staged pixel re-read for each tap, for 1
    or 2 products a pixel and tap."""
    return cout <= 2


def small_smem_bytes(cout: int, chunks: int, stages: int) -> int:
    """Dynamic shared memory of the CUDA-core arm (csrc/conv3x3.cu:
    small_smem_bytes): the weights in fp32, three parts' sums, the ring's
    stages of staged rows and their offsets."""
    return 4 * chunks * CHUNK * 9 * cout + 4 * (SMALL_PARTS - 1) * 64 * 4 * cout + \
        stages * RAW_STAGE_BYTES


@functools.lru_cache(maxsize=256)
def conv3x3_small_plan(b: int, cin: int, cout: int, h: int, w: int,
                       sms: int = SMS) -> SmallConvPlan:
    """P4's launch plan in bf16 on the CUDA cores (C_out <= 2): as many
    blocks an SM (at most 4) as keep MIN_STAGES stages each, as many stages
    as fit."""
    if not 1 <= cout <= 2:
        raise ValueError(f"conv3x3: the CUDA-core arm takes C_out 1 or 2, got {cout}")
    th, tw = MMA_TILE
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    tiles, chunks = b * tiles_y * tiles_x, -(-cin // CHUNK)
    if tiles * chunks > MAX_GRID_X:
        raise ValueError(f"conv3x3: {tiles} tiles x {chunks} chunks, past the grid's limit")
    for per_sm in (4, 3, 2, 1):
        budget = min(SMEM_LIMIT, SM_SMEM // per_sm - 1024)
        stages = min(MAX_STAGES, (budget - small_smem_bytes(cout, chunks, 0)) // RAW_STAGE_BYTES)
        if stages >= MIN_STAGES:
            break
    else:
        raise ValueError(f"conv3x3: C_in={cin} leaves no room for the ring")
    return SmallConvPlan(chunks, th, tw, tiles_y, tiles_x, max(1, min(tiles, sms * per_sm)),
                         small_smem_bytes(cout, chunks, stages), per_sm, stages)


def swz(r: int, h: int) -> int:
    """csrc/conv3x3.cu:swz: element offset of half h (8 elements) of row r
    of a tile of 32-byte rows; the halves swap every 4 rows."""
    return r * ROW + 8 * (h ^ ((r >> 2) & 1))


def pack_weights_plain(w: torch.Tensor, plan: MmaConvPlan) -> torch.Tensor:
    """What csrc/conv3x3.cu:conv3x3_pack_kernel writes, flat: row (g, k,
    tap, n) holds w[g co_group + n][16 k + e][tap // 3][tap % 3] for e in
    [0, 16), its halves at swz(n, e // 8) of its (g, k, tap) block; zero
    past the group, C_out and C_in."""
    cout, cin = w.shape[:2]
    ng = 8 * plan.n_tiles
    wp = w.new_zeros((plan.groups, ng, plan.chunks * CHUNK, 9))
    for g in range(plan.groups):
        lo, hi = g * plan.co_group, min((g + 1) * plan.co_group, cout)
        wp[g, :hi - lo, :cin] = w[lo:hi].reshape(hi - lo, cin, 9)
    rows = wp.view(plan.groups, ng, plan.chunks, CHUNK, 9).permute(0, 2, 4, 1, 3)
    flat = w.new_zeros((plan.groups, plan.chunks, 9, ng * ROW))
    for n in range(ng):
        for half in range(2):
            at = swz(n, half)
            flat[..., at:at + 8] = rows[:, :, :, n, 8 * half:8 * half + 8]
    return flat.reshape(-1)


def _staged_rows(flat, offset: int, img: int, cin: int, h: int, w: int, k: int, r0: int,
                 lo: int, hi: int, edge: bool) -> dict:
    """csrc/conv3x3.cu:stage_rows replayed on ``flat`` (x flattened after
    ``offset`` zeros: its start, in elements past a 16-byte boundary):
    (ci, r) -> (the row's granules, the offset of column lo in them), or
    None for a row of zeros. Checks the granules fit the stage's row."""
    th = MMA_TILE[0]
    rows = {}
    for ci in range(CHUNK):
        c = k * CHUNK + ci
        for r in range(th + 2):
            gy = r0 - 1 + r
            if edge:
                gy = min(max(gy, 0), h - 1)
            if c >= cin or not 0 <= gy < h:
                rows[ci, r] = None
                continue
            start = offset + ((img * cin + c) * h + gy) * w + lo
            g0 = start // 8 * 8  # 16-byte granules of 8 elements
            granules = -(-(start + hi - lo - g0) // 8)
            assert granules <= RAW_GRANULES
            rows[ci, r] = (flat[g0:g0 + 8 * granules], start - g0)
    return rows


def _tiles(plan, b: int, groups: int):
    """(group, image, r0, c0) of each tile each block walks, in its order."""
    per_img = plan.tiles_y * plan.tiles_x
    walkers = plan.blocks // groups
    for blk in range(plan.blocks):
        for t in range(blk // groups, b * per_img, walkers):
            img, rem = divmod(t, per_img)
            yield (blk % groups, img, rem // plan.tiles_x * plan.tile_h,
                   rem % plan.tiles_x * plan.tile_w)


def _window(rows, ci: int, r: int, col: int, lo: int, w: int, edge: bool) -> float:
    """One input value as the kernels read it: staged row (ci, r), column
    ``col`` clamped (edge pad) or zero outside the image."""
    row = rows[ci, r]
    if row is None:
        return 0.0
    if not 0 <= col < w:
        if not edge:
            return 0.0
        col = min(max(col, 0), w - 1)
    data, o = row
    assert 0 <= col - lo + o < len(data)
    return data[col - lo + o]


def mma_replay(x: torch.Tensor, w: torch.Tensor, pad_mode: str, offset: int = 0) -> tuple:
    """P4's tensor-core arm replayed on the CPU with its addressing, tile by
    tile in each block's order: x flattened as the card sees it
    (``offset``: its start, in elements past a 16-byte boundary); each
    staged row as the 16-byte granules the kernel copies and the offset it
    keeps; the clamped or zeroed halo written into the swizzled
    channel-minor tile A; each tap's A slice read at the swizzled rows of
    its pixel shift, as ldmatrix reads them; the packed weights read the
    same way; the products summed in float64 (the card sums in fp32, in an
    order not repeated here), rounded once to x's dtype. Returns the output
    and the times each output element was written."""
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    edge = pad_mode == "edge"
    plan = conv3x3_mma_plan(b, cin, cout, h, wd)
    th, tw = plan.tile_h, plan.tile_w
    hw_, ng = tw + 2, 8 * plan.n_tiles
    flat = torch.cat([x.new_zeros(offset), x.reshape(-1), x.new_zeros(16)]).double()
    wp = pack_weights_plain(w, plan).double().view(plan.groups, plan.chunks, 9, ng * ROW)
    out = torch.zeros((b, cout, h, wd), dtype=torch.float64)
    writes = torch.zeros((b, cout, h, wd), dtype=torch.int64)
    for g, img, r0, c0 in _tiles(plan, b, plan.groups):
        lo, hi = max(c0 - 1, 0), min(c0 + tw + 1, wd)
        acc = torch.zeros((th * tw, ng), dtype=torch.float64)
        for k in range(plan.chunks):
            rows = _staged_rows(flat, offset, img, cin, h, wd, k, r0, lo, hi, edge)
            a_flat = torch.zeros((th + 2) * hw_ * ROW, dtype=torch.float64)
            for ci in range(CHUNK):
                for r in range(th + 2):
                    for hc in range(hw_):
                        a_flat[swz(r * hw_ + hc, ci // 8) + ci % 8] = _window(
                            rows, ci, r, c0 - 1 + hc, lo, wd, edge)
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                px = [(pr + dy) * hw_ + pc + dx for pr in range(th) for pc in range(tw)]
                a = torch.stack([torch.cat([a_flat[swz(p, 0):swz(p, 0) + 8],
                                            a_flat[swz(p, 1):swz(p, 1) + 8]]) for p in px])
                wt = wp[g, k, tap]
                bmat = torch.stack([torch.cat([wt[swz(n, 0):swz(n, 0) + 8],
                                               wt[swz(n, 1):swz(n, 1) + 8]]) for n in range(ng)])
                acc += a @ bmat.T
        co0 = g * plan.co_group
        cgr = min(plan.co_group, cout - co0)
        rows_, cols = min(th, h - r0), min(tw, wd - c0)
        res = acc[:, :cgr].T.reshape(cgr, th, tw)[:, :rows_, :cols]
        out[img, co0:co0 + cgr, r0:r0 + rows_, c0:c0 + cols] = res
        writes[img, co0:co0 + cgr, r0:r0 + rows_, c0:c0 + cols] += 1
    return out.to(x.dtype), writes


def small_replay(x: torch.Tensor, w: torch.Tensor, pad_mode: str, offset: int = 0) -> tuple:
    """P4's CUDA-core arm replayed on the CPU with its addressing: the same
    staged rows as the tensor arm (``_staged_rows``), each 2 x 2 block of
    pixels and its 4 x 4 window read from them (the row's offset, the column
    clamped or zeroed); sums in float64, one rounding.
    Returns the output and the times each output element was written."""
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    edge = pad_mode == "edge"
    plan = conv3x3_small_plan(b, cin, cout, h, wd)
    th, tw = plan.tile_h, plan.tile_w
    flat = torch.cat([x.new_zeros(offset), x.reshape(-1), x.new_zeros(16)]).double()
    w64 = w.double()
    out = torch.zeros((b, cout, h, wd), dtype=torch.float64)
    writes = torch.zeros((b, cout, h, wd), dtype=torch.int64)
    for _, img, r0, c0 in _tiles(plan, b, 1):
        lo, hi = max(c0 - 1, 0), min(c0 + tw + 1, wd)
        co0, cos = 0, range(cout)
        acc = torch.zeros((cout, th, tw), dtype=torch.float64)
        for k in range(plan.chunks):
            rows = _staged_rows(flat, offset, img, cin, h, wd, k, r0, lo, hi, edge)
            for t in range(64):  # a 2 x 2 block of pixels (its four parts together)
                r, c = 2 * (t // 16), 2 * (t % 16)
                for ci in range(min(CHUNK, cin - k * CHUNK)):
                    win = torch.tensor([[_window(rows, ci, r + i, c0 - 1 + c + j, lo, wd, edge)
                                         for j in range(4)] for i in range(4)],
                                       dtype=torch.float64)
                    wt = w64[list(cos), k * CHUNK + ci]  # (co, 3, 3)
                    for dy in range(2):
                        for dx in range(2):
                            acc[:, r + dy, c + dx] += (wt * win[dy:dy + 3, dx:dx + 3]).sum((1, 2))
        rows_, cols = min(th, h - r0), min(tw, wd - c0)
        out[img, co0:co0 + len(cos), r0:r0 + rows_, c0:c0 + cols] = acc[:, :rows_, :cols]
        writes[img, co0:co0 + len(cos), r0:r0 + rows_, c0:c0 + cols] += 1
    return out.to(x.dtype), writes


def dn_region_bytes() -> int:
    """The region of P5's A[pixel][16] (9 x 35 halo pixels) and, over it,
    DN_EPI_NT n8 tiles of its fp32 conv region (csrc/conv3x3.cu:
    dn_epi_bytes)."""
    return max(2 * DN_HALO[0] * DN_HALO[1] * ROW, 4 * 8 * DN_EPI_NT * DN_EPI_PITCH)


def half_mma_smem_bytes(n_tiles: int, stages: int, wslots: int) -> int:
    """Dynamic shared memory of P5's tensor-core arm (csrc/conv3x3.cu:
    dn_smem_bytes): ``wslots`` chunks of weights, ``stages`` stages of
    staged rows (16 channels x 9 rows x 6 granules) and their offsets, the
    A / epilogue region."""
    return wslots * weights_bytes(n_tiles) + stages * DN_RAW_STAGE_BYTES + dn_region_bytes()


@functools.lru_cache(maxsize=256)
def half_mma_plan(b: int, cin: int, cout: int, h: int, w: int, sms: int = SMS) -> MmaConvPlan:
    """P5's launch plan in bf16 for a (b, cin, h, w) input, (b, cout, h //
    2, w // 2) output, on a card of ``sms`` SMs: P4's channel groups, ring
    and persistent walkers over tiles of 3 x 16 half-size outputs (``tile_h``
    x ``tile_w``; each reads a 7 x 33 conv region). ``vec`` is 1: the
    output is stored an element a thread. ``threads``: 256 (two m16 tiles a
    warp) where two blocks share an SM, else 512 (one a warp)."""
    groups = -(-cout // MAX_GROUP)
    co_group = -(-cout // groups)
    n_tiles = -(-co_group // 8)
    th, tw = DN_TILE
    tiles_y, tiles_x = -(-(h // 2) // th), -(-(w // 2) // tw)
    tiles, chunks = b * tiles_y * tiles_x, -(-cin // CHUNK)
    if tiles * chunks > MAX_GRID_X:
        raise ValueError(f"P5: {tiles} tiles x {chunks} chunks, past the grid's limit")
    per_sm, stages, resident = _mma_ring(n_tiles, chunks, DN_RAW_STAGE_BYTES, dn_region_bytes())
    walkers = max(1, min(tiles, sms * per_sm // groups))
    return MmaConvPlan(co_group, n_tiles, groups, chunks, th, tw, tiles_y, tiles_x,
                       walkers * groups, 1,
                       half_mma_smem_bytes(n_tiles, stages, chunks if resident else stages),
                       per_sm, groups * chunks * 9 * 8 * n_tiles * ROW, stages, resident,
                       256 if per_sm == 2 else 512)


@functools.lru_cache(maxsize=256)
def half_plan(b: int, cout: int, h: int, w: int) -> ConvPlan:
    """P5's launch plan for a (b, *, h, w) input, (b, cout, h // 2, w // 2)
    output."""
    th, tw = HALF_TILE
    rh, rw = 2 * th + 1, 2 * tw + 1
    return _plan(b, cout, h // 2, w // 2, HALF_TILE, (rh, rw),
                 lambda co: CI_STEP * (rh + 2) * (rw + 2) + CI_STEP * 9 * co + co * rh * rw)


# --------------------------------------------------------------------------
# P4: dense 3x3
# --------------------------------------------------------------------------


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """Plain version of P4: the port's zero-padded or replication-padded 3x3
    conv, in the activation dtype."""
    return conv3x3_same(x, w) if pad_mode == "zero" else conv3x3_replpad(x, w)


def _weight(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    cin = x.shape[1]
    if w.dim() != 4 or tuple(w.shape[1:]) != (cin, 3, 3) or w.device != x.device:
        raise ValueError(f"w: expected a (C_out, {cin}, 3, 3) weight on {x.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    w = w.to(x.dtype)
    if not w.is_contiguous():
        raise ValueError("w: expected a contiguous tensor")
    return w


def _check_pad(pad_mode: str) -> None:
    if pad_mode not in PAD_MODES:
        raise ValueError(f"pad_mode {pad_mode!r} is not one of {PAD_MODES}")


def conv3x3_kernel(x: torch.Tensor, w: torch.Tensor, pad_mode: str) -> torch.Tensor:
    """Launch P4 on contiguous NCHW ``x`` on the card: bf16 on the tensor
    cores (``conv3x3_mma_plan``), the heads (C_out <= 2) on the CUDA cores
    (``conv3x3_small_plan``), fp32 on the CUDA cores (``conv3x3_plan``)."""
    _check_pad(pad_mode)
    check_input(x, "x", 4)
    b, cin, h, wd = x.shape
    w = _weight(w, x)
    cout = w.shape[0]
    if max(cin, cout) * h * wd >= 2**31:
        raise ValueError(f"x: P4 takes images below 2**31 elements, got {tuple(x.shape)}")
    out = torch.empty((b, cout, h, wd), dtype=x.dtype, device=x.device)
    edge = int(pad_mode == "edge")
    if x.dtype == torch.bfloat16 and uses_small_arm(cin, cout):
        plan = conv3x3_small_plan(b, cin, cout, h, wd, sm_count(x.device))
        CONV3X3(x.device, x.data_ptr(), w.data_ptr(), None, out.data_ptr(), DTYPE_CODES[x.dtype],
                b, cin, cout, h, wd, edge, cout, plan.tiles_x, plan.tiles_y, 1, 0,
                plan.smem_bytes, plan.blocks, plan.stages, 0, 1)
    elif x.dtype == torch.bfloat16:
        plan = conv3x3_mma_plan(b, cin, cout, h, wd, sm_count(x.device))
        wpack = torch.empty(plan.pack_elements, dtype=x.dtype, device=x.device)
        CONV3X3(x.device, x.data_ptr(), w.data_ptr(), wpack.data_ptr(), out.data_ptr(),
                DTYPE_CODES[x.dtype], b, cin, cout, h, wd, edge, plan.co_group, plan.tiles_x,
                plan.tiles_y, plan.groups, plan.vec, plan.smem_bytes, plan.blocks, plan.stages,
                int(plan.resident), 0)
    else:
        plan = conv3x3_plan(b, cout, h, wd)
        CONV3X3(x.device, x.data_ptr(), w.data_ptr(), None, out.data_ptr(), DTYPE_CODES[x.dtype],
                b, cin, cout, h, wd, edge, plan.co_tile, plan.tiles_x, plan.tiles_y, plan.groups,
                0, 0, 0, 0, 0, 0)
    return out



class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, pad_mode):
        ctx.save_for_backward(x, w)
        ctx.pad_mode = pad_mode
        return conv3x3_kernel(x, w, pad_mode)

    @staticmethod
    def backward(ctx, grad):
        fn = lambda x, w: conv3x3_plain(x, w, ctx.pad_mode)
        return (*twin_backward(fn, ctx.saved_tensors, grad, ctx.needs_input_grad[:2]), None)


def conv3x3(x: torch.Tensor, w: torch.Tensor, pad_mode: str = "zero") -> torch.Tensor:
    """Dense 3x3 stride-1 conv, zero SAME padding or the replication pad.
    CPU: plain; CUDA: P4."""
    with flops.kernel("P4", x, cout=w.shape[0]):
        _check_pad(pad_mode)
        if x.device.type == "cpu":
            return conv3x3_plain(x, w, pad_mode)
        return _Conv3x3.apply(x, w, pad_mode)


# --------------------------------------------------------------------------
# P5: conv 3x3 -> bilinear x0.5 -> PReLU
# --------------------------------------------------------------------------


def conv3x3_half_prelu_plain(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain version of P5: ``conv3x3_same`` in fp32 with TF32 off (the
    weight taken in the activation dtype, then widened); K3's x0.5 with the
    TPU kernel's rounding points (``experiments/fused_pallas_nhcw.py:98``,
    ``:153``): the H pass with K3's fp32 taps, its rows cast to the
    activation dtype and back, the W pass with the taps so cast, fp32 sums;
    the PReLU in fp32, one cast to the activation dtype. In fp32 the casts
    are the identity: K3's plain x0.5 + PReLU."""
    dt = x.dtype
    with exact_fp32():
        y = conv3x3_same(x.float(), w.to(dt).float())
    return prelu(scale_half_f32(y, round_to=dt), alpha).to(dt)


def conv3x3_half_prelu_kernel(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Launch P5 on contiguous NCHW ``x`` on the card: bf16 on the tensor
    cores (``half_mma_plan``), fp32 on the CUDA cores (``half_plan``)."""
    check_input(x, "x", 4)
    b, cin, h, wd = x.shape
    if h < 2 or wd < 2:
        raise ValueError(f"x: bilinear x0.5 needs H, W >= 2, got shape {tuple(x.shape)}")
    w = _weight(w, x)
    cout = w.shape[0]
    if max(cin, cout) * h * wd >= 2**31:
        raise ValueError(f"x: P5 takes images below 2**31 elements, got {tuple(x.shape)}")
    out = torch.empty((b, cout, h // 2, wd // 2), dtype=x.dtype, device=x.device)
    taps = (axis_weights("half", h, x.device).data_ptr(),
            axis_weights("half", wd, x.device).data_ptr(),
            scalar_pointer(alpha, x.device, "prelu slope"), b, cin, cout, h, wd)
    if x.dtype == torch.bfloat16:
        plan = half_mma_plan(b, cin, cout, h, wd, sm_count(x.device))
        wpack = torch.empty(plan.pack_elements, dtype=x.dtype, device=x.device)
        CONV3X3_HALF_PRELU(x.device, x.data_ptr(), w.data_ptr(), wpack.data_ptr(), out.data_ptr(),
                           DTYPE_CODES[x.dtype], *taps, plan.co_group, plan.tiles_x,
                           plan.tiles_y, plan.groups, plan.smem_bytes, plan.blocks, plan.stages,
                           int(plan.resident), plan.threads)
    else:
        plan = half_plan(b, cout, h, wd)
        CONV3X3_HALF_PRELU(x.device, x.data_ptr(), w.data_ptr(), None, out.data_ptr(),
                           DTYPE_CODES[x.dtype], *taps, plan.co_tile, plan.tiles_x, plan.tiles_y,
                           plan.groups, 0, 0, 0, 0, 0)
    return out


class _Conv3x3HalfPrelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, alpha):
        ctx.save_for_backward(x, w, alpha)
        return conv3x3_half_prelu_kernel(x, w, alpha)

    @staticmethod
    def backward(ctx, grad):
        return twin_backward(conv3x3_half_prelu_plain, ctx.saved_tensors, grad,
                             ctx.needs_input_grad)


def conv3x3_half_prelu(x: torch.Tensor, w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """NormDownsample's conv, x0.5 and PReLU in one pass. CPU: plain; CUDA:
    P5."""
    with flops.kernel("P5", x, cout=w.shape[0]):
        if x.device.type == "cpu":
            return conv3x3_half_prelu_plain(x, w, alpha)
        return _Conv3x3HalfPrelu.apply(x, w, alpha)
