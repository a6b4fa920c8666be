"""K6: the channel LayerNorm kernel, its plain twin and the dispatcher
``layer_norm``.

Counterpart of ``hvi_cidnet_tpu/ops/norm_pallas.py``. The kernel is
``csrc/norm.cu`` and takes a contiguous NCHW activation (fp32 or bf16) and
the LayerNorm's fp32 weight and bias; the twin is
``ops/conv.py:layer_norm_channels`` (fp32: the exact two-pass form; bf16:
fp32 statistics, bf16 apply), whose arithmetic the kernel repeats op for op.

The kernel launches by a plan computed here (``layer_norm_plan``: pixels
per thread, lanes per channel row, thread groups, channels per thread,
shared memory), which the CPU tests walk.

Dispatch is by device only: a CPU tensor takes the plain twin, a CUDA
tensor the kernel. Backward runs the twin's autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from hvi_cidnet_torch.ops._build import DTYPE_CODES, CudaKernel, check_input, twin_backward
from hvi_cidnet_torch.ops.conv import layer_norm_channels

EPS = 1e-6
MAX_CHANNELS = 256   # 16 groups of 32 lanes x 18 channels a thread
SMS = 132            # streaming multiprocessors of an H100 SXM
MAX_THREADS = 512    # csrc/norm.cu:kMaxThreads
PLAN_THREADS = 256   # the plans' largest block: 512-thread blocks ran slower on the card
LOAD_BYTES = 8       # the plans' widest load: 16-byte loads ran slower on the card
MAX_GRID_X = 2**31 - 1
CHANNELS_PER_THREAD = (9, 18)  # the kernel's instantiations (csrc/norm.cu)
MIN_ROW_BYTES = 32   # bytes of one channel row a warp reads at once: one sector

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
LAYER_NORM = CudaKernel(
    "layer_norm_channels", [_p, _p, _i, _p, _p, _i64, _i, _i64, ctypes.c_float] + [_i] * 5
)


class LayerNormPlan(NamedTuple):
    """How K6 covers a (b, c, hw) tensor (``csrc/norm.cu``).

    Block i owns pixels [t * pixels, (t + 1) * pixels) of image i // tiles,
    t = i % tiles, pixels = lanes * vec. Thread (g, l) = (t // lanes, t %
    lanes) loads pixels [l * vec, (l + 1) * vec) of the block's span in
    channels g, g + groups, ... below c (at most ``channels_per_thread``)."""

    vec: int                  # pixels a thread takes with one load (LOAD_BYTES at most)
    lanes: int                # threads along the pixels, a power of two
    groups: int               # thread groups along the channels
    channels_per_thread: int
    threads: int
    tiles: int                # blocks per image
    blocks: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def layer_norm_plan(b: int, c: int, hw: int, itemsize: int, address: int = 0) -> LayerNormPlan:
    """K6's launch plan. ``vec`` is the widest load (up to LOAD_BYTES) that
    the plane pitch and the tensor's ``address`` keep aligned; the block's
    span (lanes x vec pixels, from 32 x vec down) is the widest whose grid
    fills the card (``SMS`` blocks), where a warp still reads a whole sector
    of each channel row; the channels spread over enough groups that a
    thread holds at most 9 (18 past C = 9 * PLAN_THREADS / lanes, and up
    to 512 threads past 18 * PLAN_THREADS / lanes). Only
    ``address % LOAD_BYTES`` matters: pass that, so that the cache stays
    small."""
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"K6: C must be in [1, {MAX_CHANNELS}], got {c}")
    vec = LOAD_BYTES // itemsize
    while vec > 1 and (hw % vec or address % (vec * itemsize)):
        vec //= 2
    spans = sorted(((lanes, v) for lanes in (32, 16, 8) for v in (4, 2, 1)
                    if v <= vec and lanes * v * itemsize >= MIN_ROW_BYTES),
                   key=lambda s: (-s[0] * s[1], -s[1])) or [(32, vec)]
    lanes, v = next((s for s in spans if b * -(-hw // (s[0] * s[1])) >= SMS), spans[-1])
    per_warp = 32 // lanes
    groups = min(-(-c // CHANNELS_PER_THREAD[0]), PLAN_THREADS // lanes)
    if groups * CHANNELS_PER_THREAD[-1] < c:  # past C = 18 * PLAN_THREADS / lanes
        groups = min(-(-c // CHANNELS_PER_THREAD[-1]), MAX_THREADS // lanes)
    groups = -(-groups // per_warp) * per_warp  # whole warps
    cpt = next(n for n in CHANNELS_PER_THREAD if n * groups >= c)
    pixels = lanes * v
    tiles = -(-hw // pixels)
    blocks = b * tiles
    if blocks > MAX_GRID_X:
        raise ValueError(f"K6: {blocks} blocks, past the grid's limit")
    return LayerNormPlan(v, lanes, groups, cpt, lanes * groups, tiles, blocks,
                         (2 * groups * pixels + 2 * pixels) * 4)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Twin of K6."""
    return layer_norm_channels(x, weight, bias, EPS)


def _check_affine(t: torch.Tensor, c: int, device: torch.device, name: str) -> None:
    if t.dtype != torch.float32 or t.device != device or t.numel() != c or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected {c} contiguous fp32 values on {device}, got {tuple(t.shape)} "
            f"{t.dtype} on {t.device}"
        )


def layer_norm_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch K6 on contiguous NCHW ``x`` on the card."""
    check_input(x, "x", 4)
    b, c, h, w = x.shape
    if c > MAX_CHANNELS:
        raise ValueError(f"x: the LayerNorm kernel takes C <= {MAX_CHANNELS}, got {c}")
    _check_affine(weight, c, x.device, "weight")
    _check_affine(bias, c, x.device, "bias")
    plan = layer_norm_plan(b, c, h * w, x.element_size(), x.data_ptr() % LOAD_BYTES)
    out = torch.empty_like(x)
    LAYER_NORM(
        x.device, x.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype], weight.data_ptr(),
        bias.data_ptr(), b, c, h * w, EPS, plan.vec, plan.lanes, plan.groups,
        plan.channels_per_thread, plan.smem_bytes,
    )
    return out


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return layer_norm_kernel(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        return twin_backward(layer_norm_plain, ctx.saved_tensors, grad, ctx.needs_input_grad)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Channel LayerNorm of the LCA blocks. CPU: twin; CUDA: K6."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias)
    return _LayerNorm.apply(x, weight, bias)
