"""K1 and K2: the fused HVI transform kernels, their plain twins and the
dispatchers the model calls.

Counterpart of ``hvi_cidnet_tpu/ops/hvi_pallas.py`` (``rgb_to_hvi_pallas_hwcb``
and ``hvi_to_rgb_pallas_hwcb``, the default path of the JAX forward). The
kernels are ``csrc/hvi.cu``; they also absorb the layout change at the
model's boundary:

* ``rgb_to_hvi``: NHWC RGB (B, H, W, 3) -> NCHW HVI (B, 3, H, W) in
  ``out_dtype`` (the compute dtype);
* ``hvi_to_rgb``: NCHW HVI -> NHWC RGB, in the input's dtype.

K1 and K2 launch by plans computed here (``rgb_to_hvi_plan``,
``hvi_to_rgb_plan``: vector width, pixels per block, grid), which the CPU
tests walk.

Dispatch is by device only: a CPU tensor takes the plain twin, a CUDA
tensor the kernel (which raises on anything it does not take). The kernel
paths are ``autograd.Function``s whose backward runs the twin's autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from hvi_cidnet_torch.ops import hvi as _hvi
from hvi_cidnet_torch.ops._build import (
    DTYPE_CODES,
    CudaKernel,
    check_input,
    scalar_pointer,
    twin_backward,
    widest_vector,
)
from hvi_cidnet_torch.utils import flops

_p, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
RGB_TO_HVI = CudaKernel("hvi_rgb_to_hvi", [_p, _i, _p, _i, _p, _i64, _i64, _i, _i, _i])
HVI_TO_RGB = CudaKernel("hvi_hvi_to_rgb", [_p, _p, _i, _p, _i64, _i64, _i, _i, _i, _i, _i, _f, _f])


# --------------------------------------------------------------------------
# K1: RGB -> HVI
# --------------------------------------------------------------------------


def rgb_to_hvi_plain(img: torch.Tensor, k: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Twin of K1: NHWC RGB -> NCHW HVI, computed in fp32, rounded to the
    input dtype (as the JAX twin returns) and then to ``out_dtype``."""
    return _hvi.rgb_to_hvi(img, k).permute(0, 3, 1, 2).to(out_dtype).contiguous()


SMS = 132                 # streaming multiprocessors of an H100 SXM
RGB_THREADS = 256         # csrc/hvi.cu:kRgbThreads, the block size of K1 and K2
RGB_PIXELS = (4, 2, 1)    # pixels per thread, most first
RGB_MIN_BLOCKS = 16 * SMS  # two full SMs' worth of 256-thread blocks each
RGB_SMEM = 48 * 1024      # shared memory a block takes without opting in
MAX_GRID_Y = 65535        # CUDA's limit on gridDim.y (the images)


class PixelRunPlan(NamedTuple):
    """How K1 or K2 covers ``batch`` images of H * W pixels (``csrc/hvi.cu``).

    A 2-D grid of (runs, batch) blocks of RGB_THREADS threads; block (x, y)
    owns pixels [x * run, (x + 1) * run) of image y (the last run of an
    image is cut at H * W); its thread t converts pixels t, t + RGB_THREADS,
    ... K2 loads the run of each plane in ``vec``-pixel vectors and writes
    the run's RGB lines in 16-byte vectors; K1 loads the run's RGB lines in
    16-byte vectors and stores the run of each plane in ``vec``-pixel
    vectors.
    """

    vec: int              # pixels per vector access of a plane
    run: int              # pixels per block: RGB_THREADS * pixels per thread
    grid: tuple           # (runs, batch)
    smem_bytes: int       # the plane runs and the RGB lines of one run


def _pixel_run_plan(batch: int, hw: int, vec: int, smem, name: str) -> PixelRunPlan:
    """Blocks of RGB_THREADS threads; each thread takes the most pixels of
    4, 2, 1 that still give the grid 16 blocks per SM (a pixel is ~260
    instructions in long dependent chains: the card needs many threads in
    flight; on the card 2 pixels a thread were fastest for K2 at batch 8, 4
    at 32, 1 at batch 1, and K1's sweep came within 2% of its best plan in
    bf16), and whose run fits 48 KB of shared memory (``smem(run)`` bytes)."""
    if batch > MAX_GRID_Y:
        raise ValueError(f"{name}: {batch} images, past the grid's limit of {MAX_GRID_Y}")
    fits = [p for p in RGB_PIXELS if smem(RGB_THREADS * p) <= RGB_SMEM]
    per_thread = next((p for p in fits if batch * -(-hw // (RGB_THREADS * p)) >= RGB_MIN_BLOCKS),
                      fits[-1])
    run = RGB_THREADS * per_thread
    return PixelRunPlan(vec, run, (-(-hw // run), batch), smem(run))


@functools.lru_cache(maxsize=256)
def rgb_to_hvi_plan(batch: int, hw: int, in_itemsize: int, out_itemsize: int,
                    out_offset: int = 0) -> PixelRunPlan:
    """K1's plan for ``batch`` images of ``hw`` pixels whose output starts
    ``out_offset`` bytes past a 16-byte boundary. The store vector is the
    widest (up to 16 bytes) that divides H * W and the offset, so every
    plane's rows start aligned. The input needs nothing of the plan: each
    block finds its line's offset from a 16-byte boundary itself. Cached per
    shape: at batch 1 the host's work per launch sets the pace."""
    vec = widest_vector(hw, out_offset, out_itemsize)
    smem = lambda run: 3 * run * out_itemsize + (3 * run + 16 // in_itemsize) * in_itemsize
    return _pixel_run_plan(batch, hw, vec, smem, "K1")


def rgb_to_hvi_kernel(img: torch.Tensor, k: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Launch K1 on ``img`` (contiguous (B, H, W, 3) on the card)."""
    check_input(img, "img", 4)
    b, h, w, c = img.shape
    if c != 3:
        raise ValueError(f"img: expected 3 channels last, got shape {tuple(img.shape)}")
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} not supported (float32 or bfloat16)")
    if 3 * h * w >= 2**31:
        raise ValueError(f"img: K1 takes images below 2**31 / 3 pixels, got {h} x {w}")
    out = torch.empty((b, 3, h, w), dtype=out_dtype, device=img.device)
    plan = rgb_to_hvi_plan(b, h * w, img.element_size(), out.element_size(), out.data_ptr() % 16)
    RGB_TO_HVI(
        img.device, img.data_ptr(), DTYPE_CODES[img.dtype],
        out.data_ptr(), DTYPE_CODES[out_dtype],
        scalar_pointer(k, img.device, "density_k"), b, h * w, plan.vec, plan.run, plan.grid[0],
    )
    return out


class _RgbToHvi(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, k, out_dtype):
        ctx.save_for_backward(img, k)
        ctx.out_dtype = out_dtype
        return rgb_to_hvi_kernel(img, k, out_dtype)

    @staticmethod
    def backward(ctx, grad):
        img, k = ctx.saved_tensors
        grads = twin_backward(
            lambda i, kk: rgb_to_hvi_plain(i, kk, ctx.out_dtype),
            (img, k), grad, ctx.needs_input_grad[:2],
        )
        return (*grads, None)


def rgb_to_hvi(img: torch.Tensor, k: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """HVIT: NHWC RGB -> NCHW HVI. CPU: the twin; CUDA: K1."""
    with flops.kernel("K1", img):
        if img.device.type == "cpu":
            return rgb_to_hvi_plain(img, k, out_dtype)
        return _RgbToHvi.apply(img, k, out_dtype)


# --------------------------------------------------------------------------
# K2: HVI -> RGB
# --------------------------------------------------------------------------


def hvi_to_rgb_plain(
    hvi: torch.Tensor, k: torch.Tensor, *, gated: bool = False, gated2: bool = False,
    alpha: float = 1.0, alpha_s: float = 1.3,
) -> torch.Tensor:
    """Twin of K2: NCHW HVI -> NHWC RGB in ``hvi.dtype``."""
    rgb = _hvi.hvi_to_rgb(
        hvi, k, gated=gated, gated2=gated2, alpha=alpha, alpha_s=alpha_s, channel_dim=1
    )
    return rgb.permute(0, 2, 3, 1).contiguous()


@functools.lru_cache(maxsize=256)
def hvi_to_rgb_plan(batch: int, hw: int, itemsize: int, offset: int = 0) -> PixelRunPlan:
    """K2's plan for ``batch`` images of ``hw`` pixels whose tensor starts
    ``offset`` bytes past a 16-byte boundary. The load vector is the widest
    (up to 16 bytes) that divides H * W and the offset, so every plane's
    rows start aligned. Cached per shape."""
    vec = widest_vector(hw, offset, itemsize)
    smem = lambda run: (6 * run + 16 // itemsize) * itemsize
    return _pixel_run_plan(batch, hw, vec, smem, "K2")


def hvi_to_rgb_kernel(
    hvi: torch.Tensor, k: torch.Tensor, *, gated: bool = False, gated2: bool = False,
    alpha: float = 1.0, alpha_s: float = 1.3,
) -> torch.Tensor:
    """Launch K2 on ``hvi`` (contiguous (B, 3, H, W) on the card)."""
    check_input(hvi, "hvi", 4)
    b, c, h, w = hvi.shape
    if c != 3:
        raise ValueError(f"hvi: expected 3 channels at dim 1, got shape {tuple(hvi.shape)}")
    if 3 * h * w >= 2**31:
        raise ValueError(f"hvi: K2 takes images below 2**31 / 3 pixels, got {h} x {w}")
    out = torch.empty((b, h, w, 3), dtype=hvi.dtype, device=hvi.device)
    plan = hvi_to_rgb_plan(b, h * w, hvi.element_size(), hvi.data_ptr() % 16)
    HVI_TO_RGB(
        hvi.device, hvi.data_ptr(), out.data_ptr(), DTYPE_CODES[hvi.dtype],
        scalar_pointer(k, hvi.device, "density_k"), b, h * w, plan.vec, plan.run, plan.grid[0],
        int(bool(gated)), int(bool(gated2)), float(alpha), float(alpha_s),
    )
    return out


class _HviToRgb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hvi, k, gates):
        ctx.save_for_backward(hvi, k)
        ctx.gates = gates
        return hvi_to_rgb_kernel(hvi, k, **gates)

    @staticmethod
    def backward(ctx, grad):
        hvi, k = ctx.saved_tensors
        grads = twin_backward(
            lambda x, kk: hvi_to_rgb_plain(x, kk, **ctx.gates),
            (hvi, k), grad, ctx.needs_input_grad[:2],
        )
        return (*grads, None)


def hvi_to_rgb(
    hvi: torch.Tensor, k: torch.Tensor, *, gated: bool = False, gated2: bool = False,
    alpha: float = 1.0, alpha_s: float = 1.3,
) -> torch.Tensor:
    """PHVIT: NCHW HVI -> NHWC RGB. ``k`` detached by the caller, as the
    reference's PHVIT read a Python float. CPU: the twin; CUDA: K2."""
    gates = dict(gated=gated, gated2=gated2, alpha=alpha, alpha_s=alpha_s)
    with flops.kernel("K2", hvi):
        if hvi.device.type == "cpu":
            return hvi_to_rgb_plain(hvi, k, **gates)
        return _HviToRgb.apply(hvi, k, gates)
