"""K3 and K4: fused bilinear x0.5 + PReLU and bilinear x2 kernels, their
plain twins and the dispatchers ``half_prelu`` / ``double_bilinear``.

Counterpart of ``hvi_cidnet_tpu/ops/resize_pallas.py``. The kernels are
``csrc/resize.cu`` and take contiguous NCHW activations. Kernels and twins
(``ops/resize.py``) use the same float64-derived fp32 band weights, uploaded
once per (size, device), the same tap order (H pass, then W pass) and fp32
arithmetic with one rounding to the activation dtype at the end, after
K3's shared-slope PReLU. Both launch by plans computed here (``half_plan``
and ``double_plan``: block shape, load or store width, grid), which the
CPU tests walk.

Dispatch is by device only: a CPU tensor takes the plain twin, a CUDA
tensor the kernel. Backward runs the twin's autograd.

In a row group (``parallel/rows.py``) each shard resizes its own rows as a
band: K3 takes the shard's rows and the first row of the next shard
(output rows [a, a + m) read source rows [2a, 2a + 2m]) and K4 the shard's
rows with one halo row each side, its outer outputs cropped; both with the
H-axis taps cut from the whole image's table (``resize.band_taps``), so a
band's rows are, bit for bit, the whole plane's. The kernels run unchanged:
they take their tables as pointers.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from hvi_cidnet_torch.ops._build import (
    DTYPE_CODES,
    CudaKernel,
    check_input,
    scalar_pointer,
    twin_backward,
    widest_vector,
)
from hvi_cidnet_torch.ops.conv import prelu
from hvi_cidnet_torch.ops.resize import axis_weights, band_taps, scale_double_f32, scale_half_f32
from hvi_cidnet_torch.parallel import rows

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
HALF_PRELU = CudaKernel("resize_half_prelu",
                        [_p, _p, _i, _p, _p, _p, _i64, _i64, _i64, _i, _i, _i, _i, _i, _i])
DOUBLE = CudaKernel("resize_double",
                    [_p, _p, _i, _p, _p, _i64, _i64, _i64, _i, _i, _i, _i, _i, _i])


# --------------------------------------------------------------------------
# K3: bilinear x0.5 + PReLU
# --------------------------------------------------------------------------


def half_prelu_plain(x: torch.Tensor, alpha: torch.Tensor,
                     h_taps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Twin of K3: ``prelu(UpsamplingBilinear2d(0.5)(x), alpha)``, in fp32.
    ``h_taps``: a row band's H-axis weights (``resize.band_taps``)."""
    return prelu(scale_half_f32(x, h_taps), alpha).to(x.dtype)


SMS = 132                # streaming multiprocessors of an H100 SXM
MAX_GRID_X = 2**31 - 1   # CUDA's limit on gridDim.x
# K3: threads a block may take (csrc/resize.cu:kMaxHalfThreads); the widest
# thread row (a row of more chunks is cut into column groups); the threads
# a block aims at; output rows a thread may walk, most first; and the
# threads the grid should hold (512 per SM, each with its next step's two
# row loads in flight). From a sweep of plans on the card: whole rows per
# thread row, ~128-thread blocks and 4 rows a thread beat 64-chunk thread
# rows, 256-thread blocks and 8 rows over the three sites, in bf16 and
# fp32, at batch 1 and 8.
HALF_MAX_THREADS = 512
HALF_MAX_TX = 128
HALF_BLOCK = 128
HALF_ROWS = (4, 2, 1)
HALF_MIN_THREADS = 512 * SMS


class HalfPlan(NamedTuple):
    """How K3 covers a (planes, h // 2, w // 2) output (``csrc/resize.cu``).

    Block (tx, ty), a 1-D grid of planes * gy * gz blocks; block b is (p, by,
    bz) with b = (p * gy + by) * gz + bz. Its thread (tx_i, ty_i) owns output
    columns [c0, c0 + chunk) with c0 = (bz * tx + tx_i) * chunk, and output
    rows [i0, i0 + rows_per_thread) with i0 = (by * ty + ty_i) *
    rows_per_thread; parts past the plane are skipped. Per source row a
    thread reads its 2 * chunk columns as vectors of ``load`` elements (one,
    or two of one element) and the halo column after them; it writes its
    chunk as one vector. ``load`` divides w, so the chunks tile the output
    row exactly.
    """

    chunk: int            # output columns per thread: load // 2 (1 for a 1-element load)
    load: int             # elements per vector load of a source row
    tx: int
    ty: int
    rows_per_thread: int
    grid: tuple           # (planes, gy, gz); planes * gy * gz blocks


@functools.lru_cache(maxsize=256)
def half_plan(planes: int, h: int, w: int, itemsize: int, offset: int = 0) -> HalfPlan:
    """K3's launch plan for ``planes`` planes of h x w whose tensor starts
    ``offset`` bytes past a 16-byte boundary (the output is a fresh
    allocation). Cached per shape: at batch 1 the host's work per launch
    sets the pace.

    Loads take the widest vector the source row pitch and the base allow,
    and a thread the output columns of one load, which it stores as one
    vector (the chunk divides w // 2). A thread row covers a whole
    output row where it has at most 128 chunks (else the row is cut into
    column groups); a block takes the rows of threads that come nearest to
    128 threads; each thread walks 4 output rows, or 2 or 1 where the grid
    would otherwise hold fewer than HALF_MIN_THREADS threads.
    """
    ho, wo = h // 2, w // 2
    load = widest_vector(w, offset, itemsize)
    chunk = max(1, load // 2)
    chunks = -(-wo // chunk)
    gz = -(-chunks // HALF_MAX_TX)
    tx = -(-chunks // gz)
    rows = next((r for r in HALF_ROWS if planes * chunks * -(-ho // r) >= HALF_MIN_THREADS), 1)
    bands = -(-ho // rows)
    ty = max(1, min(bands, round(HALF_BLOCK / tx)))
    gy = -(-bands // ty)
    if planes * gy * gz > MAX_GRID_X:
        raise ValueError(f"K3: {planes} planes of {h} x {w} need more than {MAX_GRID_X} blocks")
    return HalfPlan(chunk, load, tx, ty, rows, (planes, gy, gz))


def _check_taps(taps: torch.Tensor, kinds: int, count: int, x: torch.Tensor) -> torch.Tensor:
    if tuple(taps.shape) != (kinds, count) or taps.dtype != torch.float32 \
            or taps.device != x.device or not taps.is_contiguous():
        raise ValueError(f"h_taps: expected contiguous ({kinds}, {count}) fp32 weights on "
                         f"{x.device}, got {tuple(taps.shape)} {taps.dtype} on {taps.device}")
    return taps


def half_prelu_kernel(x: torch.Tensor, alpha: torch.Tensor,
                      h_taps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3 on contiguous NCHW ``x`` on the card; ``h_taps`` as the
    twin's."""
    check_input(x, "x", 4)
    b, c, h, w = x.shape
    if h < 2 or w < 2:
        raise ValueError(f"x: bilinear x0.5 needs H, W >= 2, got shape {tuple(x.shape)}")
    if h * w >= 2**31:
        raise ValueError(f"x: K3 takes planes below 2**31 elements, got {h} x {w}")
    out = torch.empty((b, c, h // 2, w // 2), dtype=x.dtype, device=x.device)
    plan = half_plan(b * c, h, w, x.element_size(), x.data_ptr() % 16)
    taps = (axis_weights("half", h, x.device) if h_taps is None
            else _check_taps(h_taps, 3, h // 2, x))
    HALF_PRELU(
        x.device, x.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype], taps.data_ptr(),
        axis_weights("half", w, x.device).data_ptr(),
        scalar_pointer(alpha, x.device, "prelu slope"), b * c, h, w,
        plan.load, plan.tx, plan.ty, plan.rows_per_thread, *plan.grid[1:],
    )
    return out


class _HalfPrelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x, alpha)
        return half_prelu_kernel(x, alpha)

    @staticmethod
    def backward(ctx, grad):
        x, alpha = ctx.saved_tensors
        return twin_backward(half_prelu_plain, (x, alpha), grad, ctx.needs_input_grad)


def half_prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """NormDownsample's tail: bilinear x0.5 then PReLU. CPU: twin; CUDA: K3.
    In a row group, on the shard's band (forward only)."""
    shard = rows.current()
    if shard is not None:
        m = x.shape[-2]
        band, _ = shard.extend(x, 0, 1)
        taps = band_taps("half", m * shard.size, shard.rank * m // 2, m // 2, x.device)
        if x.device.type == "cpu":
            return half_prelu_plain(band, alpha, taps)
        return half_prelu_kernel(band, alpha, taps)
    if x.device.type == "cpu":
        return half_prelu_plain(x, alpha)
    return _HalfPrelu.apply(x, alpha)


# --------------------------------------------------------------------------
# K4: bilinear x2
# --------------------------------------------------------------------------


def double_bilinear_plain(x: torch.Tensor, h_taps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Twin of K4: ``UpsamplingBilinear2d(2)(x)``, in fp32. ``h_taps``: a
    row band's H-axis weights (``resize.band_taps``)."""
    return scale_double_f32(x, h_taps).to(x.dtype)


# K4's block: a warp covers 32 chunks (512 contiguous bytes) of one output
# row; each thread walks 2 source rows. On the card, narrower warps were
# slower at every site of the 600 x 400 forward, while the rows per thread
# and the warps per block mattered little.
DOUBLE_BLOCK = (32, 4)
DOUBLE_ROWS = 2


class DoublePlan(NamedTuple):
    """How K4 covers a (planes, 2h, 2w) output (``csrc/resize.cu``).

    Block (tx, ty), a 1-D grid of planes * gy * gz blocks; block b is (p, by,
    bz) with b = (p * gy + by) * gz + bz. Its thread (tx_i, ty_i) owns output
    columns [c0, c0 + chunk) with c0 = (bz * tx + tx_i) * chunk, and source
    rows [j0, j0 + rows_per_thread) with j0 = (by * ty + ty_i) *
    rows_per_thread, each giving output rows 2j and 2j + 1; parts past the
    plane are skipped. Stores are ``store`` elements wide.
    """

    chunk: int            # output columns per thread: 16 bytes
    store: int            # elements per vector store
    tx: int
    ty: int
    rows_per_thread: int
    grid: tuple           # (planes, gy, gz); planes * gy * gz blocks


def double_plan(planes: int, h: int, w: int, itemsize: int) -> DoublePlan:
    """K4's launch plan: the widest aligned store the output row allows
    (2w is even, so a pair always fits) and enough blocks to cover it."""
    chunk = 16 // itemsize
    store = chunk
    while (2 * w) % store:
        store //= 2
    tx, ty = DOUBLE_BLOCK
    chunks = -(-2 * w // chunk)
    gy, gz = -(-h // (ty * DOUBLE_ROWS)), -(-chunks // tx)
    if planes * gy * gz > MAX_GRID_X:
        raise ValueError(f"K4: {planes} planes of {h} x {w} need more than {MAX_GRID_X} blocks")
    return DoublePlan(chunk, store, tx, ty, DOUBLE_ROWS, (planes, gy, gz))


def double_bilinear_kernel(x: torch.Tensor, h_taps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K4 on contiguous NCHW ``x`` on the card; ``h_taps`` as the
    twin's."""
    check_input(x, "x", 4)
    b, c, h, w = x.shape
    if h * w >= 2**31:
        raise ValueError(f"x: K4 takes planes below 2**31 elements, got {h} x {w}")
    out = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    plan = double_plan(b * c, h, w, x.element_size())
    taps = axis_weights("double", h, x.device) if h_taps is None else _check_taps(h_taps, 4, h, x)
    DOUBLE(
        x.device, x.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype], taps.data_ptr(),
        axis_weights("double", w, x.device).data_ptr(),
        b * c, h, w, plan.store, plan.tx, plan.ty, plan.rows_per_thread, *plan.grid[1:],
    )
    return out


class _Double(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return double_bilinear_kernel(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return twin_backward(double_bilinear_plain, (x,), grad, ctx.needs_input_grad)


def double_bilinear(x: torch.Tensor) -> torch.Tensor:
    """NormUpsample's bilinear x2. CPU: twin; CUDA: K4. In a row group, on
    the shard's band (forward only)."""
    shard = rows.current()
    if shard is not None:
        m = x.shape[-2]
        band, top = shard.extend(x, 1, 1)
        taps = band_taps("double", m * shard.size, shard.rank * m - top, band.shape[-2], x.device)
        out = (double_bilinear_plain(band, taps) if x.device.type == "cpu"
               else double_bilinear_kernel(band, taps))
        return out[..., 2 * top:2 * (top + m), :]
    if x.device.type == "cpu":
        return double_bilinear_plain(x)
    return _Double.apply(x)
