"""P6: the im2col conv products, their plain version, the dispatcher
``im2col_dots`` and the probe route's dense 3x3 conv ``conv3x3_im2col``.

Counterpart of ``experiments/flat_pilot_r3.py:pallas_im2col_dots`` (P6):
``out[b] = wmat a[b]`` for a staged (B, K, N) operand and a (C_out, K)
weight, fp32 accumulation, out (B, C_out, N) in a's type. P6 takes one
(K, N) operand, drops the columns past its last full tile and reads K and
C_out from its module's globals; the port takes a batch, any N, any K and
C_out <= 144. The kernel is ``csrc/im2col_gemm.cu``: bf16 a pipelined
GEMM on the tensor cores (``wgmma``, persistent blocks, a ring of stages
fed by the TMA unit, or by ``cp.async`` where the operand's rows are not
16-byte aligned; W packed once a call), fp32 on the CUDA cores; its launch
plan is ``im2col_plan``, which the CPU tests walk. The plain version is one
fp32 ``matmul`` with TF32 off, rounded once.

``conv3x3_im2col`` is a dense 3x3 stride-1 conv the way the probe route
runs it: the operand staged by plain ops (``F.unfold`` with zero padding,
or the replication pad and then ``F.unfold``), whose (c, kh, kw) row order
is that of the OIHW weight reshaped to (C_out, C_in * 9); P6's products;
the result viewed as (B, C_out, H, W). The operand (9 C_in values a pixel)
is freed when the conv returns.

Dispatch is by device only: a CPU tensor takes the plain version, a CUDA
tensor the kernel. Backward runs the plain version's autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from hvi_cidnet_torch.ops._build import (
    DTYPE_CODES,
    CudaKernel,
    check_input,
    sm_count,
    twin_backward,
    widest_vector,
)
from hvi_cidnet_torch.ops.conv import exact_fp32
from hvi_cidnet_torch.utils import flops

# csrc/im2col_gemm.cu
THREADS = 256
N_TILE = {2: 256, 4: 128}  # output columns a tile, by itemsize
MAX_COUT = 144          # fp32: 9 tiles of 16 output channels; bf16: two groups of 72
K_STEP = {2: 64, 4: 32}  # K rows staged a step, by itemsize
MIN_STAGES, MAX_STAGES = 3, 6  # bf16: the ring's
GROUP_ROWS = 128        # bf16: rows of W a block (two m64 tiles)
OP_STAGE_BYTES = 2 * K_STEP[2] * N_TILE[2]  # bf16: a stage's operand, 32 KB
OUT_PITCH_BYTES = 2 * N_TILE[2] + 16  # bf16, TMA: the staged output tile's rows
SMEM_LIMIT = 227 * 1024
SMS = 132               # H100 SXM; the wrapper passes the card's own count
MAX_GRID_X = 2**31 - 1
MAX_GRID_Y = 65535
PAD_MODES = ("zero", "edge")


class Im2colPlan(NamedTuple):
    """How P6 covers a (b, k, n) operand.

    fp32: grid (n_tiles, b); block (x, i) writes columns [128 x, 128 x +
    128) of image i for every output channel, C_out padded to ``m_tiles``
    tiles of 16 and K to whole ``k_step``s with zero weights.

    bf16: ``blocks`` persistent blocks, one an SM; block i holds rows [g
    rows, g rows + rows) of W (g = i % groups, rows = ceil(C_out / groups),
    padded to ``m_tiles`` tiles of 16: 64 or 128 rows, one or two m64 tiles
    of wgmma) and walks the tiles t = i // groups, i // groups + blocks //
    groups, ... of the b * n_tiles (image, 256-column) tiles, one step a
    64-deep slice of K through a ring of ``stages`` stages, writing its rows
    of each. Where ``vec`` is 8 (rows 16-byte aligned) the TMA unit loads
    the steps and bulk stores write the tiles through a staged tile, else
    every thread copies with cp.async. ``pack_elements``: the scratch of
    W's packed slices.

    ``vec``: elements a copy of the operand (the widest, at most 16 bytes,
    that N and its start allow)."""

    n_tiles: int
    m_tiles: int
    k_step: int
    k_steps: int
    vec: int
    blocks: int
    smem_bytes: int
    groups: int = 1
    stages: int = 0
    pack_elements: int = 0


def smem_bytes(itemsize: int, m_tiles: int, stages: int = MIN_STAGES, tma: bool = False) -> int:
    """bf16: the ring's ``stages`` (a step of the operand, 64 x 256, and W's
    64-deep slice of 16 m_tiles rows), with the TMA unit the staged output
    tile (16 m_tiles rows) and a barrier a stage, and 1 KB to align them;
    fp32: the step's (32 x 128) and its weights (32 x 16 m_tiles)."""
    if itemsize == 2:
        return stages * (OP_STAGE_BYTES + 2 * 16 * m_tiles * K_STEP[2]) + 1024 + (
            16 * m_tiles * OUT_PITCH_BYTES + 8 * stages if tma else 0)
    return 4 * (K_STEP[4] * N_TILE[4] + K_STEP[4] * 16 * m_tiles)


@functools.lru_cache(maxsize=256)
def im2col_plan(b: int, cout: int, k: int, n: int, itemsize: int, offset: int = 0,
                sms: int = SMS) -> Im2colPlan:
    """P6's launch plan for a (b, k, n) operand of ``itemsize`` bytes (4:
    fp32, 2: bf16) that starts ``offset`` bytes past a 16-byte boundary,
    C_out ``cout`` (the output aligned) and a card of ``sms`` SMs."""
    if not (1 <= cout <= MAX_COUT and k >= 1 and n >= 1 and b >= 1):
        raise ValueError(f"P6: takes 1 <= C_out <= {MAX_COUT}, K, N >= 1; got C_out={cout}, "
                         f"K={k}, N={n}, B={b}")
    if itemsize not in K_STEP:
        raise ValueError(f"P6: itemsize {itemsize} (fp32 or bf16 only)")
    n_tiles = -(-n // N_TILE[itemsize])
    step = K_STEP[itemsize]
    k_steps = -(-k // step)
    if b > MAX_GRID_Y or b * n_tiles * k_steps > MAX_GRID_X:
        raise ValueError(f"P6: B={b}, N={n} need a grid past the card's limits")
    vec = widest_vector(n, offset, itemsize)
    if itemsize == 4:
        m_tiles = -(-cout // 16)
        return Im2colPlan(n_tiles, m_tiles, step, k_steps, vec, n_tiles * b,
                          smem_bytes(itemsize, m_tiles))
    groups = -(-cout // GROUP_ROWS)
    m_tiles = 4 * -(-(-(-cout // groups)) // 64)
    tma = vec == 8
    fixed, per_stage = smem_bytes(2, m_tiles, 0, tma), smem_bytes(2, m_tiles, 1, tma)
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // (per_stage - fixed))
    walkers = max(1, min(b * n_tiles, sms // groups))
    return Im2colPlan(n_tiles, m_tiles, step, k_steps, vec, walkers * groups,
                      smem_bytes(2, m_tiles, stages, tma), groups, stages,
                      groups * k_steps * 16 * m_tiles * step)


_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
IM2COL_DOTS = CudaKernel("im2col_dots", [_p, _p, _p, _p, _i, _i64, _i, _i, _i64, _i, _i, _i64,
                                          _i64, _i, _i64, _i])


def im2col_dots_plain(a: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """Plain version of P6: the weight in a's type, both widened, one fp32
    ``matmul`` (TF32 off), rounded once to a's type."""
    with exact_fp32():
        out = torch.matmul(wmat.to(a.dtype).float(), a.float())
    return out.to(a.dtype)


def im2col_dots_kernel(a: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """Launch P6 on a contiguous (B, K, N) operand on the card."""
    check_input(a, "a", 3)
    b, k, n = a.shape
    if wmat.dim() != 2 or wmat.shape[1] != k or wmat.device != a.device:
        raise ValueError(f"wmat: expected a (C_out, {k}) weight on {a.device}, got "
                         f"{tuple(wmat.shape)} on {wmat.device}")
    wmat = wmat.to(a.dtype)
    if not wmat.is_contiguous():
        raise ValueError("wmat: expected a contiguous tensor")
    cout = wmat.shape[0]
    out = torch.empty((b, cout, n), dtype=a.dtype, device=a.device)
    plan = im2col_plan(b, cout, k, n, a.element_size(), a.data_ptr() % 16, sm_count(a.device))
    wpack = (torch.empty(plan.pack_elements, dtype=a.dtype, device=a.device)
             if plan.pack_elements else None)
    IM2COL_DOTS(a.device, a.data_ptr(), wmat.data_ptr(),
                wpack.data_ptr() if wpack is not None else None, out.data_ptr(),
                DTYPE_CODES[a.dtype], b, k, cout, n, plan.m_tiles, plan.vec, plan.n_tiles,
                plan.smem_bytes, plan.groups, plan.blocks, plan.stages)
    return out



class _Im2colDots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, wmat):
        ctx.save_for_backward(a, wmat)
        return im2col_dots_kernel(a, wmat)

    @staticmethod
    def backward(ctx, grad):
        return twin_backward(im2col_dots_plain, ctx.saved_tensors, grad, ctx.needs_input_grad)


def im2col_dots(a: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """``wmat a[b]`` for each image b of a (B, K, N) operand. CPU: plain;
    CUDA: P6."""
    with flops.kernel("P6", a, cout=wmat.shape[0]):
        if a.device.type == "cpu":
            return im2col_dots_plain(a, wmat)
        return _Im2colDots.apply(a, wmat)


def stage_3x3(x: torch.Tensor, pad_mode: str = "zero") -> torch.Tensor:
    """The (B, 9 C_in, H W) im2col operand of a 3x3 stride-1 conv of NCHW
    ``x``, zero SAME padding or the replication pad ("edge")."""
    if pad_mode not in PAD_MODES:
        raise ValueError(f"pad_mode {pad_mode!r} is not one of {PAD_MODES}")
    if pad_mode == "zero":
        return F.unfold(x, 3, padding=1)
    return F.unfold(F.pad(x, (1, 1, 1, 1), mode="replicate"), 3)


def conv3x3_im2col(x: torch.Tensor, w: torch.Tensor, pad_mode: str = "zero") -> torch.Tensor:
    """Dense 3x3 stride-1 conv (OIHW ``w``) as the staged operand and P6's
    products (the plain version on the CPU)."""
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    wmat = w.to(x.dtype).reshape(cout, cin * 9).contiguous()
    return im2col_dots(stage_3x3(x, pad_mode), wmat).view(b, cout, h, wd)
