"""P1: channel attention per (image, head), its plain version and the
dispatcher ``head_attention``.

Counterpart of ``experiments/attn_kernel_probe_r2.py:attn_pallas`` (P1):
for each row g of (G, c, N) q, k, v (G = batch * heads, c = C / heads),
the c x c scores q k^T over N in fp32, scaled by rsqrt(max(|q_r|^2,
1e-24)) and rsqrt(max(|k_c|^2, 1e-24)) (F.normalize of q and k, hoisted
past the product) and by ``temps[g % heads]``, an fp32 softmax per row,
the matrix rounded to v's type, then ``A v`` with fp32 accumulation,
rounded once to q's type. P1 bakes one temperature in as a Python float
and has no heads: per head this is exactly its function. ``project_out``
is not folded in: the probe route runs it after, as a 1x1 conv
(``models/layers.py:CAB``).

The kernel is ``csrc/head_attention.cu``: one launch, a cluster of
``splits`` blocks per g on the score core of ``csrc/qk_scores.cuh``
(``ops/batched_qk_cuda.py`` holds its plan), the sums met in a fixed order
through distributed shared memory, then each block's softmax and apply on
its own columns. The plain version runs the same steps as fp32 ``bmm``s
with TF32 off.

Dispatch is by device only: a CPU tensor takes the plain version, a CUDA
tensor the kernel. Backward runs the plain version's autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from hvi_cidnet_torch.ops import batched_qk_cuda as qk
from hvi_cidnet_torch.ops._build import DTYPE_CODES, CudaKernel, twin_backward
from hvi_cidnet_torch.ops.conv import exact_fp32


def at_offset(c: int, itemsize: int) -> int:
    """Bytes before A^T in shared memory: the score core with norms, the
    cluster's fp32 sums, rounded up to a 16-byte boundary."""
    return -(-(qk.core_bytes(c, True, itemsize) + 4 * qk.entries(c, True)) // 16) * 16


class HeadAttentionPlan(NamedTuple):
    """How P1 covers a (g, c, n) call: grid (splits, g) in clusters of
    ``splits``; block (s, i) sums the scores and norms over columns
    [s * chunk, (s + 1) * chunk) of row i, takes the cluster's sums, and
    applies the softmax to the same columns of v. The score core loads
    ``vec`` elements at a time, the apply one column a thread, or two
    adjacent ones where ``vec`` > 1. ``cm``: the kernel's rows (c_max), the
    pitch of A^T in shared memory and the apply's registers."""

    splits: int
    chunk: int
    blocks: int
    side_tiles: int
    slices: int
    vec: int
    cm: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def head_attention_plan(g: int, c: int, n: int, itemsize: int = 2,
                        offset: int = 0) -> HeadAttentionPlan:
    """P1's launch plan for (g, c, n) q, k, v and out of ``itemsize``
    bytes whose starts lie ``offset`` bytes (or-ed) past 16-byte
    boundaries."""
    qk.check_shape(g, c, n, "P1")
    splits, chunk = qk.split_n(g, n)
    cm = qk.c_max(c)
    smem = at_offset(c, itemsize) + 4 * c * cm
    if smem > qk.SMEM_LIMIT:
        raise ValueError(f"P1: {smem} bytes of shared memory at c={c}, past a block's limit")
    return HeadAttentionPlan(splits, chunk, splits * g, qk.side_tiles(c), qk.slices(c),
                             qk.load_vec(n, itemsize, offset), cm, smem)


_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
HEAD_ATTENTION = CudaKernel("head_attention",
                            [_p, _p, _p, _p, _i, _p, _i, _i64, _i, _i64, _i, _i64, _i, _i64])


def attention_matrix(q: torch.Tensor, k: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
    """P1's (G, c, c) softmax matrix in fp32, before the rounding to v's
    type (fp32 ``bmm``, TF32 off)."""
    g = q.shape[0]
    heads = temps.numel()
    with exact_fp32():
        q32, k32 = q.float(), k.float()
        s = torch.bmm(q32, k32.transpose(1, 2))
    inv_q = torch.rsqrt(q32.square().sum(-1).clamp_min(1e-24))
    inv_k = torch.rsqrt(k32.square().sum(-1).clamp_min(1e-24))
    t = temps.reshape(heads).float().repeat(g // heads)
    s = s * inv_q[:, :, None] * inv_k[:, None, :] * t[:, None, None]
    return torch.softmax(s, dim=-1)


def head_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         temps: torch.Tensor) -> torch.Tensor:
    """Plain version of P1: ``attention_matrix`` rounded to v's type, then
    an fp32 ``bmm`` (TF32 off), rounded once to q's type."""
    a = attention_matrix(q, k, temps).to(v.dtype)
    with exact_fp32():
        out = torch.bmm(a.float(), v.float())
    return out.to(q.dtype)


def head_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          temps: torch.Tensor) -> torch.Tensor:
    """Launch P1 on contiguous (G, c, N) q, k, v on the card."""
    qk.check_qk(q, k, "P1")
    qk.check_qk(q, v, "P1 (v)")
    g, c, n = q.shape
    heads = temps.numel()
    if temps.dtype != torch.float32 or temps.device != q.device or not temps.is_contiguous() \
            or heads < 1 or g % heads:
        raise ValueError(f"temps: expected contiguous fp32 values on {q.device}, one a head, "
                         f"G={g} a multiple of their count; got {tuple(temps.shape)} "
                         f"{temps.dtype} on {temps.device}")
    out = torch.empty_like(q)
    offset = (q.data_ptr() | k.data_ptr() | v.data_ptr() | out.data_ptr()) % 16
    plan = head_attention_plan(g, c, n, q.element_size(), offset)
    HEAD_ATTENTION(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   DTYPE_CODES[q.dtype], temps.data_ptr(), heads, g, c, n, plan.splits,
                   plan.chunk, plan.vec, plan.smem_bytes)
    return out


class _HeadAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, temps):
        ctx.save_for_backward(q, k, v, temps)
        return head_attention_kernel(q, k, v, temps)

    @staticmethod
    def backward(ctx, grad):
        return twin_backward(head_attention_plain, ctx.saved_tensors, grad, ctx.needs_input_grad)


def head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   temps: torch.Tensor) -> torch.Tensor:
    """Per-(image, head) channel attention of (G, c, N) q, k, v, q and k
    normalised; ``temps``: one fp32 temperature a head, row g taking
    ``temps[g % heads]``. CPU: plain; CUDA: P1."""
    if q.device.type == "cpu":
        return head_attention_plain(q, k, v, temps)
    return _HeadAttention.apply(q, k, v, temps)
