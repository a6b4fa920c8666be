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
(``ops/batched_qk_cuda.py`` holds its plans), the sums met in a fixed order
through distributed shared memory, then each block's softmax and apply on
its own columns. fp32 runs on the CUDA cores (``head_attention_plan``);
bf16 on the tensor cores, scores and apply (``mma_plan``; ``mma_replay``
repeats its addressing on the CPU). The plain version runs
the same steps as fp32 ``bmm``s with TF32 off.

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
from hvi_cidnet_torch.utils import flops


def at_offset(c: int, itemsize: int) -> int:
    """Bytes before A^T in shared memory: the score core with norms, the
    cluster's fp32 sums, rounded up to a 16-byte boundary."""
    return -(-(qk.core_bytes(c, True, itemsize) + 4 * qk.entries(c, True)) // 16) * 16


class HeadAttentionPlan(NamedTuple):
    """How P1's fp32 arm covers a (g, c, n) call: grid (splits, g) in clusters of
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
def head_attention_plan(g: int, c: int, n: int, offset: int = 0) -> HeadAttentionPlan:
    """P1's fp32 launch plan for (g, c, n) q, k, v and out whose starts lie
    ``offset`` bytes (or-ed) past 16-byte boundaries."""
    qk.check_shape(g, c, n, "P1")
    splits, chunk = qk.split_n(g, n)
    cm = qk.c_max(c)
    smem = at_offset(c, 4) + 4 * c * cm
    if smem > qk.SMEM_LIMIT:
        raise ValueError(f"P1: {smem} bytes of shared memory at c={c}, past a block's limit")
    return HeadAttentionPlan(splits, chunk, splits * g, qk.side_tiles(c), qk.slices(c),
                             qk.load_vec(n, 4, offset), cm, smem)


def mma_plan(g: int, c: int, n: int, clusters: tuple, offset: int = 0) -> qk.MmaPlan:
    """P1's bf16 launch plan (``batched_qk_cuda.mma_plan`` with the norms,
    the softmax and the apply) on a card with ``clusters``."""
    return qk.mma_plan(g, c, n, clusters, offset, norms=True, name="P1")


_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
HEAD_ATTENTION = CudaKernel("head_attention",
                            [_p, _p, _p, _p, _i, _p, _i, _i64, _i, _i64, _i, _i64, _i, _i, _i64])


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
    if q.dtype == torch.bfloat16:
        plan = mma_plan(g, c, n, qk.card_clusters(q.device, True, c), offset)
        stages = plan.stages
    else:
        plan, stages = head_attention_plan(g, c, n, offset), 0
    HEAD_ATTENTION(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   DTYPE_CODES[q.dtype], temps.data_ptr(), heads, g, c, n, plan.splits,
                   plan.chunk, plan.vec, stages, plan.smem_bytes)
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
    with flops.kernel("P1", q, c=q.shape[1]):
        if q.device.type == "cpu":
            return head_attention_plain(q, k, v, temps)
        return _HeadAttention.apply(q, k, v, temps)


def mma_replay(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, temps: torch.Tensor,
               clusters: tuple, offset: int = 0) -> tuple:
    """P1's bf16 arm replayed on the CPU under the plan a card with
    ``clusters`` runs, in float64 but for its two roundings to bf16: the
    score core (``batched_qk_cuda.replay_sums``: every block of a cluster
    holds the same sums), the softmax, A rounded to bf16 and built into
    each lane's m16 x k16 fragments (rows and columns zero past c), v
    through the apply's ring (``apply_stages``, the first ones issued after
    the scores), each warp's 32 columns of a step from ldmatrix.trans rows
    (warp w the columns 32 w, 32 (w + WARPS) of a stage), the accumulators
    rounded to bf16 into the output tile at each row's shift, and the
    tile's 16-byte chunks written out (their ragged ends element by
    element). q, k, v: (G, c, N) bf16 at
    ``offset`` elements past a 16-byte boundary, out aligned. Returns the
    output (bf16), the times each (g, column) fed a score product and each
    output element was written."""
    g_count, c, n = q.shape
    heads = temps.numel()
    plan = mma_plan(g_count, c, n, clusters, 2 * offset % 16)
    direct = plan.vec == 8
    sums, seen = qk.replay_sums(q, k, plan, offset, norms=True)
    s = sums[:, :c * c].view(g_count, c, c)
    inv_q = torch.rsqrt(sums[:, c * c:c * c + c].clamp_min(1e-24))
    inv_k = torch.rsqrt(sums[:, c * c + c:].clamp_min(1e-24))
    t = temps.double().repeat(g_count // heads)
    a = torch.softmax(s * inv_q[:, :, None] * inv_k[:, None, :] * t[:, None, None], -1)
    a = a.to(v.dtype).double()
    mt = -(-plan.n_tiles // 2)
    lane = qk.LANES
    g8, t4 = lane >> 2, lane & 3
    total = q.numel()
    fv = qk.flat_view(v, offset)
    out = torch.zeros(total, dtype=torch.float64)
    writes = torch.zeros(total, dtype=torch.int64)
    # this lane's ldmatrix.trans row of v: 16 ks + lane % 8 + 8 (lane / 8 % 2)
    vrows = [16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8 for ks in range(mt)]
    voffs = [torch.where(r < c, r * qk.MMA_PITCH + (lane >> 4) * 8, -1) for r in vrows]
    # where each lane's accumulators (mi, h, tt, d) land: row 16 mi + g8 + 8 h, column
    # 8 tt + 2 t4 + d of the warp's 32
    frag = [(16 * mi + g8 + 8 * h, 8 * tt + 2 * t4 + d)
            for mi in range(mt) for h in range(2) for tt in range(4) for d in range(2)]
    frag_i, frag_j = (torch.cat(x) for x in zip(*frag))
    frag_i, frag_j = frag_i[frag_i < c], frag_j[frag_i < c]
    chunks = torch.arange(qk.MMA_PITCH // 8)
    j8 = torch.arange(8)
    for g in range(g_count):
        # A's fragments: register e of lane l is (g8 + 8 (e % 2), 2 t4 + 8 (e / 2)) and the
        # next column of tile (mi, ks)
        ap = torch.zeros((16 * mt, 16 * mt), dtype=torch.float64)
        for e in range(4):
            for d in range(2):
                for mi in range(mt):
                    for ks in range(mt):
                        i = 16 * mi + g8 + 8 * (e & 1)
                        j = 16 * ks + 2 * t4 + 8 * (e >> 1) + d
                        inside = (i < c) & (j < c)
                        ap[i, j] = torch.where(inside, a[g, i.clamp(max=c - 1), j.clamp(max=c - 1)],
                                               0.0)
        rowbase = [(g * c + r) * n for r in range(c)]

        # row r's shift: its start on the output's 16-byte grid (the output is aligned)
        sh = torch.zeros(c, dtype=torch.int64) if direct else torch.tensor(rowbase) % 8

        for rank in range(plan.splits):
            col0, col_end = rank * plan.chunk, min(n, (rank + 1) * plan.chunk)
            steps = -(-(col_end - col0) // qk.MMA_TILE)
            ring = [None] * plan.apply_stages

            def issue(step):
                if step < steps:
                    n0 = col0 + step * qk.MMA_TILE
                    ring[step % plan.apply_stages] = qk.stage_rows(
                        fv, offset, total, rowbase, n0, min(col_end, n0 + qk.MMA_TILE), direct,
                        zero_to_16=False)

            for st in range(plan.apply_stages - 1):
                issue(st)
            for st in range(steps):
                issue(st + plan.apply_stages - 1)
                tv = ring[st % plan.apply_stages]
                n0 = col0 + st * qk.MMA_TILE
                width = min(qk.MMA_TILE, col_end - n0)
                tile = torch.zeros((c, qk.MMA_PITCH), dtype=torch.float64)
                for wc in range(0, width, 32):
                    acc = torch.zeros((16 * mt, 32), dtype=torch.float64)
                    for ks in range(mt):
                        m = qk.ldmatrix(tv, voffs[ks], torch.tensor([wc, wc + 16]))
                        # .trans: B[k][n] = m[k][n]; n8 tile 2 p + h of m[p, 2 h] over m[p, 2 h + 1]
                        b = torch.cat([torch.cat([m[p, 2 * h], m[p, 2 * h + 1]], 0)
                                       for p in range(2) for h in range(2)], 1)
                        acc += ap[:, 16 * ks:16 * ks + 16] @ b
                    # the fragments into the output tile, row i at its shift
                    tile[frag_i, sh[frag_i] + wc + frag_j] = \
                        acc[frag_i, frag_j].to(torch.bfloat16).double()
                # chunk ch of row r is the output's 16-byte chunk at columns 8 ch - sh ..
                lo = (sh[:, None] - 8 * chunks[None, :]).clamp(min=0)
                hi = (sh[:, None] + width - 8 * chunks[None, :]).clamp(max=8)
                keep = (j8 >= lo[..., None]) & (j8 < hi[..., None])
                e = (torch.tensor(rowbase)[:, None, None] + n0 - sh[:, None, None]
                     + 8 * chunks[None, :, None] + j8)
                out[e[keep]] = tile.view(c, -1, 8)[keep]
                writes.index_add_(0, e[keep], torch.ones_like(e[keep]))
    return out.view(q.shape).to(q.dtype), seen, writes.view(q.shape)
