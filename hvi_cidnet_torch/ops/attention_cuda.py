"""K5: the channel-attention kernel, its plain twin and the dispatcher
``channel_attention``.

Counterpart of ``hvi_cidnet_tpu/ops/attention.py``'s ``_attn_kernel`` /
``attention_bcn_pallas``. The kernel is ``csrc/attention.cu``: it takes
contiguous NCHW q, k, v of one dtype (fp32 or bf16) with C <= 192, the
(heads, 1, 1) fp32 temperature and, optionally, the (C, C, 1, 1)
``project_out`` weight to fold. The twin is ``ops/attention.py:
channel_attention`` (the JAX ``channel_attention_xla``).

The kernel's contraction over space is split over ``splits`` blocks per
image (``split_plan``); the wrapper allocates the fp32 scratch (partial
sums, the attention rows, the C x C matrix) with ``torch.empty`` and drops
it on return, while the kernel may still run: the caching allocator hands
that memory out again only in stream order, after the kernel. The plan
depends only on the shape, so two calls give the same bits.

Dispatch is by device only: a CPU tensor takes the plain twin, a CUDA
tensor the kernel. Backward runs the twin's autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hvi_cidnet_torch.ops import attention
from hvi_cidnet_torch.ops._build import DTYPE_CODES, CudaKernel, check_input, twin_backward

MAX_CHANNELS = 192      # A (C x C fp32) and a C x 64 tile of v in shared memory
SCORE_TILE = 32         # spatial columns per step of the scores pass
ENTRIES_PER_BLOCK = 4096
TARGET_BLOCKS = 4 * 132  # scores blocks in flight: four per SM of an H100

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
ATTENTION = CudaKernel(
    "attention_forward",
    [_p, _p, _p, _p, _i, _p, _p, _i, _p, _p, _p, _i64, _i, _i, _i64, _i, _i64, _i],
)


def channel_attention_plain(q, k, v, temperature, heads, *, normalize_qk=True, w_proj=None):
    """Twin of K5."""
    return attention.channel_attention(
        q, k, v, temperature, heads, normalize_qk=normalize_qk, w_proj=w_proj
    )


def split_plan(b: int, c: int, heads: int, n: int) -> tuple[int, int]:
    """(splits, chunk): the scores pass covers N in ``splits`` slices of
    ``chunk`` columns (a multiple of SCORE_TILE), none empty, so that about
    TARGET_BLOCKS blocks run."""
    cp = c // heads
    groups = -(-c * cp // ENTRIES_PER_BLOCK)
    tiles = -(-n // SCORE_TILE)
    want = max(1, min(tiles, -(-TARGET_BLOCKS // (b * groups))))
    chunk = -(-tiles // want) * SCORE_TILE
    return -(-n // chunk), chunk


def channel_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    temperature: torch.Tensor,
    heads: int,
    *,
    normalize_qk: bool = True,
    w_proj: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch K5 on contiguous NCHW q, k, v on the card."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check_input(t, name, 4)
    if k.shape != q.shape or v.shape != q.shape or k.dtype != q.dtype or v.dtype != q.dtype \
            or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"q, k, v: expected one shape, dtype and device, got {tuple(q.shape)} {q.dtype}, "
            f"{tuple(k.shape)} {k.dtype}, {tuple(v.shape)} {v.dtype}"
        )
    b, c, h, w = q.shape
    if c > MAX_CHANNELS or heads < 1 or c % heads:
        raise ValueError(
            f"q: the attention kernel takes C <= {MAX_CHANNELS} divisible by heads, got C={c}, "
            f"heads={heads}"
        )
    if temperature.dtype != torch.float32 or temperature.numel() != heads \
            or temperature.device != q.device or not temperature.is_contiguous():
        raise ValueError(
            f"temperature: expected {heads} contiguous fp32 values on {q.device}, got "
            f"{tuple(temperature.shape)} {temperature.dtype} on {temperature.device}"
        )
    wp, w_code, attn = None, -1, None
    cp = c // heads
    if w_proj is not None:
        if tuple(w_proj.shape) != (c, c, 1, 1) or w_proj.dtype not in DTYPE_CODES \
                or w_proj.device != q.device or not w_proj.is_contiguous():
            raise ValueError(
                f"w_proj: expected a contiguous ({c}, {c}, 1, 1) fp32/bf16 weight on {q.device}, "
                f"got {tuple(w_proj.shape)} {w_proj.dtype} on {w_proj.device}"
            )
        wp, w_code = w_proj.data_ptr(), DTYPE_CODES[w_proj.dtype]
        attn = torch.empty((b, c, cp), dtype=torch.float32, device=q.device)
    n = h * w
    splits, chunk = split_plan(b, c, heads, n)
    part = torch.empty((b, splits, c * cp + 2 * c), dtype=torch.float32, device=q.device)
    a = torch.empty((b, c, c), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    ATTENTION(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype],
        temperature.data_ptr(), wp, w_code, part.data_ptr(),
        None if attn is None else attn.data_ptr(), a.data_ptr(),
        b, c, heads, n, splits, chunk, int(normalize_qk),
    )
    return out


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, temperature, w_proj, heads, normalize_qk):
        ctx.heads, ctx.normalize_qk, ctx.fold = heads, normalize_qk, w_proj is not None
        ctx.save_for_backward(q, k, v, temperature, *([w_proj] if ctx.fold else []))
        return channel_attention_kernel(
            q, k, v, temperature, heads, normalize_qk=normalize_qk, w_proj=w_proj
        )

    @staticmethod
    def backward(ctx, grad):
        def plain(q, k, v, temperature, w_proj=None):
            return channel_attention_plain(
                q, k, v, temperature, ctx.heads, normalize_qk=ctx.normalize_qk, w_proj=w_proj
            )

        inputs = ctx.saved_tensors
        grads = twin_backward(plain, inputs, grad, ctx.needs_input_grad[: len(inputs)])
        return (*grads, *([None] * (7 - len(grads))))


def channel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    temperature: torch.Tensor,
    heads: int,
    *,
    normalize_qk: bool = True,
    w_proj: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Channel attention of the CAB (and TNSM) blocks. CPU: twin; CUDA: K5."""
    if q.device.type == "cpu":
        return channel_attention_plain(
            q, k, v, temperature, heads, normalize_qk=normalize_qk, w_proj=w_proj
        )
    return _Attention.apply(q, k, v, temperature, w_proj, heads, normalize_qk)
