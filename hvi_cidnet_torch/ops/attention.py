"""Channel ("transposed") attention in plain PyTorch.

Counterpart of ``channel_attention_xla`` (``hvi_cidnet_tpu/ops/attention.py:
76-173``), the default path of the JAX forward; reference net/LCA.py:26-36.
It is the plain twin of K5 (``ops/attention_cuda.py``, ``csrc/attention.cu``):
the CPU runs it, the card runs the kernel.

Per image, a C x C score matrix contracted over space, in fp32:

* the q/k L2 norm (``F.normalize`` over space) is hoisted past the
  contraction: (q/|q|).(k/|k|) == (q.k) / (|q||k|);
* each row is scaled by its head's temperature;
* a block-diagonal head mask, then an fp32 softmax (== per-head softmax);
* ``project_out`` is folded into the attention matrix: proj(attn @ v) ==
  (W attn) @ v;
* the matrix is taken to ``v.dtype`` before the value product.

``normalize_qk=False`` is the TNSM form (net/TNSM.py:98-104).

The same, split at its reduction over space, for a row group (one image's
rows over shards): ``attention_partials`` gives a shard's fp32 partial
sums in K5's layout, one split of (B, 1, C*cp + 2C): the block-diagonal
score entries (row r, column j of its head), then |q_r|^2 and |k_c|^2; the
caller gathers the shards' into (B, S, C*cp + 2C) in rank order, and
``attention_from_partials`` adds the splits in that order and runs
``channel_attention``'s own tail (norms, temperature, per-head softmax,
fold, apply) on them (``partials_matrix``: the matrix it applies). It is
the plain version of K5's split entries (``ops/attention_cuda.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


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
    """Channel attention on NCHW maps. ``temperature``: (heads, 1, 1);
    ``w_proj``: the (C, C, 1, 1) ``project_out`` weight, or None."""
    b, c, h, w = q.shape
    # scores from fp32 operands: a bf16 product would round them to bf16
    q32 = q.reshape(b, c, h * w).float()
    k32 = k.reshape(b, c, h * w).float()
    scores = torch.bmm(q32, k32.transpose(1, 2))
    attn = _attention_matrix(scores, q32.square().sum(-1), k32.square().sum(-1), temperature,
                             heads, normalize_qk, w_proj)
    return _apply(attn, v)


def _attention_matrix(scores, sq_q, sq_k, temperature, heads, normalize_qk, w_proj):
    """The fp32 (B, C, C) matrix from the raw scores (off the heads' blocks:
    any finite value) and the squared norms |q_r|^2, |k_c|^2 (B, C): the
    norms, temperature, per-head softmax and ``project_out`` fold."""
    c = scores.shape[-1]
    cp = c // heads
    if normalize_qk:
        inv_q = torch.rsqrt(sq_q.clamp_min(1e-24))
        inv_k = torch.rsqrt(sq_k.clamp_min(1e-24))
        scores = scores * inv_q[:, :, None] * inv_k[:, None, :]
    temp_per_c = temperature.reshape(heads).float().repeat_interleave(cp)
    scores = scores * temp_per_c[None, :, None]
    if heads > 1:
        head_id = torch.arange(c, device=scores.device) // cp
        block = head_id[:, None] == head_id[None, :]
        scores = scores.masked_fill(~block, float("-inf"))
    attn = torch.softmax(scores, dim=-1)
    if w_proj is not None:
        attn = torch.matmul(w_proj.reshape(c, c).float(), attn)
    return attn


def _apply(attn: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``attn`` (B, C, C) taken to ``v.dtype``, times ``v`` (NCHW)."""
    b, c, h, w = v.shape
    return torch.bmm(attn.to(v.dtype), v.reshape(b, c, h * w)).reshape(b, c, h, w)


def attention_partials(q: torch.Tensor, k: torch.Tensor, heads: int) -> torch.Tensor:
    """One split of the fp32 partial sums over ``q``'s and ``k``'s columns:
    (B, 1, C*cp + 2C), K5's layout."""
    b, c = q.shape[:2]
    cp = c // heads
    q32 = q.reshape(b * heads, cp, -1).float()
    k32 = k.reshape(b * heads, cp, -1).float()
    scores = torch.bmm(q32, k32.transpose(1, 2)).reshape(b, c * cp)
    norms = [t.reshape(b, c, -1).square().sum(-1) for t in (q32, k32)]
    return torch.cat([scores, *norms], dim=1)[:, None]


def attention_from_partials(
    parts: torch.Tensor,
    v: torch.Tensor,
    temperature: torch.Tensor,
    heads: int,
    *,
    normalize_qk: bool = True,
    w_proj: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``channel_attention`` from the splits ``parts`` (B, S, C*cp + 2C),
    added in order, and ``v`` (NCHW)."""
    return _apply(partials_matrix(parts, temperature, heads, normalize_qk=normalize_qk,
                                  w_proj=w_proj), v)


def partials_matrix(
    parts: torch.Tensor,
    temperature: torch.Tensor,
    heads: int,
    *,
    normalize_qk: bool = True,
    w_proj: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fp32 (B, C, C) matrix that ``attention_from_partials`` applies:
    the splits ``parts`` added in order, then ``channel_attention``'s tail."""
    b, _, stride = parts.shape
    c = math.isqrt(heads * heads + heads * stride) - heads  # stride = C * C / heads + 2C
    cp = c // heads
    total = parts[:, 0]
    for s in range(1, parts.shape[1]):
        total = total + parts[:, s]
    blocks = total[:, :c * cp].reshape(b, heads, cp, cp)
    scores = torch.zeros(b, c, c, dtype=torch.float32, device=parts.device)
    for i in range(heads):
        scores[:, i * cp:(i + 1) * cp, i * cp:(i + 1) * cp] = blocks[:, i]
    return _attention_matrix(scores, total[:, c * cp:c * cp + c], total[:, c * cp + c:],
                             temperature, heads, normalize_qk, w_proj)
