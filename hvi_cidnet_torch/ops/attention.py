"""Channel ("transposed") attention in plain PyTorch.

Counterpart of ``channel_attention_xla`` (``hvi_cidnet_tpu/ops/attention.py:
76-173``), the default path of the JAX forward; reference net/LCA.py:26-36.
Its kernel (K5, the JAX ``_attn_kernel``) is ported in a later slice; until
then this plain form runs on every device, as XLA's einsums run on the TPU.

Per image, a C x C score matrix contracted over space, in fp32:

* the q/k L2 norm (``F.normalize`` over space) is hoisted past the
  contraction: (q/|q|).(k/|k|) == (q.k) / (|q||k|);
* each row is scaled by its head's temperature;
* a block-diagonal head mask, then an fp32 softmax (== per-head softmax);
* ``project_out`` is folded into the attention matrix: proj(attn @ v) ==
  (W attn) @ v;
* the matrix is taken to ``v.dtype`` before the value product.

``normalize_qk=False`` is the TNSM form (net/TNSM.py:98-104).
"""

from __future__ import annotations

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
    cp = c // heads
    # scores from fp32 operands: a bf16 product would round them to bf16
    q32 = q.reshape(b, c, h * w).float()
    k32 = k.reshape(b, c, h * w).float()
    scores = torch.bmm(q32, k32.transpose(1, 2))
    if normalize_qk:
        inv_q = torch.rsqrt(q32.square().sum(-1).clamp_min(1e-24))
        inv_k = torch.rsqrt(k32.square().sum(-1).clamp_min(1e-24))
        scores = scores * inv_q[:, :, None] * inv_k[:, None, :]
    temp_per_c = temperature.reshape(heads).float().repeat_interleave(cp)
    scores = scores * temp_per_c[None, :, None]
    if heads > 1:
        head_id = torch.arange(c, device=q.device) // cp
        block = head_id[:, None] == head_id[None, :]
        scores = scores.masked_fill(~block, float("-inf"))
    attn = torch.softmax(scores, dim=-1)
    if w_proj is not None:
        attn = torch.matmul(w_proj.reshape(c, c).float(), attn)
    out = torch.bmm(attn.to(v.dtype), v.reshape(b, c, h * w))
    return out.reshape(b, c, h, w)
