"""TNSM, the trainable noise-suppression blocks of the TNSM variant, as
``nn.Module``s.

Counterpart of ``hvi_cidnet_tpu/models/cidnet.py:144-171`` (parameters) and
``:223-274`` (forwards); reference net/TNSM.py. ``state_dict`` keys equal
the JAX names (``HV_TNSM1.tnsm.noise_attention.kv.weight``, ...). Conv
weights are OIHW and bias-free; ``CIDNet.reset_parameters`` draws them.

On the card the LayerNorms are K6 and the noise-aware attention is K5 in
its unnormalised arm (q and k are not L2-normalised, so the scores are raw
sums over space), with ``project_out`` folded in. On the ``head_attn``
route (``ops/routes.py``) the scores per head are P10/P15, then the
temperature, an fp32 softmax and the value product run as plain ops, and
``project_out`` as a 1x1 conv. The rest is plain
PyTorch, as the JAX package runs it as plain XLA: the 1x1 and depthwise
3x3 convs, ``leaky_relu(0.2)``, the sigmoids and the global mean and max
pools. The noise map has one channel and broadcasts over the others. In a
row group (``parallel/rows.py``) the global pools combine the shards'
fp32 partial sums and maxes in rank order.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hvi_cidnet_torch.models.layers import Conv, LayerNorm, heads_view
from hvi_cidnet_torch.ops.attention_cuda import channel_attention
from hvi_cidnet_torch.ops.batched_qk_cuda import batched_qk
from hvi_cidnet_torch.ops.conv import conv1x1, dwconv3x3
from hvi_cidnet_torch.ops.routes import UNFUSED, Routes
from hvi_cidnet_torch.parallel import rows


def global_pools(x: torch.Tensor) -> tuple:
    """``DynamicNoiseMap``'s (B, C, 1, 1) mean and max over the image; the
    mean sums up to H * W values per channel: in fp32, rounded once. In a
    row group the shards' sums over their rows, over the whole image's
    H * W."""
    shard = rows.current()
    if shard is None:
        avg = x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32).to(x.dtype)
        return avg, x.amax(dim=(2, 3), keepdim=True)
    total = shard.sum(x.sum(dim=(2, 3), keepdim=True, dtype=torch.float32))
    avg = (total / (x.shape[2] * shard.size * x.shape[3])).to(x.dtype)
    return avg, shard.max(x.amax(dim=(2, 3), keepdim=True))


class DynamicNoiseMap(nn.Module):
    """Squeeze-excite over the global mean and max, times a local depthwise
    branch, to a one-channel sigmoid map (net/TNSM.py:7-57)."""

    def __init__(self, dim: int, reduction: int = 4):
        super().__init__()
        red = max(8, dim // reduction)
        self.fc1 = Conv(dim, red, 1)
        self.fc2 = Conv(red, dim, 1)
        self.noise_branch = nn.ModuleDict({"0": Conv(1, dim, 3), "2": Conv(dim, dim, 1)})
        self.final_conv = Conv(dim, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg, mx = global_pools(x)

        def squeeze_excite(v):
            return conv1x1(torch.relu(conv1x1(v, self.fc1.weight)), self.fc2.weight)

        global_feat = torch.sigmoid(squeeze_excite(avg) + squeeze_excite(mx))
        local = F.leaky_relu(dwconv3x3(x, self.noise_branch["0"].weight), 0.2)
        local = conv1x1(local, self.noise_branch["2"].weight)
        return torch.sigmoid(conv1x1(global_feat * local, self.final_conv.weight))


class NoiseAwareAttention(nn.Module):
    """The CAB's attention with q and k unnormalised and v scaled by
    ``sigmoid(noise_scaler(noise_map))`` (net/TNSM.py:59-128). K5."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.q = Conv(dim, dim, 1)
        self.q_dwconv = Conv(1, dim, 3)
        self.kv = Conv(dim, 2 * dim, 1)
        self.kv_dwconv = Conv(1, 2 * dim, 3)
        self.noise_scaler = nn.Sequential(Conv(1, dim, 1))
        self.project_out = Conv(dim, dim, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor, noise_map: torch.Tensor,
                routes: Routes = UNFUSED) -> torch.Tensor:
        dim = x.shape[1]
        w_kv, w_kvdw = self.kv.weight, self.kv_dwconv.weight
        q = dwconv3x3(conv1x1(x, self.q.weight), self.q_dwconv.weight)
        k = dwconv3x3(conv1x1(y, w_kv[:dim]), w_kvdw[:dim])
        v = dwconv3x3(conv1x1(y, w_kv[dim:]), w_kvdw[dim:])
        v = v * torch.sigmoid(conv1x1(noise_map, self.noise_scaler[0].weight))
        if routes.head_attn:
            h = self.heads
            scores = batched_qk(heads_view(q, h), heads_view(k, h))  # (B * h, c, c) fp32
            scores = scores.view(-1, h, *scores.shape[1:]) * self.temperature.float()
            attn = torch.softmax(scores, dim=-1).to(v.dtype).flatten(0, 1)
            out = torch.bmm(attn, heads_view(v, h)).view(v.shape)
            return conv1x1(out, self.project_out.weight)
        return channel_attention(q, k, v, self.temperature, self.heads, normalize_qk=False,
                                 w_proj=self.project_out.weight)


class AdaptiveFilter(nn.Module):
    """A noise path and a detail path, weighted by the noise map and its
    complement, fused by a 1x1 conv and a LayerNorm (net/TNSM.py:130-173)."""

    def __init__(self, dim: int):
        super().__init__()
        self.noise_process = nn.ModuleDict({"0": Conv(1, dim, 3), "2": Conv(dim, dim, 1)})
        self.detail_preserve = nn.ModuleDict({"0": Conv(dim, dim, 1), "2": Conv(1, dim, 3)})
        self.fusion = Conv(2 * dim, dim, 1)
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor, noise_map: torch.Tensor) -> torch.Tensor:
        noise, detail = self.noise_process, self.detail_preserve
        noise_b = conv1x1(F.leaky_relu(dwconv3x3(x, noise["0"].weight), 0.2), noise["2"].weight)
        detail_b = dwconv3x3(F.leaky_relu(conv1x1(x, detail["0"].weight), 0.2), detail["2"].weight)
        fused = torch.cat([noise_map * noise_b, (1.0 - noise_map) * detail_b], dim=1)
        return self.norm(conv1x1(fused, self.fusion.weight))


class TrainableNoiseSuppression(nn.Module):
    """``x + attention(norm1(x), norm1(y))`` then ``x + filter(norm2(x))``,
    both steered by the noise map of ``x`` (net/TNSM.py:176-215). ``norm1``
    normalises both operands."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.noise_map_generator = DynamicNoiseMap(dim)
        self.noise_attention = NoiseAwareAttention(dim, heads)
        self.adaptive_filter = AdaptiveFilter(dim)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                routes: Routes = UNFUSED) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (x, the noise map (B, 1, H, W))."""
        noise_map = self.noise_map_generator(x)
        x = x + self.noise_attention(self.norm1(x), self.norm1(y), noise_map, routes)
        x = x + self.adaptive_filter(self.norm2(x), noise_map)
        return x, noise_map


class TNSM(nn.Module):
    """The reference's per-level wrapper: its one child is ``tnsm``, so the
    keys read ``HV_TNSM1.tnsm.<...>`` (net/CIDNet_TNSM.py)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.tnsm = TrainableNoiseSuppression(dim, heads)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                routes: Routes = UNFUSED) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.tnsm(x, y, routes)
