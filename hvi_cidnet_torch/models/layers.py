"""CIDNet building blocks as ``nn.Module``s.

Counterpart of ``hvi_cidnet_tpu/models/layers.py:59-180``. The module tree
mirrors the reference's (net/transformer_utils.py, net/LCA.py), so every
``state_dict()`` key equals the reference key and the JAX parameter name
(``HV_LCA1.ffn.q.weight``, ``HVE_block1.down.0.weight``, ...). Convolutions
hold only their OIHW weight (no bias, as in the reference); the forwards
apply them through ``ops/`` and keep the JAX package's exact rewrites:

* the kv and IEL ``chunk(2)`` is realised by slicing the weights, so no
  2C-channel tensor is materialised and re-split;
* NormUpsample folds its up-side 1x1 conv into the 3x3 conv's weights
  (composed in fp32, then cast): 1x1 channel mixing commutes with the
  channel-independent bilinear x2.

Activations are NCHW-contiguous.
"""

from __future__ import annotations

import torch
from torch import nn

from hvi_cidnet_torch.ops.attention import channel_attention
from hvi_cidnet_torch.ops.conv import (
    conv1x1,
    conv3x3_same,
    dwconv3x3,
    layer_norm_channels,
    prelu,
)
from hvi_cidnet_torch.ops.iel import iel_branch
from hvi_cidnet_torch.ops.resize_cuda import double_bilinear, half_prelu


class Conv(nn.Module):
    """A bias-free conv weight, OIHW, under the reference key ``.weight``.
    Initialised by ``CIDNet.reset_parameters``."""

    def __init__(self, cin_per_group: int, cout: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin_per_group, kernel, kernel))


class LayerNorm(nn.Module):
    """Channel LayerNorm (net/transformer_utils.py:5-29)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_channels(x, self.weight, self.bias)


class NormDownsample(nn.Module):
    """3x3 conv -> bilinear x0.5 -> PReLU -> optional LN
    (net/transformer_utils.py:31-48). The x0.5 + PReLU tail is K3."""

    def __init__(self, cin: int, cout: int, use_norm: bool = False):
        super().__init__()
        self.down = nn.Sequential(Conv(cin, cout, 3))
        self.prelu = nn.PReLU()
        self.norm = LayerNorm(cout) if use_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv3x3_same(x, self.down[0].weight)
        x = half_prelu(x, self.prelu.weight)
        if self.norm is not None:
            x = self.norm(x)
        return x


class NormUpsample(nn.Module):
    """3x3 conv -> bilinear x2 -> concat skip -> 1x1 conv -> PReLU -> opt LN
    (net/transformer_utils.py:50-70). The x2 is K4."""

    def __init__(self, cin: int, cout: int, use_norm: bool = False):
        super().__init__()
        self.up_scale = nn.Sequential(Conv(cin, cout, 3))
        self.up = Conv(2 * cout, cout, 1)
        self.prelu = nn.PReLU()
        self.norm = LayerNorm(cout) if use_norm else None

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        w3 = self.up_scale[0].weight
        w_up = self.up.weight
        cout = w_up.shape[0]
        # concat + 1x1 == two 1x1s on the operands; the x-side one commutes
        # with the x2 and composes into the 3x3: conv1x1(double(conv3(x, w3)),
        # W1) == double(conv3(x, W1 . w3)), exact up to reassociation
        w3 = torch.einsum("om,mihw->oihw", w_up[:, :cout, 0, 0].float(), w3.float()).to(w3.dtype)
        x = double_bilinear(conv3x3_same(x, w3))
        x = x + conv1x1(y, w_up[:, cout:])
        x = prelu(x, self.prelu.weight)
        if self.norm is not None:
            x = self.norm(x)
        return x


class CAB(nn.Module):
    """Cross-attention block: q from x, k/v from y (net/LCA.py:7-41)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.q = Conv(dim, dim, 1)
        self.q_dwconv = Conv(1, dim, 3)
        self.kv = Conv(dim, 2 * dim, 1)
        self.kv_dwconv = Conv(1, 2 * dim, 3)
        self.project_out = Conv(dim, dim, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        dim = x.shape[1]
        w_kv, w_kvdw = self.kv.weight, self.kv_dwconv.weight
        q = dwconv3x3(conv1x1(x, self.q.weight), self.q_dwconv.weight)
        k = dwconv3x3(conv1x1(y, w_kv[:dim]), w_kvdw[:dim])
        v = dwconv3x3(conv1x1(y, w_kv[dim:]), w_kvdw[dim:])
        return channel_attention(
            q, k, v, self.temperature, self.heads, w_proj=self.project_out.weight
        )


class IEL(nn.Module):
    """Intensity Enhancement Layer, the gated tanh FFN (net/LCA.py:45-67)."""

    def __init__(self, dim: int, expansion: float = 2.66):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = Conv(dim, 2 * hidden, 1)
        self.dwconv = Conv(1, 2 * hidden, 3)
        self.dwconv1 = Conv(1, hidden, 3)
        self.dwconv2 = Conv(1, hidden, 3)
        self.project_out = Conv(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_pi, w_dw = self.project_in.weight, self.dwconv.weight
        hidden = w_pi.shape[0] // 2
        x1 = iel_branch(conv1x1(x, w_pi[:hidden]), w_dw[:hidden], self.dwconv1.weight)
        x2 = iel_branch(conv1x1(x, w_pi[hidden:]), w_dw[hidden:], self.dwconv2.weight)
        return conv1x1(x1 * x2, self.project_out.weight)


class HV_LCA(nn.Module):
    """``x + CAB(LN(x), LN(y))`` then IEL(LN(x)), with NO residual on the IEL
    (net/LCA.py:71-81)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.gdfn = IEL(dim)
        self.norm = LayerNorm(dim)
        self.ffn = CAB(dim, heads)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x = x + self.ffn(self.norm(x), self.norm(y))
        return self.gdfn(self.norm(x))


class I_LCA(HV_LCA):
    """Like ``HV_LCA`` but with a residual on the IEL (net/LCA.py:83-93)."""

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x = x + self.ffn(self.norm(x), self.norm(y))
        return x + self.gdfn(self.norm(x))
