"""CIDNet building blocks as ``nn.Module``s.

Counterpart of ``hvi_cidnet_tpu/models/layers.py:59-193``. The module tree
mirrors the reference's (net/transformer_utils.py, net/LCA.py,
net/CIDNet_MSSA.py), so every
``state_dict()`` key equals the reference key and the JAX parameter name
(``HV_LCA1.ffn.q.weight``, ``HVE_block1.down.0.weight``, ...). Convolutions
hold only their OIHW weight (no bias, as in the reference); the forwards
apply them through ``ops/`` and keep the JAX package's exact rewrites:

* the kv and IEL ``chunk(2)`` is realised by slicing the weights, so no
  2C-channel tensor is materialised and re-split;
* NormUpsample folds its up-side 1x1 conv into the 3x3 conv's weights
  (composed in fp32, then cast): 1x1 channel mixing commutes with the
  channel-independent bilinear x2.

Activations are NCHW-contiguous. On the card the LCA interior runs as
kernels: LayerNorm K6, the CAB's channel attention K5, the IEL branch K7;
NormDownsample's tail K3 and NormUpsample's x2 K4.

The fused block route (``ops/routes.py``, off by default) takes, in the
blocks that get a ``routes`` argument: the IEL with its LayerNorm and I_LCA's
residual as P2/P3; NormDownsample's conv, x0.5 and PReLU as P5; the other
dense 3x3 convs as P4. The LCA's shared ``norm`` still serves the CAB. The
probe route takes the CAB's attention per head as P1, with ``project_out``
as a 1x1 conv after it, and the dense 3x3 convs as an im2col operand and
P6's products.
"""

from __future__ import annotations

import torch
from torch import nn

from hvi_cidnet_torch.ops.attention_cuda import channel_attention
from hvi_cidnet_torch.ops.conv import (
    conv1x1,
    conv2d,
    conv3x3_replpad,
    conv3x3_same,
    dwconv3x3,
    prelu,
)
from hvi_cidnet_torch.ops.conv3x3_cuda import conv3x3, conv3x3_half_prelu
from hvi_cidnet_torch.ops.head_attention_cuda import head_attention
from hvi_cidnet_torch.ops.im2col_cuda import conv3x3_im2col
from hvi_cidnet_torch.ops.iel_cuda import iel_branch
from hvi_cidnet_torch.ops.ln_iel_cuda import ln_iel
from hvi_cidnet_torch.ops.norm_cuda import layer_norm
from hvi_cidnet_torch.ops.resize_cuda import double_bilinear, half_prelu
from hvi_cidnet_torch.ops.routes import UNFUSED, Routes
from hvi_cidnet_torch.parallel import rows


def dense3x3(x: torch.Tensor, w: torch.Tensor, routes: Routes, pad_mode: str = "zero") -> torch.Tensor:
    """A dense 3x3 conv, zero SAME padding or the replication pad ("edge"):
    P4 on the ``conv3x3`` route (on a contiguous copy where ``x`` is a view,
    as the I stem's input, channel 2 of the HVI map, is at batch > 1), the
    im2col operand and P6 on the ``im2col`` route, else the plain conv
    (cuDNN on the card)."""
    if routes.conv3x3:
        return conv3x3(x.contiguous(), w, pad_mode)
    if routes.im2col:
        return conv3x3_im2col(x, w, pad_mode)
    return conv3x3_same(x, w) if pad_mode == "zero" else conv3x3_replpad(x, w)


class Conv(nn.Module):
    """A bias-free conv weight, OIHW, under the reference key ``.weight``.
    Initialised by ``CIDNet.reset_parameters``."""

    def __init__(self, cin_per_group: int, cout: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin_per_group, kernel, kernel))


class LayerNorm(nn.Module):
    """Channel LayerNorm (net/transformer_utils.py:5-29). K6."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


class NormDownsample(nn.Module):
    """3x3 conv -> bilinear x0.5 -> PReLU -> optional LN
    (net/transformer_utils.py:31-48). The x0.5 + PReLU tail is K3; on the
    ``down`` route the conv, x0.5 and PReLU are P5."""

    def __init__(self, cin: int, cout: int, use_norm: bool = False):
        super().__init__()
        self.down = nn.Sequential(Conv(cin, cout, 3))
        self.prelu = nn.PReLU()
        self.norm = LayerNorm(cout) if use_norm else None

    def forward(self, x: torch.Tensor, routes: Routes = UNFUSED) -> torch.Tensor:
        w = self.down[0].weight
        if routes.down:
            x = conv3x3_half_prelu(x, w, self.prelu.weight)
        else:
            x = half_prelu(dense3x3(x, w, routes), self.prelu.weight)
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

    def forward(self, x: torch.Tensor, y: torch.Tensor, routes: Routes = UNFUSED) -> torch.Tensor:
        w3 = self.up_scale[0].weight
        w_up = self.up.weight
        cout = w_up.shape[0]
        # concat + 1x1 == two 1x1s on the operands; the x-side one commutes
        # with the x2 and composes into the 3x3: conv1x1(double(conv3(x, w3)),
        # W1) == double(conv3(x, W1 . w3)), exact up to reassociation
        w3 = torch.einsum("om,mihw->oihw", w_up[:, :cout, 0, 0].float(), w3.float()).to(w3.dtype)
        x = double_bilinear(dense3x3(x, w3, routes))
        x = x + conv1x1(y, w_up[:, cout:])
        x = prelu(x, self.prelu.weight)
        if self.norm is not None:
            x = self.norm(x)
        return x


def heads_view(t: torch.Tensor, heads: int) -> torch.Tensor:
    """NCHW ``t`` as (B * heads, C / heads, H * W): a free view of a
    contiguous tensor (``.contiguous()`` copies only where ``t`` is not)."""
    b, c, h, w = t.shape
    return t.contiguous().view(b * heads, c // heads, h * w)


class CAB(nn.Module):
    """Cross-attention block: q from x, k/v from y (net/LCA.py:7-41). The
    attention with the folded ``project_out`` is K5; on the ``head_attn``
    route the attention per head is P1 and ``project_out`` a 1x1 conv
    after it, unfolded, as net/LCA.py runs it."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.q = Conv(dim, dim, 1)
        self.q_dwconv = Conv(1, dim, 3)
        self.kv = Conv(dim, 2 * dim, 1)
        self.kv_dwconv = Conv(1, 2 * dim, 3)
        self.project_out = Conv(dim, dim, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor, routes: Routes = UNFUSED) -> torch.Tensor:
        dim = x.shape[1]
        w_kv, w_kvdw = self.kv.weight, self.kv_dwconv.weight
        q = dwconv3x3(conv1x1(x, self.q.weight), self.q_dwconv.weight)
        k = dwconv3x3(conv1x1(y, w_kv[:dim]), w_kvdw[:dim])
        v = dwconv3x3(conv1x1(y, w_kv[dim:]), w_kvdw[dim:])
        if routes.head_attn:
            h = self.heads
            out = head_attention(heads_view(q, h), heads_view(k, h), heads_view(v, h),
                                 self.temperature.reshape(h))
            return conv1x1(out.view(q.shape), self.project_out.weight)
        return channel_attention(
            q, k, v, self.temperature, self.heads, w_proj=self.project_out.weight
        )


class IEL(nn.Module):
    """Intensity Enhancement Layer, the gated tanh FFN (net/LCA.py:45-67).
    Each of its two branches is K7."""

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

    def fused(self, x: torch.Tensor, norm: LayerNorm, residual: bool) -> torch.Tensor:
        """``IEL(norm(x))`` [+ x] as one pass: P2/P3 on the card."""
        return ln_iel(x, norm.weight, norm.bias, self.project_in.weight, self.dwconv.weight,
                      self.dwconv1.weight, self.dwconv2.weight, self.project_out.weight, residual)


class HV_LCA(nn.Module):
    """``x + CAB(LN(x), LN(y))`` then IEL(LN(x)), with NO residual on the IEL
    (net/LCA.py:71-81). On the ``ln_iel`` route the IEL with its LayerNorm
    is P2/P3."""

    residual = False

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.gdfn = IEL(dim)
        self.norm = LayerNorm(dim)
        self.ffn = CAB(dim, heads)

    def forward(self, x: torch.Tensor, y: torch.Tensor, routes: Routes = UNFUSED) -> torch.Tensor:
        x = x + self.ffn(self.norm(x), self.norm(y), routes)
        if routes.ln_iel:
            return self.gdfn.fused(x, self.norm, self.residual)
        out = self.gdfn(self.norm(x))
        return x + out if self.residual else out


class I_LCA(HV_LCA):
    """Like ``HV_LCA`` but with a residual on the IEL (net/LCA.py:83-93)."""

    residual = True


class SpatialAttention(nn.Module):
    """Channel mean and max -> 7x7 conv (2 -> 1, zero SAME padding) ->
    sigmoid gate on ``x`` (net/CIDNet_MSSA.py:10-25). Plain PyTorch: the JAX
    package has no kernel for it. In a row group the conv reads three halo
    rows each side of the pooled map (the pools are per pixel)."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(2, 1, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        shard = rows.current()
        if shard is not None:
            band = shard.extend(pooled, 3, 3, "zero")[0]
            return x * torch.sigmoid(conv2d(band, self.conv1.weight, padding=(0, 3)))
        return x * torch.sigmoid(conv2d(pooled, self.conv1.weight, padding=3))
