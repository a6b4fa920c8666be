"""Base CIDNet: the module tree, its initialisation and its forward.

Counterpart of ``hvi_cidnet_tpu/models/cidnet.py`` for the base variant
(reference net/CIDNet.py). The reference's graph quirks are kept, because
released checkpoints were trained with them:

(a) the level-3 downsamples consume the pre-LCA features (CIDNet.py:94-95);
(b) ``I_LCA5``'s output is discarded: ``ID_block2`` re-derives from
    ``i_dec3`` (CIDNet.py:105, 109);
(c) ``head1``/``ch1`` never feed an LCA (CIDNet.py:17-18).

The public layout is NHWC in [0, 1] in and NHWC out, as in JAX; inside, the
activations are NCHW. The HVI transform runs as the CUDA kernels K1 and K2
on the card (``ops/hvi_cuda.py``), attention softmax and LN statistics in
fp32, everything else in ``compute_dtype``. Only the 4-D conv weights take
the compute dtype (``cast_conv_weights``): LayerNorm, PReLU, temperature
and density_k stay fp32 (``.to(bfloat16)`` on the whole module would round
density_k 0.2 to 0.2002).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from hvi_cidnet_torch.models.layers import (
    HV_LCA,
    I_LCA,
    Conv,
    NormDownsample,
    NormUpsample,
)
from hvi_cidnet_torch.ops.conv import conv3x3_replpad
from hvi_cidnet_torch.ops.hvi_cuda import hvi_to_rgb, rgb_to_hvi


@dataclasses.dataclass(frozen=True)
class CIDNetConfig:
    """Defaults mirror net/CIDNet.py:9-12. Only ``variant="base"`` is ported."""

    channels: Tuple[int, int, int, int] = (36, 36, 72, 144)
    heads: Tuple[int, int, int, int] = (1, 2, 4, 8)
    norm: bool = False
    variant: str = "base"


@dataclasses.dataclass(frozen=True)
class HVIGates:
    """Eval-time gates of the HVI inverse (net/HVI_transform.py:10-13)."""

    gated: bool = False
    gated2: bool = False
    alpha: float = 1.0
    alpha_s: float = 1.3


class RGB_HVI(nn.Module):
    """Holds the learnable ``density_k`` (net/HVI_transform.py:6-14)."""

    def __init__(self):
        super().__init__()
        self.density_k = nn.Parameter(torch.full((1,), 0.2))


class CIDNet(nn.Module):
    """Base CIDNet parameters under the reference's ``state_dict`` keys.

    Conv weights are drawn from ``generator`` (a fresh one seeded 0 if None)
    as torch's Conv2d default, U(+-1/sqrt(fan_in)); the rest take the
    reference's constants. The forward is :func:`cidnet_forward`.
    """

    def __init__(self, config: CIDNetConfig = CIDNetConfig(), *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.variant != "base":
            raise NotImplementedError(f"variant {config.variant!r} is not ported; only 'base'")
        self.config = config
        ch1, ch2, ch3, ch4 = config.channels
        _, h2, h3, h4 = config.heads
        nrm = config.norm

        self.HVE_block0 = nn.Sequential(nn.ReplicationPad2d(1), Conv(3, ch1, 3))
        self.HVE_block1 = NormDownsample(ch1, ch2, nrm)
        self.HVE_block2 = NormDownsample(ch2, ch3, nrm)
        self.HVE_block3 = NormDownsample(ch3, ch4, nrm)
        self.HVD_block3 = NormUpsample(ch4, ch3, nrm)
        self.HVD_block2 = NormUpsample(ch3, ch2, nrm)
        self.HVD_block1 = NormUpsample(ch2, ch1, nrm)
        self.HVD_block0 = nn.Sequential(nn.ReplicationPad2d(1), Conv(ch1, 2, 3))

        self.IE_block0 = nn.Sequential(nn.ReplicationPad2d(1), Conv(1, ch1, 3))
        self.IE_block1 = NormDownsample(ch1, ch2, nrm)
        self.IE_block2 = NormDownsample(ch2, ch3, nrm)
        self.IE_block3 = NormDownsample(ch3, ch4, nrm)
        self.ID_block3 = NormUpsample(ch4, ch3, nrm)
        self.ID_block2 = NormUpsample(ch3, ch2, nrm)
        self.ID_block1 = NormUpsample(ch2, ch1, nrm)
        self.ID_block0 = nn.Sequential(nn.ReplicationPad2d(1), Conv(ch1, 1, 3))

        dims = {1: (ch2, h2), 2: (ch3, h3), 3: (ch4, h4), 4: (ch4, h4), 5: (ch3, h3), 6: (ch2, h2)}
        for idx, (dim, heads) in dims.items():
            self.add_module(f"HV_LCA{idx}", HV_LCA(dim, heads))
            self.add_module(f"I_LCA{idx}", I_LCA(dim, heads))

        self.trans = RGB_HVI()
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for p in self.parameters():
            if p.dim() == 4:
                bound = 1.0 / math.sqrt(p.shape[1] * p.shape[2] * p.shape[3])
                draw = torch.empty(p.shape).uniform_(-bound, bound, generator=generator)
                p.copy_(draw)

    def count_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


@torch.no_grad()
def cast_conv_weights(model: CIDNet, dtype: torch.dtype) -> CIDNet:
    """Cast the 4-D conv weights to ``dtype`` in place; every other
    parameter stays fp32. Returns ``model``."""
    for p in model.parameters():
        if p.dim() == 4:
            p.data = p.data.to(dtype)
    return model


def _check_x8(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"expected NHWC RGB (B, H, W, 3), got shape {tuple(x.shape)}")
    h, w = x.shape[1], x.shape[2]
    if h % 8 or w % 8:
        # three bilinear x0.5 levels need x8 extents; without this check the
        # failure is a cryptic concat-shape error mid-UNet
        raise ValueError(
            f"H and W must be multiples of 8 (got {h}x{w}); reflect-pad the "
            "input and crop the output, as cli/demo.py and the evaluator do"
        )


def cidnet_hvi(model: CIDNet, x: torch.Tensor, *, compute_dtype=torch.float32) -> torch.Tensor:
    """The forward up to PHVIT: NHWC RGB -> the output HVI map, NCHW
    (B, 3, H, W) in ``compute_dtype`` (net/CIDNet.py:71-119)."""
    _check_x8(x)
    m = model
    hvi = rgb_to_hvi(x, m.trans.density_k, compute_dtype)  # K1; CIDNet.py:73
    i_img = hvi[:, 2:3]                                    # :74

    i_enc0 = conv3x3_replpad(i_img, m.IE_block0[1].weight)  # :76
    i_enc1 = m.IE_block1(i_enc0)
    hv_0 = conv3x3_replpad(hvi, m.HVE_block0[1].weight)
    hv_1 = m.HVE_block1(hv_0)
    i_jump0, hv_jump0 = i_enc0, hv_0

    i_enc2 = m.I_LCA1(i_enc1, hv_1)  # :83
    hv_2 = m.HV_LCA1(hv_1, i_enc1)
    v_jump1, hv_jump1 = i_enc2, hv_2
    i_enc2 = m.IE_block2(i_enc2)
    hv_2 = m.HVE_block2(hv_2)

    i_enc3 = m.I_LCA2(i_enc2, hv_2)  # :90
    hv_3 = m.HV_LCA2(hv_2, i_enc2)
    v_jump2, hv_jump2 = i_enc3, hv_3
    # quirk (a): level-3 downsamples consume the PRE-LCA features (:94-95)
    i_enc3 = m.IE_block3(i_enc2)
    hv_3 = m.HVE_block3(hv_2)

    i_enc4 = m.I_LCA3(i_enc3, hv_3)  # :97
    hv_4 = m.HV_LCA3(hv_3, i_enc3)

    i_dec4 = m.I_LCA4(i_enc4, hv_4)  # :100
    hv_4 = m.HV_LCA4(hv_4, i_enc4)

    hv_3 = m.HVD_block3(hv_4, hv_jump2)  # :103
    i_dec3 = m.ID_block3(i_dec4, v_jump2)

    # quirk (b) discards I_LCA5's output (:105), so it is not computed; XLA's
    # dead-code elimination drops it from the JAX program the same way
    hv_2 = m.HV_LCA5(hv_3, i_dec3)

    hv_2 = m.HVD_block2(hv_2, hv_jump1)  # :108
    i_dec2 = m.ID_block2(i_dec3, v_jump1)  # quirk (b): from i_dec3 (:109)

    i_dec1 = m.I_LCA6(i_dec2, hv_2)  # :111
    hv_1 = m.HV_LCA6(hv_2, i_dec2)

    i_dec1 = m.ID_block1(i_dec1, i_jump0)  # :114
    i_dec0 = conv3x3_replpad(i_dec1, m.ID_block0[1].weight)
    hv_1 = m.HVD_block1(hv_1, hv_jump0)
    hv_0 = conv3x3_replpad(hv_1, m.HVD_block0[1].weight)

    return torch.cat([hv_0, i_dec0], dim=1) + hvi  # :119


def cidnet_forward(
    model: CIDNet,
    x: torch.Tensor,
    gates: HVIGates = HVIGates(),
    *,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Base CIDNet forward. ``x``: NHWC RGB in [0, 1] with H, W multiples of
    8, on the model's device. Returns NHWC RGB in ``compute_dtype``."""
    out_hvi = cidnet_hvi(model, x, compute_dtype=compute_dtype)
    # PHVIT read the detached Python float this_k (HVI_transform.py:38, 59)
    return hvi_to_rgb(  # K2
        out_hvi, model.trans.density_k.detach(),
        gated=gates.gated, gated2=gates.gated2, alpha=gates.alpha, alpha_s=gates.alpha_s,
    )
