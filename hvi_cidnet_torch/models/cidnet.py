"""CIDNet, base, MSSA and TNSM: the module tree, its initialisation and its
forward.

Counterpart of ``hvi_cidnet_tpu/models/cidnet.py`` for the base variant
(reference net/CIDNet.py), the MSSA variant (net/CIDNet_MSSA.py), which
adds a spatial-attention gate after each decoder upsample and feeds
``I_LCA5``'s output to ``ID_block2``, and the TNSM variant
(net/CIDNet_TNSM.py), which runs a noise-suppression block
(``models/tnsm.py``) after each LCA and, in training, fuses the twelve
noise maps into a three-channel map. The reference's graph quirks are kept,
because released checkpoints were trained with them:

(a) the level-3 downsamples consume the pre-LCA features (CIDNet.py:94-95);
(b) base and TNSM: ``ID_block2`` re-derives from ``i_dec3``
    (CIDNet.py:105, 109), so ``I_LCA5``'s output reaches nothing in base,
    and in TNSM only ``HV_TNSM5`` (as its ``y``);
(c) ``head1``/``ch1`` never feed an LCA (CIDNet.py:17-18).

The public layout is NHWC in [0, 1] in and NHWC out, as in JAX, or, with
``input_layout="hwcb"``, the JAX package's HWCB serving contract: (H, W, 3,
B) in and out (the TNSM noise map too). Inside, the activations are NCHW;
the HWCB contract adds one relayout at each end (``ops/relayout_cuda.py``:
P14 packs (H W, 3, B) into NHWC, P11 turns K2's NHWC output, and TNSM's
fused noise map, into (H, W, 3, B)). On the card the HVI transform runs as the CUDA
kernels K1 and K2 (``ops/hvi_cuda.py``) and the blocks as K3-K7
(``models/layers.py``, ``models/tnsm.py``); attention softmax and LN
statistics are fp32, everything else ``compute_dtype``. The fused block
route (``routes``, ``ops/routes.py``; off unless asked for) runs the LCAs'
LayerNorm + IEL as P2/P3, the NormDownsamples as P5 and the other dense 3x3
convs (stems, heads, NormUpsample) as P4, each in fp32 inside; the probe
route runs the attention sites per head (P1 in the LCAs, P10/P15's scores
in TNSM) and the dense 3x3 convs as im2col products (P6). Only the 4-D conv
weights take the compute dtype (``cast_conv_weights``): LayerNorm, PReLU,
temperature and density_k stay fp32 (``.to(bfloat16)`` on the whole module
would round density_k 0.2 to 0.2002).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from hvi_cidnet_torch.models.layers import (
    HV_LCA,
    I_LCA,
    Conv,
    NormDownsample,
    NormUpsample,
    SpatialAttention,
    dense3x3,
)
from hvi_cidnet_torch.models.tnsm import TNSM
from hvi_cidnet_torch.ops.conv import conv2d
from hvi_cidnet_torch.ops.hvi_cuda import hvi_to_rgb, rgb_to_hvi
from hvi_cidnet_torch.ops.relayout_cuda import pack_blocked, relayout_t2_rev
from hvi_cidnet_torch.ops.resize import resize_bilinear
from hvi_cidnet_torch.ops.routes import Routes, resolve


@dataclasses.dataclass(frozen=True)
class CIDNetConfig:
    """Defaults mirror net/CIDNet.py:9-12. ``variant``: "base", "mssa" or
    "tnsm"; ``use_tnsm`` applies to "tnsm" only (net/CIDNet_TNSM.py:19)."""

    channels: Tuple[int, int, int, int] = (36, 36, 72, 144)
    heads: Tuple[int, int, int, int] = (1, 2, 4, 8)
    norm: bool = False
    variant: str = "base"
    use_tnsm: bool = True


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


VARIANTS = ("base", "mssa", "tnsm")
SA_NAMES = ("sa_hv3", "sa_i3", "sa_hv2", "sa_i2", "sa_hv1", "sa_i1")


def uses_tnsm(config: CIDNetConfig) -> bool:
    """Whether ``config`` has the TNSM blocks and the noise fusion."""
    return config.variant == "tnsm" and config.use_tnsm


class CIDNet(nn.Module):
    """CIDNet parameters under the reference's ``state_dict`` keys.

    Conv weights are drawn from ``generator`` (a fresh one seeded 0 if None)
    as torch's Conv2d default, U(+-1/sqrt(fan_in)); the rest take the
    reference's constants. The forward is :func:`cidnet_forward`.
    """

    def __init__(self, config: CIDNetConfig = CIDNetConfig(), *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.variant not in VARIANTS:
            raise ValueError(f"variant {config.variant!r} is not one of {', '.join(VARIANTS)}")
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
        # the variants' modules come after the base tree: base draws stay as they were
        if config.variant == "mssa":
            for name in SA_NAMES:
                self.add_module(name, SpatialAttention())
        if uses_tnsm(config):
            for idx, (dim, heads) in dims.items():
                self.add_module(f"HV_TNSM{idx}", TNSM(dim, heads))
                self.add_module(f"I_TNSM{idx}", TNSM(dim, heads))
            # the twelve noise maps (two a level) -> 3 (CIDNet_TNSM.py:262)
            self.noise_fusion = nn.Sequential(Conv(12, 3, 3))
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


LAYOUTS = ("nhwc", "hwcb")


def _check_x8(x: torch.Tensor, input_layout: str = "nhwc") -> None:
    """x: NHWC (B, H, W, 3) or, for "hwcb", (H, W, 3, B), with H and W
    multiples of 8 (the JAX package's check and message)."""
    hwcb = input_layout == "hwcb"
    if x.dim() != 4 or x.shape[2 if hwcb else 3] != 3:
        want = "HWCB RGB (H, W, 3, B)" if hwcb else "NHWC RGB (B, H, W, 3)"
        raise ValueError(f"expected {want}, got shape {tuple(x.shape)}")
    h, w = (x.shape[0], x.shape[1]) if hwcb else (x.shape[1], x.shape[2])
    if h % 8 or w % 8:
        # three bilinear x0.5 levels need x8 extents; without this check the
        # failure is a cryptic concat-shape error mid-UNet
        raise ValueError(
            f"H and W must be multiples of 8 (got {h}x{w}); reflect-pad the "
            "input and crop the output, as cli/demo.py and the evaluator do"
        )


def cidnet_hvi(model: CIDNet, x: torch.Tensor, *, compute_dtype=torch.float32,
               routes: Optional[Routes] = None) -> torch.Tensor:
    """The forward up to PHVIT: NHWC RGB -> the output HVI map, NCHW
    (B, 3, H, W) in ``compute_dtype`` (net/CIDNet.py:71-119; MSSA:
    net/CIDNet_MSSA.py; TNSM: net/CIDNet_TNSM.py)."""
    return _hvi_and_noise(model, x, compute_dtype, training=False, routes=resolve(routes))[0]


def _hvi_and_noise(
    model: CIDNet, x: torch.Tensor, compute_dtype, *, training: bool, routes: Routes
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The output HVI map and, for TNSM, the per-level noise maps in the
    reference's order (I before HV, levels 1-6; ``I_TNSM5``'s only with
    ``training``), through the blocks on ``routes``."""
    _check_x8(x)
    m = model
    r = routes
    mssa = m.config.variant == "mssa"
    tnsm = uses_tnsm(m.config)
    gate = (lambda name, t: getattr(m, name)(t)) if mssa else (lambda name, t: t)
    noise_maps: List[torch.Tensor] = []

    def suppress(idx, i_x, hv_x):
        """The level's TNSM pair after its LCA pair (CIDNet_TNSM.py:122-132):
        each reads the other's LCA output, not its TNSM output."""
        if not tnsm:
            return i_x, hv_x
        i_t, i_n = getattr(m, f"I_TNSM{idx}")(i_x, hv_x, r)
        hv_t, hv_n = getattr(m, f"HV_TNSM{idx}")(hv_x, i_x, r)
        noise_maps.extend([i_n, hv_n])
        return i_t, hv_t

    hvi = rgb_to_hvi(x, m.trans.density_k, compute_dtype)  # K1; CIDNet.py:73
    i_img = hvi[:, 2:3]                                    # :74

    i_enc0 = dense3x3(i_img, m.IE_block0[1].weight, r, "edge")  # :76
    i_enc1 = m.IE_block1(i_enc0, r)
    hv_0 = dense3x3(hvi, m.HVE_block0[1].weight, r, "edge")
    hv_1 = m.HVE_block1(hv_0, r)
    i_jump0, hv_jump0 = i_enc0, hv_0

    i_enc2 = m.I_LCA1(i_enc1, hv_1, r)  # :83
    hv_2 = m.HV_LCA1(hv_1, i_enc1, r)
    i_enc2, hv_2 = suppress(1, i_enc2, hv_2)
    v_jump1, hv_jump1 = i_enc2, hv_2
    i_enc2 = m.IE_block2(i_enc2, r)
    hv_2 = m.HVE_block2(hv_2, r)

    i_enc3 = m.I_LCA2(i_enc2, hv_2, r)  # :90
    hv_3 = m.HV_LCA2(hv_2, i_enc2, r)
    i_enc3, hv_3 = suppress(2, i_enc3, hv_3)
    v_jump2, hv_jump2 = i_enc3, hv_3
    # quirk (a): level-3 downsamples consume the PRE-LCA features (:94-95)
    i_enc3 = m.IE_block3(i_enc2, r)
    hv_3 = m.HVE_block3(hv_2, r)

    i_enc4 = m.I_LCA3(i_enc3, hv_3, r)  # :97
    hv_4 = m.HV_LCA3(hv_3, i_enc3, r)
    i_enc4, hv_4 = suppress(3, i_enc4, hv_4)

    i_dec4 = m.I_LCA4(i_enc4, hv_4, r)  # :100
    hv_4 = m.HV_LCA4(hv_4, i_enc4, r)
    i_dec4, hv_4 = suppress(4, i_dec4, hv_4)

    hv_3 = gate("sa_hv3", m.HVD_block3(hv_4, hv_jump2, r))  # :103; MSSA :133
    i_dec3 = gate("sa_i3", m.ID_block3(i_dec4, v_jump2, r))  # MSSA :135

    # quirk (b): in base I_LCA5's output reaches nothing, so it is not
    # computed (XLA's dead-code elimination drops it from the JAX program the
    # same way); MSSA feeds it to ID_block2, TNSM to HV_TNSM5 as its y
    i_dec2 = m.I_LCA5(i_dec3, hv_3, r) if mssa or tnsm else i_dec3
    hv_2 = m.HV_LCA5(hv_3, i_dec3, r)
    if tnsm:
        # I_TNSM5's output is discarded (quirk (b)); only training reads its
        # noise map, so serving skips the block, as XLA's dead-code elimination does
        if training:
            noise_maps.append(m.I_TNSM5(i_dec2, hv_2, r)[1])
        hv_2, hv_n5 = m.HV_TNSM5(hv_2, i_dec2, r)
        noise_maps.append(hv_n5)

    hv_2 = gate("sa_hv2", m.HVD_block2(hv_2, hv_jump1, r))  # :108
    # base and TNSM, quirk (b): from i_dec3 (:109); MSSA feeds I_LCA5's output (:143)
    i_dec2 = gate("sa_i2", m.ID_block2(i_dec2 if mssa else i_dec3, v_jump1, r))

    i_dec1 = m.I_LCA6(i_dec2, hv_2, r)  # :111
    hv_1 = m.HV_LCA6(hv_2, i_dec2, r)
    i_dec1, hv_1 = suppress(6, i_dec1, hv_1)

    i_dec1 = gate("sa_i1", m.ID_block1(i_dec1, i_jump0, r))  # :114
    i_dec0 = dense3x3(i_dec1, m.ID_block0[1].weight, r, "edge")
    hv_1 = gate("sa_hv1", m.HVD_block1(hv_1, hv_jump0, r))
    hv_0 = dense3x3(hv_1, m.HVD_block0[1].weight, r, "edge")

    return torch.cat([hv_0, i_dec0], dim=1) + hvi, noise_maps  # :119


def cidnet_forward(
    model: CIDNet,
    x: torch.Tensor,
    gates: HVIGates = HVIGates(),
    *,
    compute_dtype=torch.float32,
    training: bool = False,
    routes: Optional[Routes] = None,
    input_layout: str = "nhwc",
) -> Union[torch.Tensor, Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """CIDNet forward (the model's variant). ``x``: NHWC RGB in [0, 1] with
    H, W multiples of 8, on the model's device. Returns NHWC RGB in
    ``compute_dtype``; TNSM returns ``(rgb, noise)``, where ``noise`` is None
    unless ``training`` (and ``use_tnsm``): then the twelve noise maps
    resized to the output size (bilinear, ``align_corners=False``), fused by
    ``noise_fusion`` (zero SAME padding) and a sigmoid, NHWC (B, H, W, 3)
    (net/CIDNet_TNSM.py:248-294). Forward only: ``training`` runs no
    training-mode layer, it only adds the noise output. ``routes``: the
    fused block or probe route (``ops/routes.py``); None takes the defaults
    (all off) with the environment's overrides.

    ``input_layout="hwcb"``: the JAX package's serving contract
    (``hvi_cidnet_tpu/models/cidnet.py:cidnet_forward``): ``x`` is a
    contiguous (H, W, 3, B) tensor and the RGB and the noise map come back
    as (H, W, 3, B). The forward between is the NHWC one, so its output is
    the NHWC output permuted, bit for bit."""
    if input_layout not in LAYOUTS:
        raise ValueError(f"input_layout must be 'nhwc' or 'hwcb', got {input_layout!r}")
    hwcb = input_layout == "hwcb"
    if hwcb:
        _check_x8(x, input_layout)
        if not x.is_contiguous():
            raise ValueError("input_layout='hwcb': x must be a contiguous (H, W, 3, B) tensor")
        h, w, _, b = x.shape
        x = pack_blocked(x.view(h * w, 3, b), h * w).view(b, h, w, 3)  # P14
    out_hvi, noise_maps = _hvi_and_noise(model, x, compute_dtype, training=training,
                                         routes=resolve(routes))
    # PHVIT read the detached Python float this_k (HVI_transform.py:38, 59)
    rgb = hvi_to_rgb(  # K2
        out_hvi, model.trans.density_k.detach(),
        gated=gates.gated, gated2=gates.gated2, alpha=gates.alpha, alpha_s=gates.alpha_s,
    )
    b, h, w, _ = rgb.shape
    if hwcb:  # K2's NHWC as (B, 1, H W 3) -> (H W 3, 1, B)
        rgb = relayout_t2_rev(rgb.view(b, 1, h * w * 3)).view(h, w, 3, b)  # P11
    if model.config.variant != "tnsm":
        return rgb
    if not (training and noise_maps):
        return rgb, None
    stacked = torch.cat(
        [resize_bilinear(nm, h, w) for nm in noise_maps], dim=1)
    fused = torch.sigmoid(conv2d(stacked, model.noise_fusion[0].weight, padding=1))
    if hwcb:  # NCHW (B, 3, H W) -> (H W, 3, B)
        return rgb, relayout_t2_rev(fused.view(b, 3, h * w)).view(h, w, 3, b)  # P11
    return rgb, fused.permute(0, 2, 3, 1)
