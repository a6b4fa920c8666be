"""HVI color-space transform in plain PyTorch.

Counterpart of ``hvi_cidnet_tpu/ops/hvi.py`` (reference ``RGB_HVI.HVIT`` /
``RGB_HVI.PHVIT``, net/HVI_transform.py:16-122) and the plain twin of the
CUDA kernels in ``ops/hvi_cuda.py``:

* ``rgb_to_hvi(img, k)`` — HVIT;
* ``hvi_to_rgb(hvi, k, gates)`` — PHVIT, ``k`` detached by the caller.

Same choices as the JAX package: ``k`` is threaded explicitly (no
``k.item()`` host sync), the hue is a select chain with the reference's
write priority (B-max, then G-max, then R-max, then gray), ``mod`` is
floored (``torch.remainder``, as ``jnp.mod``), and the whole transform runs
in fp32 whatever the input dtype, cast back on exit.

Every scalar constant is a Python float, so each op rounds in fp32 exactly
as the JAX twin and the CUDA kernels do (``ops/hvi_cuda.py`` builds with
``--fmad=false`` for the same reason).
"""

from __future__ import annotations

import torch

PI = 3.141592653589793
_EPS = 1e-8


def color_sensitive(intensity: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``(sin(I*pi/2) + eps) ** k`` — the intensity-collapse factor."""
    return torch.pow(torch.sin(intensity * (0.5 * PI)) + _EPS, k)


def hue_sextants(r, g, b, value, img_min, denom) -> torch.Tensor:
    """The hue in sixths of a turn, [0, 6), of fp32 channels ``r, g, b``
    with their max ``value``, min ``img_min`` and ``denom = value - img_min
    + eps``: the reference's sequential boolean-mask writes, where later
    writes win, so the last write is the outermost select."""
    hue = torch.where(b == value, 4.0 + (r - g) / denom, 0.0)
    hue = torch.where(g == value, 2.0 + (b - r) / denom, hue)
    hue = torch.where(r == value, torch.remainder((g - b) / denom, 6.0), hue)
    return torch.where(img_min == value, 0.0, hue)


def rgb_to_hvi(img: torch.Tensor, k: torch.Tensor, *, channel_dim: int = -1) -> torch.Tensor:
    """RGB -> HVI. ``img``: [0, 1] RGB with 3 channels on ``channel_dim``
    (default NHWC). ``k``: density_k, a one-element tensor.

    Returns the same layout with channels (H, V, I), in ``img.dtype``.
    """
    dtype_in = img.dtype
    x = img.float()
    r, g, b = x.unbind(channel_dim)

    value = x.amax(dim=channel_dim)
    img_min = x.amin(dim=channel_dim)
    denom = value - img_min + _EPS

    hue = hue_sextants(r, g, b, value, img_min, denom) / 6.0

    saturation = (value - img_min) / (value + _EPS)
    saturation = torch.where(value == 0, 0.0, saturation)

    cs = color_sensitive(value, k.float().reshape(()))
    ch = torch.cos(2.0 * PI * hue)
    cv = torch.sin(2.0 * PI * hue)
    h_out = cs * saturation * ch
    v_out = cs * saturation * cv
    return torch.stack([h_out, v_out, value], dim=channel_dim).to(dtype_in)


def hvi_to_rgb(
    hvi: torch.Tensor,
    k: torch.Tensor,
    *,
    gated: bool = False,
    gated2: bool = False,
    alpha: float = 1.0,
    alpha_s: float = 1.3,
    channel_dim: int = -1,
) -> torch.Tensor:
    """HVI -> RGB. ``hvi``: channels (H, V, I) on ``channel_dim``.

    ``h == 1.0`` after the floored mod gives ``hi == 6``: no sector matches
    and the pixel stays black, exactly as the reference's zeros-init.
    """
    dtype_in = hvi.dtype
    x = hvi.float()
    h_c, v_c, i_c = x.unbind(channel_dim)
    h_c = torch.clamp(h_c, -1.0, 1.0)
    v_c = torch.clamp(v_c, -1.0, 1.0)
    i_c = torch.clamp(i_c, 0.0, 1.0)

    cs = color_sensitive(i_c, k.float().reshape(()))
    h_c = torch.clamp(h_c / (cs + _EPS), -1.0, 1.0)
    v_c = torch.clamp(v_c / (cs + _EPS), -1.0, 1.0)

    h = torch.remainder(torch.atan2(v_c + _EPS, h_c + _EPS) / (2.0 * PI), 1.0)
    s = torch.sqrt(h_c * h_c + v_c * v_c + _EPS)
    if gated:
        s = s * alpha_s
    s = torch.clamp(s, 0.0, 1.0)
    v = torch.clamp(i_c, 0.0, 1.0)

    hi = torch.floor(h * 6.0)
    f = h * 6.0 - hi
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)

    zero = torch.zeros_like(h)
    r = g = b = zero
    for sector, (rr, gg, bb) in enumerate(
        [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    ):
        m = hi == sector
        r = torch.where(m, rr, r)
        g = torch.where(m, gg, g)
        b = torch.where(m, bb, b)

    rgb = torch.stack([r, g, b], dim=channel_dim)
    if gated2:
        rgb = rgb * alpha
    return rgb.to(dtype_in)
