"""HVI transform of the PyTorch port vs the JAX package (CPU).

The port's plain twin (``hvi_cidnet_torch/ops/hvi.py``) and its dispatchers
(``ops/hvi_cuda.py``, which take the twin for CPU tensors) are held against
the JAX twin (``hvi_cidnet_tpu/ops/hvi.py``) and against the Pallas kernels
K1/K2 in interpret mode, after the layout change (JAX HWCB, port NCHW).

Tolerances (fp32):
* K1: 1e-6 — the same fp32 formula; only sin/cos/pow ulps differ between
  libraries (and the Pallas kernel's exp(k*log) form of pow).
* K2: 1e-5 — atan2 and sqrt ulps on top of K1's, amplified by the division
  by cs. Pixels whose hue lands on the hi == 6 edge (h within 1e-6 of 1)
  are excluded and counted: one ulp there flips black/not-black.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hvi_cidnet_tpu.ops.hvi import hvi_to_rgb as jax_hvi_to_rgb
from hvi_cidnet_tpu.ops.hvi import rgb_to_hvi as jax_rgb_to_hvi
from hvi_cidnet_tpu.ops.hvi_pallas import hvi_to_rgb_pallas_hwcb, rgb_to_hvi_pallas_hwcb
from hvi_cidnet_torch.ops import hvi as port
from hvi_cidnet_torch.ops import hvi_cuda
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

K = np.array([0.2], np.float32)
GATES = [
    {},
    {"gated": True, "alpha_s": 1.3},
    {"gated2": True, "alpha": 0.84},
    {"gated": True, "gated2": True, "alpha": 0.9, "alpha_s": 1.2},
]


def _img(shape=(2, 17, 23, 3), seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def special_pixels() -> np.ndarray:
    """Ties in every order, gray, zero, one, and saturated primaries: the
    select chain's priority and the value == 0 / gray branches."""
    px = [
        [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.5, 0.5],  # zero, one, gray
        [0.7, 0.7, 0.2], [0.7, 0.2, 0.7], [0.2, 0.7, 0.7],  # two-way max ties
        [0.2, 0.2, 0.7], [0.2, 0.7, 0.2], [0.7, 0.2, 0.2],  # two-way min ties
        [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],  # primaries
        [0.3, 0.2, 0.25], [0.3, 0.25, 0.2], [1e-8, 0.0, 0.0],  # negative hue, tiny
    ]
    return np.asarray(px, np.float32).reshape(1, 3, 5, 3)


def hi6_edge_hvi() -> np.ndarray:
    """HVI pixels whose inverse hue is a tiny negative angle: the floored
    mod(., 1) wraps it to 1 - tiny, which rounds to 1.0f -> hi == 6 -> black."""
    i = np.full(8, 0.5, np.float32)
    h = np.linspace(0.2, 0.6, 8).astype(np.float32)
    cs = (np.sin(0.5 * np.pi * 0.5) + 1e-8) ** 0.2
    v = (-np.linspace(1.2e-8, 2.0e-8, 8) * cs).astype(np.float32)
    return np.stack([h, v, i], -1).reshape(1, 2, 4, 3)


def _jax_h(hvi: np.ndarray) -> np.ndarray:
    """The hue the inverse computes, in float64 (for the edge exclusion)."""
    x = hvi.astype(np.float64)
    hc, vc, ic = np.clip(x[..., 0], -1, 1), np.clip(x[..., 1], -1, 1), np.clip(x[..., 2], 0, 1)
    cs = (np.sin(ic * 0.5 * np.pi) + 1e-8) ** 0.2
    hc, vc = np.clip(hc / (cs + 1e-8), -1, 1), np.clip(vc / (cs + 1e-8), -1, 1)
    return np.mod(np.arctan2(vc + 1e-8, hc + 1e-8) / (2 * np.pi), 1.0)


def assert_rgb_close(got: np.ndarray, ref: np.ndarray, hvi: np.ndarray, atol=1e-5) -> int:
    """Compare NHWC RGB outside the hi == 6 edge; return the edge count."""
    h = _jax_h(hvi)
    edge = np.minimum(h, 1 - h) < 1e-6
    keep = ~edge
    np.testing.assert_allclose(got[keep], ref[keep], atol=atol, rtol=0)
    return int(edge.sum())


def test_rgb_to_hvi_matches_jax_twin():
    img = np.concatenate([_img((1, 3, 5, 3), 1), special_pixels()])
    ref = np.asarray(jax_rgb_to_hvi(jnp.asarray(img), jnp.asarray(K)))
    got = port.rgb_to_hvi(torch.from_numpy(img), torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _rgb_grid() -> torch.Tensor:
    """(N, 3) fp32 RGB: every channel at the 65 steps of 1/64 (all ties,
    grays and orders), the bf16 values of [0, 1] in each channel against
    fixed others, and uniform draws."""
    steps = torch.linspace(0.0, 1.0, 65)
    grid = torch.cartesian_prod(steps, steps, steps)
    bf16 = torch.arange(0x3F81, dtype=torch.int16).view(torch.bfloat16).float()  # [0, 1]
    fixed = lambda u: torch.full_like(bf16, u)
    sweeps = [torch.stack([bf16, fixed(u), fixed(v)], -1).roll(c, -1)
              for c in range(3) for u, v in ((0.3, 0.7), (0.5, 0.5), (0.0, 1.0))]
    rng = np.random.default_rng(7)
    draws = torch.from_numpy(rng.uniform(0, 1, (200_000, 3)).astype(np.float32))
    return torch.cat([grid, *sweeps, draws])


def test_k1_hue_rewrites_equal_the_twin():
    """K1's hue (``csrc/hvi.cu:rgb_to_hvi_pixel``) in torch ops: the
    numerator picked in the select chain's priority and divided once, the
    floored mod(x, 6) as x < 0 ? x + 6 : x. Both are exact: bitwise the
    twin's hue in sextants. Then the kernel multiplies by fp32(1 / 6), as
    the card's twin does for its "/ 6.0"; the CPU's twin divides, and the
    two differ by at most one ulp."""
    special = torch.from_numpy(special_pixels().reshape(-1, 3))
    rgb = torch.cat([special, _rgb_grid()])
    r, g, b = rgb.unbind(-1)
    value, img_min = rgb.amax(-1), rgb.amin(-1)
    denom = value - img_min + 1e-8
    r_max, g_max = r == value, g == value
    q = torch.where(r_max, g - b, torch.where(g_max, b - r, r - g)) / denom
    assert q.abs().max() <= 1.0
    offset = torch.where(g_max, 2.0, 4.0)
    hue = torch.where(r_max, torch.where(q < 0, q + 6.0, q), offset + q)
    hue = torch.where(img_min == value, 0.0, hue)
    twin = port.hue_sextants(r, g, b, value, img_min, denom)
    assert torch.equal(hue, twin)
    assert torch.equal(torch.signbit(hue), torch.signbit(twin))  # -0 stays -0
    assert (hue < 0).sum() == 0 and (hue == 0).sum() > 65
    scaled = hue * torch.tensor(1.0 / 6.0, dtype=torch.float32)
    ulp = torch.finfo(torch.float32).eps * (twin / 6.0).abs().clamp_min(2.0**-126)
    assert ((scaled - twin / 6.0).abs() <= ulp).all()


def test_rgb_to_hvi_dispatch_matches_pallas_hwcb():
    """K1's twin as the model calls it (NHWC in, NCHW out) vs the Pallas
    kernel's HWCB output, interpret mode."""
    img = _img(seed=2)
    img[0, :3, :5] = special_pixels()[0]
    ref_hwcb = np.asarray(rgb_to_hvi_pallas_hwcb(jnp.asarray(img), 0.2, interpret=True))
    got = hvi_cuda.rgb_to_hvi(torch.from_numpy(img), torch.from_numpy(K), torch.float32)
    assert got.shape == (2, 3, 17, 23) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref_hwcb.transpose(3, 2, 0, 1), atol=1e-6, rtol=0)


@pytest.mark.parametrize("gates", GATES)
def test_hvi_to_rgb_matches_jax_twin(gates):
    hvi = np.asarray(jax_rgb_to_hvi(jnp.asarray(_img(seed=3)), jnp.asarray(K)))
    hvi = hvi + np.random.default_rng(4).normal(0, 0.05, hvi.shape).astype(np.float32)
    ref = np.asarray(jax_hvi_to_rgb(jnp.asarray(hvi), jnp.asarray(K), **gates))
    got = port.hvi_to_rgb(torch.from_numpy(hvi), torch.from_numpy(K), **gates).numpy()
    edges = assert_rgb_close(got, ref, hvi)
    assert edges <= 2, f"{edges} pixels on the hi == 6 edge"


@pytest.mark.parametrize("gates", [GATES[0], GATES[3]])
def test_hvi_to_rgb_dispatch_matches_pallas_hwcb(gates):
    """K2's twin as the model calls it (NCHW in, NHWC out) vs the Pallas
    kernel's HWCB-in / NHWC-out wrapper, interpret mode."""
    hvi = np.asarray(jax_rgb_to_hvi(jnp.asarray(_img(seed=5)), jnp.asarray(K)))
    ref = np.asarray(
        hvi_to_rgb_pallas_hwcb(jnp.asarray(hvi.transpose(1, 2, 3, 0)), 0.2, interpret=True, **gates)
    )
    got = hvi_cuda.hvi_to_rgb(
        torch.from_numpy(np.ascontiguousarray(hvi.transpose(0, 3, 1, 2))), torch.from_numpy(K),
        **gates,
    )
    assert got.shape == (2, 17, 23, 3) and got.is_contiguous()
    edges = assert_rgb_close(got.numpy(), ref, hvi)
    assert edges <= 2, f"{edges} pixels on the hi == 6 edge"


def test_hvi_to_rgb_dispatch_matches_pallas_hwcb_at_batch_3():
    """K2's twin at batch 3 (the card's grid has one row of blocks per
    image) with every gate on, vs the Pallas kernel in interpret mode."""
    gates = GATES[3]
    hvi = np.asarray(jax_rgb_to_hvi(jnp.asarray(_img((3, 16, 24, 3), seed=8)), jnp.asarray(K)))
    hvi = hvi + np.random.default_rng(9).normal(0, 0.05, hvi.shape).astype(np.float32)
    ref = np.asarray(
        hvi_to_rgb_pallas_hwcb(jnp.asarray(hvi.transpose(1, 2, 3, 0)), 0.2, interpret=True, **gates)
    )
    got = hvi_cuda.hvi_to_rgb(
        torch.from_numpy(np.ascontiguousarray(hvi.transpose(0, 3, 1, 2))), torch.from_numpy(K),
        **gates,
    )
    assert got.shape == (3, 16, 24, 3) and got.is_contiguous()
    edges = assert_rgb_close(got.numpy(), ref, hvi)
    assert edges <= 2, f"{edges} pixels on the hi == 6 edge"


def test_hi6_edge_is_black_in_both():
    hvi = hi6_edge_hvi()
    ref = np.asarray(jax_hvi_to_rgb(jnp.asarray(hvi), jnp.asarray(K)))
    got = port.hvi_to_rgb(torch.from_numpy(hvi), torch.from_numpy(K)).numpy()
    black_ref = (ref == 0).all(-1)
    black_got = (got == 0).all(-1)
    assert black_ref.sum() >= 4, "the probe must actually hit the hi == 6 edge"
    np.testing.assert_array_equal(black_got, black_ref)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_special_pixels_roundtrip_matches_jax():
    img = special_pixels()
    hvi = jax_rgb_to_hvi(jnp.asarray(img), jnp.asarray(K))
    ref = np.asarray(jax_hvi_to_rgb(hvi, jnp.asarray(K)))
    hvi_t = port.rgb_to_hvi(torch.from_numpy(img), torch.from_numpy(K))
    got = port.hvi_to_rgb(hvi_t, torch.from_numpy(K)).numpy()
    assert_rgb_close(got, ref, np.asarray(hvi))


def test_bf16_input():
    """bf16 in: both compute in fp32 from the same bf16 values and round once
    to bf16, so they differ by at most one bf16 ulp (2**-8 below 1 in
    magnitude, 2**-7 at 1)."""
    img32 = _img(seed=6)
    img_bf = torch.from_numpy(img32).to(torch.bfloat16)
    jimg = jnp.asarray(img_bf.float().numpy()).astype(jnp.bfloat16)
    ref = np.asarray(jax_rgb_to_hvi(jimg, jnp.asarray(K)).astype(jnp.float32))
    got_t = port.rgb_to_hvi(img_bf, torch.from_numpy(K))
    assert got_t.dtype == torch.bfloat16
    np.testing.assert_allclose(got_t.float().numpy(), ref, atol=2**-7, rtol=0)

    ref_inv = np.asarray(jax_hvi_to_rgb(jnp.asarray(ref).astype(jnp.bfloat16), jnp.asarray(K))
                         .astype(jnp.float32))
    got_inv = port.hvi_to_rgb(got_t, torch.from_numpy(K))
    assert got_inv.dtype == torch.bfloat16
    assert_rgb_close(got_inv.float().numpy(), ref_inv, ref, atol=2**-7)

    # K1's twin into a compute dtype: rounds through the input dtype first
    out = hvi_cuda.rgb_to_hvi(img_bf, torch.from_numpy(K), torch.float32)
    np.testing.assert_array_equal(out.numpy(), got_t.float().permute(0, 3, 1, 2).numpy())


def test_density_k_gradient_flows_through_hvit_only():
    """PHVIT takes k detached (HVI_transform.py:38,59): the gradient of a
    round trip w.r.t. k equals HVIT's alone."""
    img = torch.from_numpy(_img((1, 5, 7, 3), 7))
    k = torch.tensor([0.2], requires_grad=True)
    hvi = hvi_cuda.rgb_to_hvi(img, k, torch.float32)
    out = hvi_cuda.hvi_to_rgb(hvi, k.detach())
    (g_rt,) = torch.autograd.grad(out.square().sum(), k)
    assert torch.isfinite(g_rt).all() and g_rt.abs().item() > 0


def test_kernel_wrappers_reject_cpu_tensors():
    """The CUDA entry points raise on what the kernel does not take, before
    any build or launch."""
    img = torch.from_numpy(_img((1, 8, 8, 3)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        hvi_cuda.rgb_to_hvi_kernel(img, torch.from_numpy(K), torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hvi_cuda.hvi_to_rgb_kernel(img.permute(0, 3, 1, 2).contiguous(), torch.from_numpy(K))
    assert hvi_cuda.RGB_TO_HVI.launches == 0 and hvi_cuda.HVI_TO_RGB.launches == 0
