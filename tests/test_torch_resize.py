"""Bilinear x0.5 + PReLU and x2 of the PyTorch port vs the JAX package (CPU).

* The band weights K3/K4 run with are bitwise the JAX package's.
* The plain twins (banded taps with those weights, the shared-slope PReLU)
  vs the Pallas kernels in interpret mode and vs the banded XLA twins, on
  NCHW vs HWCB. Shapes include the odd extent 75 (600 / 8), which the
  600 x 400 serving shape reaches at level 3. Tolerance 1e-6 (fp32, inputs
  in [-1, 1]): the same weights and tap order, so only the summation of
  the XLA/interpret paths can differ, by an ulp or two.
* ``F.interpolate(..., align_corners=True)`` as an independent check, at a
  tolerance from its own error: it forms each source position as an fp32
  scale times the index, so a tap weight is off by up to ~size * 2**-24.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from hvi_cidnet_tpu.ops.conv import prelu as jax_prelu
from hvi_cidnet_tpu.ops.resize import _band_weights as jax_band_weights
from hvi_cidnet_tpu.ops.resize import _interp_matrix as jax_interp_matrix
from hvi_cidnet_tpu.ops.resize import scale_double_hwcb, scale_half_hwcb
from hvi_cidnet_tpu.ops.resize_pallas import scale_double_pallas, scale_half_pallas
from hvi_cidnet_torch.ops import resize as port_resize
from hvi_cidnet_torch.ops import resize_cuda

# extents the 600 x 400 forward reaches (and small, odd and tiny ones)
SIZES = [2, 3, 4, 7, 16, 25, 50, 75, 100, 150, 200, 300, 400, 600]
ALPHA = 0.25


def _hwcb(shape, seed):
    """HWCB numpy input in [-1, 1] and its NCHW torch twin."""
    x = np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)
    return x, torch.from_numpy(np.ascontiguousarray(x.transpose(3, 2, 0, 1)))


def _to_nchw(y_hwcb: np.ndarray) -> np.ndarray:
    return np.asarray(y_hwcb).transpose(3, 2, 0, 1)


@pytest.mark.parametrize("size", SIZES)
def test_band_weights_bitwise_equal_jax(size):
    for out_size in (size // 2 or 1, 2 * size):
        np.testing.assert_array_equal(
            port_resize._interp_matrix(size, out_size), jax_interp_matrix(size, out_size, True)
        )
    half = port_resize.half_weights(size)
    ref = np.stack(jax_band_weights(
        size, size // 2, [lambda i: 2 * i, lambda i: 2 * i + 1, lambda i: 2 * i + 2]))
    assert half.dtype == np.float32 and half.shape == (3, size // 2)
    np.testing.assert_array_equal(half, ref)

    ae, be = jax_band_weights(size, 2 * size, [lambda i: i // 2 - 1, lambda i: i // 2])
    ao, bo = jax_band_weights(size, 2 * size, [lambda i: i // 2, lambda i: i // 2 + 1])
    dbl = port_resize.double_weights(size)
    assert dbl.dtype == np.float32 and dbl.shape == (4, size)
    np.testing.assert_array_equal(dbl, np.stack([ae[0::2], be[0::2], ao[1::2], bo[1::2]]))


def test_edge_taps_have_zero_weight():
    """The taps the kernels clamp at the border must carry weight 0."""
    for size in SIZES:
        if size % 2 == 0:
            assert port_resize.half_weights(size)[2, -1] == 0.0  # source 2i+2 == size
        dbl = port_resize.double_weights(size)
        assert dbl[0, 0] == 0.0 and dbl[3, -1] == 0.0  # sources -1 and size


@pytest.mark.parametrize("shape", [(16, 150, 5, 2), (50, 76, 3, 2)])
def test_half_prelu_plain_matches_pallas(shape):
    x, xt = _hwcb(shape, 0)
    ref = scale_half_pallas(jnp.asarray(x), prelu_alpha=ALPHA, interpret=True)
    got = resize_cuda.half_prelu(xt, torch.tensor([ALPHA]))
    assert got.shape == (shape[3], shape[2], shape[0] // 2, shape[1] // 2)
    np.testing.assert_allclose(got.numpy(), _to_nchw(ref), atol=1e-6, rtol=0)


def test_half_prelu_plain_matches_pallas_at_the_block3_site():
    """K3's twin at block3's extents (100 x 150 -> 50 x 75, the odd output
    width where the card's stores are 2 bytes wide), a few channels."""
    x, xt = _hwcb((100, 150, 3, 2), 8)
    ref = scale_half_pallas(jnp.asarray(x), prelu_alpha=ALPHA, interpret=True)
    got = resize_cuda.half_prelu(xt, torch.tensor([ALPHA]))
    assert got.shape == (2, 3, 50, 75)
    np.testing.assert_allclose(got.numpy(), _to_nchw(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(8, 75, 3, 2), (25, 16, 4, 2)])
def test_double_plain_matches_pallas(shape):
    x, xt = _hwcb(shape, 1)
    ref = scale_double_pallas(jnp.asarray(x), interpret=True)
    got = resize_cuda.double_bilinear(xt)
    assert got.shape == (shape[3], shape[2], 2 * shape[0], 2 * shape[1])
    np.testing.assert_allclose(got.numpy(), _to_nchw(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "shape", [(100, 150, 4, 2), (50, 150, 3, 1), (64, 48, 6, 2), (2, 2, 1, 1)]
)
def test_half_prelu_plain_matches_banded_twin(shape):
    x, xt = _hwcb(shape, 2)
    ref = jax_prelu(scale_half_hwcb(jnp.asarray(x)), ALPHA)
    got = resize_cuda.half_prelu_plain(xt, torch.tensor([ALPHA]))
    np.testing.assert_allclose(got.numpy(), _to_nchw(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(400, 600), (100, 150), (50, 75), (7, 3)])
def test_twins_agree_with_f_interpolate(hw):
    """Up to F.interpolate's own fp32 weight error: taps of |x| <= 1 on two
    axes, each weight off by <= ~2 * size * 2**-24."""
    h, w = hw
    xt = torch.from_numpy(
        np.random.default_rng(6).uniform(-1, 1, (1, 2, h, w)).astype(np.float32))
    bound = 4 * max(h, w) * 2.0**-24 + 1e-6
    if h > 1 and w > 1:
        ref = F.interpolate(xt, size=(h // 2, w // 2), mode="bilinear", align_corners=True)
        got = port_resize.scale_half_f32(xt)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=bound, rtol=0)
    ref = F.interpolate(xt, size=(2 * h, 2 * w), mode="bilinear", align_corners=True)
    got = port_resize.scale_double_f32(xt)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=bound, rtol=0)


def test_bf16_twins_round_once_from_fp32():
    """bf16 in: the twins compute in fp32 and round once, as the kernels do."""
    x = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, (2, 3, 10, 14)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    a = torch.tensor([ALPHA])
    half = resize_cuda.half_prelu_plain(xb, a)
    assert half.dtype == torch.bfloat16
    ref = resize_cuda.half_prelu_plain(xb.float(), a).to(torch.bfloat16)
    torch.testing.assert_close(half, ref, rtol=0, atol=0)
    dbl = resize_cuda.double_bilinear_plain(xb)
    torch.testing.assert_close(dbl, resize_cuda.double_bilinear_plain(xb.float()).to(torch.bfloat16),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(50, 75, 4, 2), (25, 75, 3, 1), (1, 1, 2, 1), (7, 3, 2, 2)])
def test_double_plain_matches_banded_twin(shape):
    x, xt = _hwcb(shape, 3)
    ref = scale_double_hwcb(jnp.asarray(x))
    got = resize_cuda.double_bilinear_plain(xt)
    np.testing.assert_allclose(got.numpy(), _to_nchw(ref), atol=1e-6, rtol=0)


def test_dispatchers_take_the_twin_on_cpu():
    _, xt = _hwcb((12, 10, 3, 2), 4)
    a = torch.tensor([0.1])
    torch.testing.assert_close(resize_cuda.half_prelu(xt, a), resize_cuda.half_prelu_plain(xt, a),
                               rtol=0, atol=0)
    torch.testing.assert_close(resize_cuda.double_bilinear(xt), resize_cuda.double_bilinear_plain(xt),
                               rtol=0, atol=0)
    assert resize_cuda.HALF_PRELU.launches == 0 and resize_cuda.DOUBLE.launches == 0


def test_kernel_wrappers_reject_what_the_kernel_does_not_take():
    _, xt = _hwcb((8, 8, 2, 1), 5)
    a = torch.tensor([ALPHA])
    with pytest.raises(ValueError, match="CUDA tensor"):
        resize_cuda.half_prelu_kernel(xt, a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        resize_cuda.double_bilinear_kernel(xt)
