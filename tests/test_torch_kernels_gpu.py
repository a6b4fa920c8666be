"""The port's CUDA kernels against their plain twins, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips where
``torch.cuda.is_available()`` is False. This file imports no JAX, so on a
machine without jax it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Shapes are small and odd (ragged grid tails, odd extents). Tolerances as in
``chip_smoke.py``: fp32 1e-6 (K1, K3, K4) and 1e-5 (K2) — kernels and
twins run the same fp32 ops in the same order, so they are expected to be
bitwise equal; bf16 one ulp at magnitudes below 2 (2**-7).
"""

import pytest
import torch

from hvi_cidnet_torch.ops import hvi_cuda as hc
from hvi_cidnet_torch.ops import resize_cuda as rc

pytestmark = pytest.mark.gpu

DTYPES = [torch.float32, torch.bfloat16]


def _tol(dt, fp32):
    return fp32 if dt == torch.float32 else 2.0**-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(shape, dev, dt, lo=0.0, hi=1.0, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g) * (hi - lo) + lo).to(dev, dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_k1_matches_twin(cuda, dt):
    img = _rand((3, 17, 29, 3), cuda, dt)
    img[0, 0, :3] = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.7, 0.7, 0.2]], device=cuda)
    k = torch.full((1,), 0.2, device=cuda)
    n = hc.RGB_TO_HVI.launches
    got = hc.rgb_to_hvi(img, k, dt)
    assert hc.RGB_TO_HVI.launches == n + 1
    ref = hc.rgb_to_hvi_plain(img, k, dt)
    torch.testing.assert_close(got, ref, atol=_tol(dt, 1e-6), rtol=0)


@pytest.mark.parametrize("gates", [{}, {"gated": True, "alpha_s": 1.3}, {"gated2": True, "alpha": 0.84}])
@pytest.mark.parametrize("dt", DTYPES)
def test_k2_matches_twin(cuda, dt, gates):
    hvi = _rand((2, 3, 19, 23), cuda, dt, -1.0, 1.0, seed=1)
    k = torch.full((1,), 0.2, device=cuda)
    got = hc.hvi_to_rgb(hvi, k, **gates)
    ref = hc.hvi_to_rgb_plain(hvi, k, **gates)
    assert got.shape == (2, 19, 23, 3)
    torch.testing.assert_close(got, ref, atol=_tol(dt, 1e-5), rtol=0)


@pytest.mark.parametrize("shape", [(2, 5, 50, 150), (1, 3, 7, 9), (3, 2, 2, 2)])
@pytest.mark.parametrize("dt", DTYPES)
def test_k3_matches_twin(cuda, dt, shape):
    x = _rand(shape, cuda, dt, -1.0, 1.0, seed=2)
    a = torch.full((1,), 0.25, device=cuda)
    n = rc.HALF_PRELU.launches
    got = rc.half_prelu(x, a)
    assert rc.HALF_PRELU.launches == n + 1
    torch.testing.assert_close(got, rc.half_prelu_plain(x, a), atol=_tol(dt, 1e-6), rtol=0)


@pytest.mark.parametrize("shape", [(2, 5, 25, 75), (1, 3, 1, 1), (3, 2, 7, 3)])
@pytest.mark.parametrize("dt", DTYPES)
def test_k4_matches_twin(cuda, dt, shape):
    x = _rand(shape, cuda, dt, -1.0, 1.0, seed=3)
    n = rc.DOUBLE.launches
    got = rc.double_bilinear(x)
    assert rc.DOUBLE.launches == n + 1
    torch.testing.assert_close(got, rc.double_bilinear_plain(x), atol=_tol(dt, 1e-6), rtol=0)


def test_backward_runs_the_twins_autograd(cuda):
    x = _rand((2, 3, 12, 10), cuda, torch.float32, -1.0, 1.0, seed=4).requires_grad_()
    a = torch.full((1,), 0.25, device=cuda, requires_grad=True)
    g1 = torch.autograd.grad(rc.double_bilinear(rc.half_prelu(x, a)).square().sum(), (x, a))
    g2 = torch.autograd.grad(
        rc.double_bilinear_plain(rc.half_prelu_plain(x, a)).square().sum(), (x, a))
    for u, v in zip(g1, g2):
        torch.testing.assert_close(u, v, atol=1e-5, rtol=1e-5)

    img = _rand((1, 8, 8, 3), cuda, torch.float32, seed=5).requires_grad_()
    k = torch.full((1,), 0.2, device=cuda, requires_grad=True)
    g1 = torch.autograd.grad(hc.rgb_to_hvi(img, k, torch.float32).square().sum(), (img, k))
    g2 = torch.autograd.grad(hc.rgb_to_hvi_plain(img, k, torch.float32).square().sum(), (img, k))
    for u, v in zip(g1, g2):
        torch.testing.assert_close(u, v, atol=1e-5, rtol=1e-5)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    k = torch.full((1,), 0.2, device=cuda)
    with pytest.raises(TypeError):
        hc.rgb_to_hvi(torch.rand((1, 8, 8, 3), device=cuda, dtype=torch.float16), k, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        rc.double_bilinear(torch.rand((1, 4, 6, 8), device=cuda).transpose(2, 3))
    with pytest.raises(ValueError, match="density_k"):
        hc.rgb_to_hvi(torch.rand((1, 8, 8, 3), device=cuda), torch.full((1,), 0.2), torch.float32)
