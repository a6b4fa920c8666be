"""The port's CUDA kernels against their plain twins, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips where
``torch.cuda.is_available()`` is False. This file imports no JAX, so on a
machine without jax it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Shapes are small and odd (ragged grid tails, odd extents). K4 and K7 are
held to bitwise equality (``torch.equal``) in fp32 and bf16: they run the
twins' fp32 ops in the same order. Tolerances of the others as in
``chip_smoke.py``: fp32 1e-6 (K1, K3) and 1e-5 (K2), bf16 one ulp at
magnitudes below 2 (2**-7). K5 and K6 sum
over space or channels in another order than the twin's cuBLAS GEMM or
torch reduction: fp32 2e-5 (K5) and 1e-5 (K6); bf16 two ulps relative,
|err| <= 2**-6 * max(1, |ref|) (a last-bit difference in an fp32 value can
flip the bf16 rounding of one intermediate, and a flip moves the output by
an ulp).
"""

import pytest
import torch

from hvi_cidnet_torch.ops import attention_cuda as ac
from hvi_cidnet_torch.ops import hvi_cuda as hc
from hvi_cidnet_torch.ops import iel_cuda as ic
from hvi_cidnet_torch.ops import norm_cuda as nc
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


# K4 and K7 are bitwise equal to their twins (torch.equal). Beyond the
# small odd shapes: each site shape of the 600 x 400 forward at batch 1,
# widths whose bf16 row pitch is not a multiple of 16 bytes (75, 150, 300,
# odd), heights and widths off the band and tile sizes, fewer planes than
# SMs, and a tensor that starts 2-4 bytes past a 16-byte boundary and ends
# at the end of its allocation ("edge").
def _edge_tensor(shape, dev, dt, lo, hi, seed):
    """A contiguous view one element into a fresh buffer whose bytes are a
    multiple of 512: its end is the end of the caching allocator's block."""
    n = 1
    for s in shape:
        n *= s
    assert ((n + 1) * torch.tensor([], dtype=dt).element_size()) % 512 == 0
    buf = torch.empty(n + 1, device=dev, dtype=dt)
    buf[1:] = _rand((n,), dev, dt, lo, hi, seed)
    t = buf[1:].view(shape)
    assert t.data_ptr() % 16 != 0 and t.is_contiguous()
    return t


K4_SHAPES = [(2, 5, 25, 75), (1, 3, 1, 1), (3, 2, 7, 3),
             (1, 72, 50, 75), (1, 36, 100, 150), (1, 36, 200, 300),
             (2, 3, 13, 151), (1, 4, 33, 8), "edge"]


@pytest.mark.parametrize("shape", K4_SHAPES, ids=str)
@pytest.mark.parametrize("dt", DTYPES)
def test_k4_matches_twin(cuda, dt, shape):
    if shape == "edge":
        x = _edge_tensor((1, 1, 7, 73), cuda, dt, -1.0, 1.0, seed=3)
    else:
        x = _rand(shape, cuda, dt, -1.0, 1.0, seed=3)
    n = rc.DOUBLE.launches
    got = rc.double_bilinear(x)
    assert rc.DOUBLE.launches == n + 1
    assert torch.equal(got, rc.double_bilinear_plain(x))


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


def _close_rel(got, ref, dt, fp32):
    """fp32: absolute ``fp32``; bf16: two ulps relative (see the module doc)."""
    if dt == torch.float32:
        torch.testing.assert_close(got, ref, atol=fp32, rtol=0)
        return
    err = (got.float() - ref.float()).abs()
    bound = 2.0**-6 * ref.float().abs().clamp_min(1.0)
    assert (err <= bound).all(), f"max err {err.max().item():.3e}, worst ratio {(err / bound).max():.2f}"


@pytest.mark.parametrize("case", [
    (2, 12, 7, 9, 3, True, True), (2, 12, 7, 9, 1, False, True), (1, 16, 5, 40, 4, True, False),
    (3, 144, 3, 50, 8, True, True), (1, 192, 4, 33, 1, True, True), (2, 36, 1, 1, 2, False, False),
], ids=["h3", "h1_nonorm", "h4_nofold", "c144", "c192_groups", "n1"])
@pytest.mark.parametrize("dt", DTYPES)
def test_k5_matches_twin(cuda, dt, case):
    b, c, h, w, heads, normalize_qk, fold = case
    scale = 1.0 if normalize_qk else (h * w) ** -0.5  # unnormalised scores stay unsaturated
    q, k = (_rand((b, c, h, w), cuda, dt, -scale, scale, seed=s) for s in (6, 7))
    v = _rand((b, c, h, w), cuda, dt, -1.0, 1.0, seed=8)
    temp = _rand((heads, 1, 1), cuda, torch.float32, 0.5, 2.0, seed=9)
    wp = _rand((c, c, 1, 1), cuda, dt, -0.3, 0.3, seed=10) if fold else None
    n = ac.ATTENTION.launches
    got = ac.channel_attention(q, k, v, temp, heads, normalize_qk=normalize_qk, w_proj=wp)
    assert ac.ATTENTION.launches == n + 1
    ref = ac.channel_attention_plain(q, k, v, temp, heads, normalize_qk=normalize_qk, w_proj=wp)
    _close_rel(got, ref, dt, 2e-5)


def test_k5_is_bitwise_repeatable(cuda):
    q, k, v = (_rand((2, 72, 30, 41), cuda, torch.bfloat16, -1.0, 1.0, seed=s) for s in (11, 12, 13))
    temp = _rand((4, 1, 1), cuda, torch.float32, 0.5, 2.0, seed=14)
    wp = _rand((72, 72, 1, 1), cuda, torch.bfloat16, -0.3, 0.3, seed=15)
    a = ac.channel_attention(q, k, v, temp, 4, w_proj=wp)
    assert torch.equal(a, ac.channel_attention(q, k, v, temp, 4, w_proj=wp))


@pytest.mark.parametrize("shape", [(2, 36, 7, 9), (1, 144, 3, 130), (3, 5, 1, 1), (1, 256, 2, 3)])
@pytest.mark.parametrize("dt", DTYPES)
def test_k6_matches_twin(cuda, dt, shape):
    x = _rand(shape, cuda, dt, -2.0, 3.0, seed=16)
    wgt = _rand((shape[1],), cuda, torch.float32, 0.5, 1.5, seed=17)
    bias = _rand((shape[1],), cuda, torch.float32, -0.5, 0.5, seed=18)
    n = nc.LAYER_NORM.launches
    got = nc.layer_norm(x, wgt, bias)
    assert nc.LAYER_NORM.launches == n + 1
    _close_rel(got, nc.layer_norm_plain(x, wgt, bias), dt, 1e-5)


K7_SHAPES = [(2, 5, 17, 33), (1, 3, 1, 1), (1, 2, 40, 70), (2, 3, 16, 32),
             (1, 95, 200, 300), (1, 191, 100, 150), (1, 383, 50, 75),
             (1, 4, 37, 151), (2, 3, 2, 640), (1, 2, 123, 1), "edge"]


@pytest.mark.parametrize("shape", K7_SHAPES, ids=str)
@pytest.mark.parametrize("dt", DTYPES)
def test_k7_matches_twin(cuda, dt, shape):
    if shape == "edge":
        shape = (1, 5, 17, 3)
        y = _edge_tensor(shape, cuda, dt, -1.5, 1.5, seed=19)
    else:
        y = _rand(shape, cuda, dt, -1.5, 1.5, seed=19)
    w1, w2 = (_rand((shape[1], 1, 3, 3), cuda, dt, -0.5, 0.5, seed=s) for s in (20, 21))
    n = ic.IEL_BRANCH.launches
    got = ic.iel_branch(y, w1, w2)
    assert ic.IEL_BRANCH.launches == n + 1
    assert torch.equal(got, ic.iel_branch_plain(y, w1, w2))


def test_lca_kernels_backward_runs_the_twins_autograd(cuda):
    f32 = torch.float32
    q, k, v = (_rand((2, 8, 5, 6), cuda, f32, -1.0, 1.0, seed=s).requires_grad_() for s in (22, 23, 24))
    temp = _rand((2, 1, 1), cuda, f32, 0.5, 2.0, seed=25).requires_grad_()
    wp = _rand((8, 8, 1, 1), cuda, f32, -0.3, 0.3, seed=26).requires_grad_()
    for fold in (wp, None):
        args = (q, k, v, temp) + ((fold,) if fold is not None else ())
        g1 = torch.autograd.grad(ac.channel_attention(q, k, v, temp, 2, w_proj=fold).square().sum(), args)
        g2 = torch.autograd.grad(
            ac.channel_attention_plain(q, k, v, temp, 2, w_proj=fold).square().sum(), args)
        for u, w in zip(g1, g2):
            torch.testing.assert_close(u, w, atol=1e-5, rtol=1e-5)

    x = _rand((2, 6, 4, 5), cuda, f32, -1.0, 1.0, seed=27).requires_grad_()
    wgt = _rand((6,), cuda, f32, 0.5, 1.5, seed=28).requires_grad_()
    bias = _rand((6,), cuda, f32, -0.5, 0.5, seed=29).requires_grad_()
    g1 = torch.autograd.grad(nc.layer_norm(x, wgt, bias).square().sum(), (x, wgt, bias))
    g2 = torch.autograd.grad(nc.layer_norm_plain(x, wgt, bias).square().sum(), (x, wgt, bias))
    for u, w in zip(g1, g2):
        torch.testing.assert_close(u, w, atol=1e-5, rtol=1e-5)

    y = _rand((2, 3, 6, 7), cuda, f32, -1.0, 1.0, seed=30).requires_grad_()
    w1, w2 = (_rand((3, 1, 3, 3), cuda, f32, -0.5, 0.5, seed=s).requires_grad_() for s in (31, 32))
    g1 = torch.autograd.grad(ic.iel_branch(y, w1, w2).square().sum(), (y, w1, w2))
    g2 = torch.autograd.grad(ic.iel_branch_plain(y, w1, w2).square().sum(), (y, w1, w2))
    for u, w in zip(g1, g2):
        torch.testing.assert_close(u, w, atol=1e-5, rtol=1e-5)


def test_lca_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    temp = torch.ones((1, 1, 1), device=cuda)
    big = torch.rand((1, 200, 4, 4), device=cuda)
    with pytest.raises(ValueError, match="C <= 192"):
        ac.channel_attention(big, big, big, temp, 1)
    t = torch.rand((1, 8, 4, 6), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ac.channel_attention(t.transpose(2, 3), t.transpose(2, 3), t.transpose(2, 3), temp, 1)
    with pytest.raises(TypeError):
        h = t.half()
        ac.channel_attention(h, h, h, temp, 1)
    with pytest.raises(ValueError, match="temperature"):
        ac.channel_attention(t, t, t, torch.ones((2, 1, 1), device=cuda), 1)
    with pytest.raises(ValueError, match="C <= 256"):
        x = torch.rand((1, 300, 2, 2), device=cuda)
        nc.layer_norm(x, torch.ones(300, device=cuda), torch.zeros(300, device=cuda))
    with pytest.raises(ValueError, match="weight"):
        nc.layer_norm(t, torch.ones(8, device=cuda, dtype=torch.bfloat16), torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="depthwise"):
        ic.iel_branch(t, torch.rand((8, 1, 5, 5), device=cuda), torch.rand((8, 1, 3, 3), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        w3 = torch.rand((8, 1, 3, 3), device=cuda)
        ic.iel_branch(t.transpose(2, 3), w3, w3)
