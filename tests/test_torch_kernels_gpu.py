"""The port's CUDA kernels against their plain twins, on the card.

Marked ``gpu``: every test takes the ``cuda`` fixture, which skips where
``torch.cuda.is_available()`` is False. This file imports no JAX, so on a
machine without jax it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Shapes are small and odd (ragged grid tails, odd extents). K1, K3, K4 and
K7 are held to bitwise equality (``torch.equal``) in fp32 and bf16: they
run the twins' fp32 ops in the same order (K1 with exact rewrites).
Tolerances of the others as in ``chip_smoke.py``: fp32 1e-5 (K2), bf16 one
ulp at magnitudes below 2 (2**-7). K5 and K6 sum
over space or channels in another order than the twin's cuBLAS GEMM or
torch reduction: fp32 2e-5 (K5) and 1e-5 (K6); bf16 two ulps relative,
|err| <= 2**-6 * max(1, |ref|) (a last-bit difference in an fp32 value can
flip the bf16 rounding of one intermediate, and a flip moves the output by
an ulp). K5's fp32 reference is its twin run on the CPU (``_k5_twin``).
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
    assert torch.equal(got, ref)


# the select chain's ties, gray, zero, one, a negative hue, a tiny value
K1_SPECIAL = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.5, 0.5], [0.7, 0.7, 0.2], [0.7, 0.2, 0.7],
              [0.2, 0.7, 0.7], [0.2, 0.2, 0.7], [0.2, 0.7, 0.2], [0.7, 0.2, 0.2], [0.3, 0.2, 0.25],
              [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1e-8, 0.0, 0.0]]


def _k1_input(shape, dev, dt, seed):
    """Uniform RGB with K1_SPECIAL planted in the first pixels. "edge": a
    (1, 5, 17, 3) tensor 2-4 bytes past a 16-byte boundary that ends at its
    allocation's end; "offset": a (2, 9, 13, 3) view three elements into a
    buffer (6 or 12 bytes past a boundary, so every block's NHWC line
    starts off alignment)."""
    if shape == "edge":
        return _edge_tensor((1, 5, 17, 3), dev, dt, 0.0, 1.0, seed)
    if shape == "offset":
        buf = _rand((3 + 2 * 9 * 13 * 3,), dev, dt, seed=seed)
        img = buf[3:].view(2, 9, 13, 3)
        assert img.data_ptr() % 16 != 0
        return img
    img = _rand(shape, dev, dt, seed=seed)
    flat = img.view(-1, 3)
    m = min(len(K1_SPECIAL), flat.shape[0])
    flat[:m] = torch.tensor(K1_SPECIAL[:m], device=dev, dtype=dt)
    return img


# K1 at odd sizes (H * W odd: 2-byte bf16 or 4-byte fp32 plane stores), a
# run that ends inside an image, the 600 x 400 image at batch 1, batch 33,
# inputs off 16-byte alignment, and the two mixed dtype pairs: bitwise equal
# to the twin on the card
@pytest.mark.parametrize("shape", [(3, 17, 29, 3), (2, 24, 41, 3), (1, 1, 1, 3), (33, 5, 7, 3),
                                   (33, 16, 24, 3), (1, 400, 600, 3), "edge", "offset"], ids=str)
@pytest.mark.parametrize("dts", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                                 (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)],
                         ids=["fp32", "bf16", "fp32-bf16", "bf16-fp32"])
def test_k1_matches_twin_at_every_plan(cuda, dts, shape):
    dt_in, dt_out = dts
    img = _k1_input(shape, cuda, dt_in, seed=35)
    k = torch.full((1,), 0.2, device=cuda)
    n = hc.RGB_TO_HVI.launches
    got = hc.rgb_to_hvi(img, k, dt_out)
    assert hc.RGB_TO_HVI.launches == n + 1
    b, h, w, _ = img.shape
    assert got.shape == (b, 3, h, w) and got.dtype == dt_out and got.is_contiguous()
    assert torch.equal(got, hc.rgb_to_hvi_plain(img, k, dt_out))


@pytest.mark.parametrize("gates", [{}, {"gated": True, "alpha_s": 1.3}, {"gated2": True, "alpha": 0.84}])
@pytest.mark.parametrize("dt", DTYPES)
def test_k2_matches_twin(cuda, dt, gates):
    hvi = _rand((2, 3, 19, 23), cuda, dt, -1.0, 1.0, seed=1)
    k = torch.full((1,), 0.2, device=cuda)
    got = hc.hvi_to_rgb(hvi, k, **gates)
    ref = hc.hvi_to_rgb_plain(hvi, k, **gates)
    assert got.shape == (2, 19, 23, 3)
    torch.testing.assert_close(got, ref, atol=_tol(dt, 1e-5), rtol=0)


# K2 beyond the odd shape above: H * W a multiple of 4 but not of 8 (bf16
# takes 8-byte plane loads), of 8 but a run that ends inside an image, the
# 600 x 400 image at batch 1 and 3, every gate arm, and an input 2-4 bytes
# past a 16-byte boundary ("edge": element loads)
K2_GATES = [{}, {"gated": True, "alpha_s": 1.3}, {"gated2": True, "alpha": 0.84},
            {"gated": True, "gated2": True, "alpha": 0.9, "alpha_s": 1.2}]


@pytest.mark.parametrize("shape", [(3, 3, 6, 10), (2, 3, 24, 41), (1, 3, 400, 600),
                                   (3, 3, 400, 600), "edge"], ids=str)
@pytest.mark.parametrize("gates", K2_GATES, ids=["none", "gated", "gated2", "both"])
@pytest.mark.parametrize("dt", DTYPES)
def test_k2_matches_twin_at_every_plan(cuda, dt, gates, shape):
    if shape == "edge":
        hvi = _edge_tensor((1, 3, 5, 17), cuda, dt, -1.0, 1.0, seed=33)
    else:
        hvi = _rand(shape, cuda, dt, -1.0, 1.0, seed=33)
    k = torch.full((1,), 0.2, device=cuda)
    n = hc.HVI_TO_RGB.launches
    got = hc.hvi_to_rgb(hvi, k, **gates)
    assert hc.HVI_TO_RGB.launches == n + 1
    b, _, h, w = hvi.shape
    assert got.shape == (b, h, w, 3) and got.is_contiguous()
    torch.testing.assert_close(got, hc.hvi_to_rgb_plain(hvi, k, **gates), atol=_tol(dt, 1e-5),
                               rtol=0)


@pytest.mark.parametrize("dt", DTYPES)
def test_k2_keeps_the_hi6_pixels_black_and_equal(cuda, dt):
    """HVI pixels whose inverse hue is a tiny negative angle: the floored
    mod wraps it to 1 - tiny, which rounds to 1.0 -> hi == 6 -> black (as in
    ``chip_smoke.py:hi6_hvi``), beside ordinary pixels."""
    n = 64
    i = torch.full((n,), 0.5)
    h = torch.linspace(0.2, 0.6, n)
    cs = (torch.sin(torch.tensor(0.25 * torch.pi)) + 1e-8) ** 0.2
    v = -torch.linspace(1.2e-8, 2.0e-8, n) * cs
    hvi = _rand((2, 3, 8, 24), "cpu", torch.float32, -1.0, 1.0, seed=34)
    hvi[1, :, :4, :16] = torch.stack([h, v, i]).reshape(3, 4, 16)
    hvi = hvi.to(cuda, dt)
    k = torch.full((1,), 0.2, device=cuda)
    got, ref = hc.hvi_to_rgb(hvi, k), hc.hvi_to_rgb_plain(hvi, k)
    probe, probe_ref = got[1, :4, :16], ref[1, :4, :16]
    if dt == torch.float32:
        assert (probe_ref == 0).all(-1).sum() >= n // 2, "the probe must hit the hi == 6 edge"
    assert torch.equal((probe == 0).all(-1), (probe_ref == 0).all(-1))
    assert torch.equal(probe, probe_ref)
    torch.testing.assert_close(got, ref, atol=_tol(dt, 1e-5), rtol=0)


# K3 is bitwise equal to its twin (torch.equal): the small odd shapes, each
# site shape of the 600 x 400 forward at batch 1 (16-, 8- and 4-byte bf16
# source pitches; output widths 300, 150 and the odd 75), odd source widths,
# h = 2 and w = 2, fewer planes than SMs, a tensor that starts 2-4 bytes
# past a 16-byte boundary and ends at its allocation's end ("edge"), and an
# even-width one two elements past it ("offset": 2-element loads)
K3_SHAPES = [(2, 5, 50, 150), (1, 3, 7, 9), (3, 2, 2, 2),
             (1, 36, 400, 600), (1, 72, 200, 300), (1, 144, 100, 150),
             (2, 3, 14, 150), (1, 4, 9, 151), (2, 3, 2, 30), (1, 2, 31, 4), (1, 8, 64, 96),
             "edge", "offset"]


@pytest.mark.parametrize("shape", K3_SHAPES, ids=str)
@pytest.mark.parametrize("dt", DTYPES)
def test_k3_matches_twin(cuda, dt, shape):
    if shape == "edge":
        x = _edge_tensor((1, 1, 7, 73), cuda, dt, -1.0, 1.0, seed=2)
    elif shape == "offset":
        buf = _rand((2 + 2 * 8 * 64,), cuda, dt, -1.0, 1.0, seed=2)
        x = buf[2:].view(1, 2, 8, 64)
        assert x.data_ptr() % 16 in (4, 8)
    else:
        x = _rand(shape, cuda, dt, -1.0, 1.0, seed=2)
    a = torch.full((1,), 0.25, device=cuda)
    n = rc.HALF_PRELU.launches
    got = rc.half_prelu(x, a)
    assert rc.HALF_PRELU.launches == n + 1
    assert torch.equal(got, rc.half_prelu_plain(x, a))


# K4 and K7 are bitwise equal to their twins (torch.equal). Beyond the
# small odd shapes: each site shape of the 600 x 400 forward at batch 1,
# widths whose bf16 row pitch is not a multiple of 16 bytes (75, 150, 300,
# odd), heights and widths off the band and tile sizes, fewer planes than
# SMs, and a tensor that starts 2-4 bytes past a 16-byte boundary and ends
# at the end of its allocation ("edge").
def _edge_tensor(shape, dev, dt, lo, hi, seed, values=None):
    """A contiguous view one element into a fresh buffer whose bytes are a
    multiple of 512: its end is the end of the caching allocator's block.
    Filled with ``values`` where given, else uniform in [lo, hi)."""
    n = 1
    for s in shape:
        n *= s
    assert ((n + 1) * torch.tensor([], dtype=dt).element_size()) % 512 == 0
    buf = torch.empty(n + 1, device=dev, dtype=dt)
    buf[1:] = _rand((n,), dev, dt, lo, hi, seed) if values is None else values.reshape(-1)
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

    hvi = _rand((2, 3, 6, 10), cuda, torch.float32, -1.0, 1.0, seed=6).requires_grad_()
    gates = {"gated": True, "gated2": True, "alpha": 0.9, "alpha_s": 1.2}
    n = hc.HVI_TO_RGB.launches
    (g1,) = torch.autograd.grad(hc.hvi_to_rgb(hvi, k.detach(), **gates).square().sum(), (hvi,))
    assert hc.HVI_TO_RGB.launches == n + 1
    (g2,) = torch.autograd.grad(hc.hvi_to_rgb_plain(hvi, k.detach(), **gates).square().sum(), (hvi,))
    torch.testing.assert_close(g1, g2, atol=1e-5, rtol=1e-5)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    k = torch.full((1,), 0.2, device=cuda)
    with pytest.raises(TypeError):
        hc.rgb_to_hvi(torch.rand((1, 8, 8, 3), device=cuda, dtype=torch.float16), k, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        rc.double_bilinear(torch.rand((1, 4, 6, 8), device=cuda).transpose(2, 3))
    with pytest.raises(ValueError, match="density_k"):
        hc.rgb_to_hvi(torch.rand((1, 8, 8, 3), device=cuda), torch.full((1,), 0.2), torch.float32)


def _k5_twin(q, k, v, temp, heads, **kw):
    """K5's twin on the same inputs; in fp32 run on the CPU, as in
    ``chip_smoke.py:k5_twin_cpu``: the card's twin sums N in one fp32 GEMM,
    whose error on q and k of shared structure approaches K5's tolerance."""
    if q.dtype != torch.float32:
        return ac.channel_attention_plain(q, k, v, temp, heads, **kw)
    wp = kw.pop("w_proj", None)
    ref = ac.channel_attention_plain(*(t.cpu() for t in (q, k, v, temp)), heads,
                                     w_proj=None if wp is None else wp.cpu(), **kw)
    return ref.to(q.device)


def _close_rel(got, ref, dt, fp32):
    """fp32: absolute ``fp32``; bf16: two ulps relative (see the module doc)."""
    if dt == torch.float32:
        torch.testing.assert_close(got, ref, atol=fp32, rtol=0)
        return
    err = (got.float() - ref.float()).abs()
    bound = 2.0**-6 * ref.float().abs().clamp_min(1.0)
    assert (err <= bound).all(), f"max err {err.max().item():.3e}, worst ratio {(err / bound).max():.2f}"


def _qk(shape, heads, dev, dt, normalised, seed):
    """q, k and the temperature of a K5 check whose result depends on which
    q row meets which k row (as chip_smoke.py:k5_inputs): q = U z + e over
    space with a rank-4 part common to all rows, k = q + e', temperatures
    3-8 (2-4 unnormalised, rows of norm 1.5), so the softmax rows are peaked
    and a k row met in the wrong place moves the output by a share of |v|."""
    g = torch.Generator().manual_seed(seed)
    b, c = shape[:2]
    n = shape[2] * shape[3]
    z = torch.randn((b, 4, n), generator=g)
    q = torch.randn((c, 4), generator=g) @ z + 0.5 * torch.randn((b, c, n), generator=g)
    k = q + 0.5 * torch.randn((b, c, n), generator=g)
    rms = q.square().mean().sqrt()
    scale = 1.0 / rms if normalised else 1.5 / (rms * n**0.5)
    lo, hi = (3.0, 8.0) if normalised else (2.0, 4.0)
    temp = torch.rand((heads, 1, 1), generator=g) * (hi - lo) + lo
    return ((q * scale).reshape(shape).to(dev, dt), (k * scale).reshape(shape).to(dev, dt),
            temp.to(dev))


# K5 beyond the small shapes: each LCA level's C and heads at batch 1 with N
# = 3750 (a bf16 row 7500 bytes: rows start 4-byte aligned), odd N (7 x 9),
# C = 36 with cp = 18 and C = 192 with one head (the wrapper's maximum)
@pytest.mark.parametrize("case", [
    (2, 12, 7, 9, 3, True, True), (2, 12, 7, 9, 1, False, True), (1, 16, 5, 40, 4, True, False),
    (3, 144, 3, 50, 8, True, True), (1, 192, 4, 33, 1, True, True), (2, 36, 1, 1, 2, False, False),
    (1, 36, 50, 75, 2, True, True), (1, 72, 50, 75, 4, True, True), (1, 144, 50, 75, 8, True, True),
    (1, 36, 7, 9, 2, True, True), (2, 36, 7, 9, 2, False, False), (1, 192, 50, 75, 1, True, True),
    (1, 192, 7, 9, 1, True, False), (1, 144, 7, 9, 8, False, True),
    (1, 36, 200, 300, 2, True, True), (2, 72, 100, 150, 4, True, True), (1, 192, 8, 16, 1, True, True),
    (1, 144, 8, 16, 8, False, False),
], ids=["h3", "h1_nonorm", "h4_nofold", "c144", "c192_groups", "n1", "n3750_c36", "n3750_c72",
        "n3750_c144", "odd_c36", "odd_c36_nonorm_nofold", "n3750_c192", "odd_c192_nofold",
        "odd_c144_nonorm", "aligned_l1_b1", "aligned_l2_b2", "aligned_c192", "aligned_c144_nonorm_nofold"])
@pytest.mark.parametrize("dt", DTYPES)
def test_k5_matches_twin(cuda, dt, case):
    b, c, h, w, heads, normalize_qk, fold = case
    q, k, temp = _qk((b, c, h, w), heads, cuda, dt, normalize_qk, seed=6)
    v = _rand((b, c, h, w), cuda, dt, -1.0, 1.0, seed=8)
    wp = _rand((c, c, 1, 1), cuda, dt, -0.3, 0.3, seed=10) if fold else None
    n = ac.ATTENTION.launches
    got = ac.channel_attention(q, k, v, temp, heads, normalize_qk=normalize_qk, w_proj=wp)
    assert ac.ATTENTION.launches == n + 1
    ref = _k5_twin(q, k, v, temp, heads, normalize_qk=normalize_qk, w_proj=wp)
    _close_rel(got, ref, dt, 2e-5)


@pytest.mark.parametrize("dt", DTYPES)
def test_k5_takes_a_tensor_off_16_byte_alignment(cuda, dt):
    """q, k, v 2 bytes past a 16-byte boundary (bf16; 4 bytes in fp32) and
    ending at their allocations' ends, N odd: the ragged first and last
    chunks are copied element by element."""
    shape = (1, 45, 7, 13)  # 4095 elements
    q0, k0, temp = _qk(shape, 3, cuda, dt, True, seed=40)
    q, k = (_edge_tensor(shape, cuda, dt, 0, 0, 0, values=t) for t in (q0, k0))
    v = _edge_tensor(shape, cuda, dt, -1.0, 1.0, seed=42)
    wp = _rand((45, 45, 1, 1), cuda, dt, -0.3, 0.3, seed=44)
    got = ac.channel_attention(q, k, v, temp, 3, w_proj=wp)
    _close_rel(got, _k5_twin(q, k, v, temp, 3, w_proj=wp), dt, 2e-5)


# each LCA level's C and heads (batch 2, N = 3750 and odd), in every arm
@pytest.mark.parametrize("arm", ["forward", "unfolded", "unnormalised"])
@pytest.mark.parametrize("level", [(36, 2, 50, 75), (72, 4, 50, 75), (144, 8, 50, 75), (144, 8, 7, 9),
                                   (36, 2, 100, 150), (72, 4, 50, 80)],
                         ids=["l1", "l2", "l3", "l3_odd", "l1_aligned", "l2_aligned"])
@pytest.mark.parametrize("dt", DTYPES)
def test_k5_is_bitwise_repeatable_at_every_level_and_arm(cuda, dt, level, arm):
    c, heads, h, w = level
    q, k, temp = _qk((2, c, h, w), heads, cuda, dt, arm != "unnormalised", seed=45)
    v = _rand((2, c, h, w), cuda, dt, -1.0, 1.0, seed=47)
    wp = None if arm == "unfolded" else _rand((c, c, 1, 1), cuda, dt, -c**-0.5, c**-0.5, seed=49)
    run = lambda: ac.channel_attention(q, k, v, temp, heads, normalize_qk=arm != "unnormalised",
                                       w_proj=wp)
    a = run()
    assert torch.equal(a, run())
    ref = _k5_twin(q, k, v, temp, heads, normalize_qk=arm != "unnormalised", w_proj=wp)
    _close_rel(a, ref, dt, 2e-5)


def test_k5_is_bitwise_repeatable(cuda):
    q, k, temp = _qk((2, 72, 30, 41), 4, cuda, torch.bfloat16, True, seed=11)
    v = _rand((2, 72, 30, 41), cuda, torch.bfloat16, -1.0, 1.0, seed=13)
    wp = _rand((72, 72, 1, 1), cuda, torch.bfloat16, -0.3, 0.3, seed=15)
    a = ac.channel_attention(q, k, v, temp, 4, w_proj=wp)
    assert torch.equal(a, ac.channel_attention(q, k, v, temp, 4, w_proj=wp))


def _over_tolerance(got, ref, dt, fp32):
    if dt == torch.float32:
        return (got - ref).abs().max().item() > fp32
    err = (got.float() - ref.float()).abs()
    return bool((err > 2.0**-6 * ref.float().abs().clamp_min(1.0)).any())


# The checks above must tell a right K5 from a wrong one: the kernel run on
# inputs under which it computes what a faulty kernel would on the true ones
# (k rows permuted within a head, q rows met by another head's k rows, one
# 8-row k tile of an image dropped, a 32-column step of the contraction
# dropped where N is small) is rejected against the twin on the true inputs.
@pytest.mark.parametrize("arm", ["forward", "unnormalised"])
@pytest.mark.parametrize("level", [(36, 2, 50, 75), (72, 4, 100, 150), (144, 8, 50, 75), (36, 2, 7, 9)],
                         ids=["l1", "l2_aligned", "l3", "odd"])
@pytest.mark.parametrize("dt", DTYPES)
def test_k5_checks_reject_planted_faults(cuda, dt, level, arm):
    c, heads, h, w = level
    q, k, temp = _qk((2, c, h, w), heads, cuda, dt, arm == "forward", seed=50)
    v = _rand((2, c, h, w), cuda, dt, -1.0, 1.0, seed=51)
    wp = _rand((c, c, 1, 1), cuda, dt, -c**-0.5, c**-0.5, seed=52)
    kw = dict(normalize_qk=arm == "forward", w_proj=wp)
    ref = _k5_twin(q, k, v, temp, heads, **kw)
    _close_rel(ac.channel_attention(q, k, v, temp, heads, **kw), ref, dt, 2e-5)
    by_head = k.reshape(2, heads, c // heads, h, w)
    faults = [by_head.flip(2).reshape(k.shape), by_head.roll(1, 1).reshape(k.shape), k.clone()]
    faults[2][0, 8:16] = 0
    if h * w < 128:
        faults.append(k.clone().reshape(2, c, -1))
        faults[3][0, :, :32] = 0
    for bad in faults:
        got = ac.channel_attention(q, bad.reshape(k.shape).contiguous(), v, temp, heads, **kw)
        assert _over_tolerance(got, ref, dt, 2e-5)


# the sites' C at batch 1 with N = 60000, 15000, 3750 (16-, 16- and 4-byte
# bf16 plane pitches), odd N, C = 256 (the wrapper's maximum), and a tensor
# 2 bytes past a 16-byte boundary ("edge": 2-byte loads)
@pytest.mark.parametrize("shape", [
    (2, 36, 7, 9), (1, 144, 3, 130), (3, 5, 1, 1), (1, 256, 2, 3), (1, 36, 200, 300),
    (1, 72, 100, 150), (1, 144, 50, 75), (8, 144, 50, 75), (1, 256, 50, 75), (1, 192, 7, 9), "edge",
], ids=str)
@pytest.mark.parametrize("dt", DTYPES)
def test_k6_matches_twin(cuda, dt, shape):
    if shape == "edge":
        shape = (1, 45, 7, 13)
        x = _edge_tensor(shape, cuda, dt, -2.0, 3.0, seed=16)
    else:
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


def test_tnsm_full_width_forward_matches_cpu(cuda):
    """The full-width TNSM forward (1 x 96 x 144) on the card against the same
    weights' forward on the CPU, fp32, at chip_smoke.py's TNSM bars (set from
    the reference's own fp32 sensitivity, tests/tnsm_sensitivity.py): the
    output HVI map (free of the RGB hue wrap) max 1e-4, the RGB mean 1e-5,
    the training forward's fused noise map max 1e-5; and the launches of a
    serving forward (K5 23, K6 80, K7 24) and a training one (K5 24, K6 84)."""
    import numpy as np

    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, cidnet_forward, cidnet_hvi

    cfg = CIDNetConfig(variant="tnsm")
    cpu = CIDNet(cfg, generator=torch.Generator().manual_seed(0)).eval()
    gpu = CIDNet(cfg, generator=torch.Generator().manual_seed(0)).to(cuda).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 96, 144, 3)).astype(np.float32))
    kernels = (ac.ATTENTION, nc.LAYER_NORM, ic.IEL_BRANCH)
    with torch.no_grad():
        ref_rgb, ref_noise = cidnet_forward(cpu, x, training=True)
        ref_hvi = cidnet_hvi(cpu, x)
        start = [k.launches for k in kernels]
        rgb, none = cidnet_forward(gpu, x.to(cuda))
        served = [k.launches - n for k, n in zip(kernels, start)]
        start = [k.launches for k in kernels]
        _, noise = cidnet_forward(gpu, x.to(cuda), training=True)
        trained = [k.launches - n for k, n in zip(kernels, start)]
        hvi = cidnet_hvi(gpu, x.to(cuda))
    assert none is None and served == [23, 80, 24] and trained == [24, 84, 24]
    assert (hvi.cpu() - ref_hvi).abs().max().item() <= 1e-4
    assert (rgb.cpu() - ref_rgb).abs().mean().item() <= 1e-5
    assert noise.shape == (1, 96, 144, 3)
    assert (noise.cpu() - ref_noise).abs().max().item() <= 1e-5


# ---------------------------------------------------------------------------
# the fused block route: P2/P3 (LayerNorm + IEL + residual), P4 (dense 3x3),
# P5 (conv 3x3 + x0.5 + PReLU). Each computes in fp32 inside, as its plain
# version does, and rounds once: fp32 within 1e-5 relative (sums over C,
# the hidden width or the taps in another order), bf16 within one bf16 ulp
# of the plain version's rounding (or the fp32 bar, where that is larger).
# ---------------------------------------------------------------------------

from hvi_cidnet_torch.ops import conv3x3_cuda as cc  # noqa: E402
from hvi_cidnet_torch.ops import ln_iel_cuda as lc  # noqa: E402


def _fused_close(got, ref, dt):
    """max(|got - ref| - allowed) <= 0, allowed = max(fp32 bar, one bf16
    ulp at max(|got|, |ref|) for bf16)."""
    got, ref = got.float(), ref.float()
    allowed = 1e-5 * ref.abs().clamp_min(1.0)
    if dt == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(got.abs(), ref.abs()))
        allowed = torch.maximum(allowed, torch.ldexp(torch.ones_like(got), e - 8))
    excess = ((got - ref).abs() - allowed).max().item()
    assert excess <= 0, f"max excess over the bar {excess:.3e}"


def _ln_iel_args(shape, dev, dt, seed):
    b, c, h, w = shape
    hid = int(c * 2.66)
    r = lambda s, lo, hi, t=dt, k=0: _rand(s, dev, t, lo, hi, seed=seed + k)
    x = r((b, c, h, w), -2.0, 2.5)
    return (x, r((c,), 0.5, 1.5, torch.float32, 1), r((c,), -0.3, 0.3, torch.float32, 2),
            r((2 * hid, c, 1, 1), -c**-0.5, c**-0.5, dt, 3), r((2 * hid, 1, 3, 3), -0.4, 0.4, dt, 4),
            r((hid, 1, 3, 3), -0.4, 0.4, dt, 5), r((hid, 1, 3, 3), -0.4, 0.4, dt, 6),
            r((c, hid, 1, 1), -hid**-0.5, hid**-0.5, dt, 7))


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no_residual"])
@pytest.mark.parametrize("shape", [(2, 36, 19, 37), (1, 72, 9, 17), (1, 144, 7, 21),
                                   (3, 8, 1, 1), (1, 12, 20, 36), (1, 144, 50, 75)], ids=str)
@pytest.mark.parametrize("dt", DTYPES)
def test_p23_matches_plain(cuda, dt, shape, residual):
    args = _ln_iel_args(shape, cuda, dt, sum(shape))
    n = lc.LN_IEL.launches
    got = lc.ln_iel(*args, residual)
    assert lc.LN_IEL.launches == n + 1
    assert got.shape == shape and got.dtype == dt
    _fused_close(got, lc.ln_iel_plain(*args, residual), dt)


P4_SHAPES = [((2, 3, 19, 37), 36), ((1, 36, 17, 33), 2), ((1, 36, 9, 9), 1),
             ((2, 144, 7, 9), 72), ((1, 5, 1, 1), 13), ((1, 36, 40, 60), 36)]


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("case", P4_SHAPES, ids=str)
@pytest.mark.parametrize("dt", DTYPES)
def test_p4_matches_plain(cuda, dt, case, pad_mode):
    shape, cout = case
    x = _rand(shape, cuda, dt, -1.0, 1.0, seed=cout)
    w = _rand((cout, shape[1], 3, 3), cuda, dt, -0.2, 0.2, seed=cout + 1)
    n = cc.CONV3X3.launches
    got = cc.conv3x3(x, w, pad_mode)
    assert cc.CONV3X3.launches == n + 1
    assert got.shape == (shape[0], cout, *shape[2:]) and got.dtype == dt
    _fused_close(got, cc.conv3x3_plain(x, w, pad_mode), dt)


P5_SHAPES = [((2, 36, 20, 38), 36), ((1, 72, 10, 16), 144), ((1, 3, 7, 9), 5), ((1, 8, 2, 2), 16),
             ((1, 36, 80, 120), 72)]


@pytest.mark.parametrize("case", P5_SHAPES, ids=str)
@pytest.mark.parametrize("dt", DTYPES)
def test_p5_matches_plain(cuda, dt, case):
    shape, cout = case
    x = _rand(shape, cuda, dt, -1.0, 1.0, seed=cout)
    w = _rand((cout, shape[1], 3, 3), cuda, dt, -0.2, 0.2, seed=cout + 1)
    alpha = torch.full((1,), 0.25, device=cuda)
    n = cc.CONV3X3_HALF_PRELU.launches
    got = cc.conv3x3_half_prelu(x, w, alpha)
    assert cc.CONV3X3_HALF_PRELU.launches == n + 1
    assert got.shape == (shape[0], cout, shape[2] // 2, shape[3] // 2) and got.dtype == dt
    _fused_close(got, cc.conv3x3_half_prelu_plain(x, w, alpha), dt)


def test_fused_kernels_backward_runs_the_plain_autograd(cuda):
    x, *weights = _ln_iel_args((1, 12, 6, 10), cuda, torch.float32, 3)
    x = x.requires_grad_()
    lc.ln_iel(x, *weights, True).square().sum().backward()
    xc = x.detach().clone().requires_grad_()
    lc.ln_iel_plain(xc, *weights, True).square().sum().backward()
    torch.testing.assert_close(x.grad, xc.grad, rtol=1e-4, atol=1e-5)
    w = _rand((8, 12, 3, 3), cuda, torch.float32, -0.2, 0.2).requires_grad_()
    alpha = torch.full((1,), 0.25, device=cuda, requires_grad=True)
    for fn, plain, extra in ((cc.conv3x3, cc.conv3x3_plain, ("edge",)),
                             (cc.conv3x3_half_prelu, cc.conv3x3_half_prelu_plain, (alpha,))):
        g1 = torch.autograd.grad(fn(x, w, *extra).sum(), (x, w))
        g2 = torch.autograd.grad(plain(x, w, *extra).sum(), (x, w))
        for a, b in zip(g1, g2):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_fused_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x, *weights = _ln_iel_args((1, 12, 6, 10), cuda, torch.float32, 3)
    with pytest.raises(ValueError, match="w_po"):
        lc.ln_iel_kernel(x, *weights[:-1], weights[-1][:, :-1], False)
    with pytest.raises(ValueError, match="ln_w"):
        lc.ln_iel_kernel(x, weights[0].double(), *weights[1:], False)
    with pytest.raises(ValueError, match="contiguous"):
        lc.ln_iel_kernel(x.transpose(2, 3), *weights, False)
    w = _rand((8, 12, 3, 3), cuda, torch.float32)
    with pytest.raises(ValueError, match="pad_mode"):
        cc.conv3x3(x, w, "reflect")
    with pytest.raises(ValueError, match="weight"):
        cc.conv3x3_kernel(x, w[:, :6], "zero")
    with pytest.raises(ValueError, match="prelu slope"):
        cc.conv3x3_half_prelu_kernel(x, w, torch.full((2,), 0.25, device=cuda))
    with pytest.raises(ValueError, match="H, W >= 2"):
        cc.conv3x3_half_prelu_kernel(x[:, :, :1].contiguous(), w,
                                     torch.full((1,), 0.25, device=cuda))


@pytest.mark.parametrize("variant", ["base", "mssa", "tnsm"])
def test_fused_route_forward_matches_cpu(cuda, variant):
    """The full-width forward with every route on, 1 x 64 x 96, card fp32
    against the same weights' CPU fp32 forward (the forward's bars, max
    1e-4, mean 1e-6; TNSM's mean 1e-5), and its launches: every LCA a
    P2/P3, the 6 NormDownsamples P5, the stems, heads and NormUpsamples P4,
    no K3 or K7."""
    import numpy as np

    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, cidnet_forward
    from hvi_cidnet_torch.ops.routes import FUSED

    cfg = CIDNetConfig(variant=variant)
    cpu = CIDNet(cfg, generator=torch.Generator().manual_seed(0)).eval()
    gpu = CIDNet(cfg, generator=torch.Generator().manual_seed(0)).to(cuda).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 64, 96, 3)).astype(np.float32))
    kernels = (lc.LN_IEL, cc.CONV3X3, cc.CONV3X3_HALF_PRELU, rc.HALF_PRELU, ic.IEL_BRANCH,
               nc.LAYER_NORM)
    pick = (lambda o: o[0]) if variant == "tnsm" else (lambda o: o)
    with torch.no_grad():
        ref = pick(cidnet_forward(cpu, x, routes=FUSED))
        start = [k.launches for k in kernels]
        got = pick(cidnet_forward(gpu, x.to(cuda), routes=FUSED)).cpu()
        launched = [k.launches - n for k, n in zip(kernels, start)]
    lcas = 11 if variant == "base" else 12
    assert launched == [lcas, 10, 6, 0, 0, 2 * lcas + (44 if variant == "tnsm" else 0)]
    assert (got - ref).abs().max().item() <= 1e-4
    assert (got - ref).abs().mean().item() <= (1e-5 if variant == "tnsm" else 1e-6)


# ---------------------------------------------------------------------------
# The probe route's kernels, P1, P6 and P10/P15, against their plain
# versions at c = 18 (every site), C_out 1 and 2, K 9 and 27, odd N and N
# past a tile. Bars as in chip_smoke.py: P1 in fp32 within 1e-5 * max(1,
# |ref|) of its plain version run on the CPU (the card's fp32 bmm drifts on
# q and k of shared structure, as K5's twin does); in bf16 within two bf16
# ulps at the apply's scale, max(|got|, |ref|, sum_j A_ij |v_j|): A is
# rounded once to bf16 before the apply, and a last-bit difference in the
# fp32 softmax that flips one entry's rounding moves the output by at most
# two ulps at that scale. P6: 1e-5 * max(1, |ref|), bf16 one ulp
# (``_fused_close``). P10/P15: every entry within 1e-5 * |q_r| |k_c|
# (Cauchy-Schwarz; a bar relative to |ref| is wrong near cancellation) of
# the plain version run on the CPU, fp32 and bf16 inputs alike.
# ---------------------------------------------------------------------------

from hvi_cidnet_torch.ops import batched_qk_cuda as bq  # noqa: E402
from hvi_cidnet_torch.ops import head_attention_cuda as ha  # noqa: E402
from hvi_cidnet_torch.ops import im2col_cuda as icol  # noqa: E402

# (B, C, H, W, heads): c = C / heads
HEAD_SHAPES = [(2, 36, 7, 9, 2), (1, 144, 50, 75, 8), (2, 72, 100, 150, 4), (1, 36, 200, 300, 2),
               (3, 5, 1, 1, 1), (1, 32, 13, 11, 1), (2, 8, 4, 4, 2), (1, 4, 1, 129, 4),
               (4, 144, 3, 43, 8)]


def _heads(shape, heads, dev, dt, normalised, seed):
    """q, k of shared structure (``_qk``) and v, as (B * heads, c, H W),
    with the (heads,) temperatures."""
    b, c, h, w = shape
    q, k, temp = _qk(shape, heads, dev, dt, normalised, seed)
    v = _rand(shape, dev, dt, -1.0, 1.0, seed=seed + 1)
    view = lambda t: t.reshape(b * heads, c // heads, h * w).contiguous()
    return view(q), view(k), view(v), temp.reshape(heads)


def _p1_close(got, ref, q, k, v, temps):
    got32, ref32 = got.float(), ref.float()
    if got.dtype == torch.float32:
        allowed = 1e-5 * ref32.abs().clamp_min(1.0)
    else:
        a = ha.attention_matrix(q, k, temps).to(v.dtype).float()
        scale = torch.bmm(a, v.float().abs())
        _, e = torch.frexp(torch.maximum(torch.maximum(got32.abs(), ref32.abs()), scale))
        allowed = torch.ldexp(torch.full_like(got32, 2.0), e - 8)
    excess = ((got32 - ref32).abs() - allowed).max().item()
    assert excess <= 0, f"max err {(got32 - ref32).abs().max().item():.3e}, over by {excess:.3e}"


def _p1_ref(q, k, v, temps):
    if q.dtype != torch.float32:
        return ha.head_attention_plain(q, k, v, temps)
    return ha.head_attention_plain(*(t.cpu() for t in (q, k, v, temps))).to(q.device)


@pytest.mark.parametrize("case", HEAD_SHAPES, ids=str)
@pytest.mark.parametrize("dt", DTYPES)
def test_p1_matches_plain(cuda, dt, case):
    *shape, heads = case
    q, k, v, temps = _heads(tuple(shape), heads, cuda, dt, True, seed=sum(shape))
    n = ha.HEAD_ATTENTION.launches
    got = ha.head_attention(q, k, v, temps)
    assert ha.HEAD_ATTENTION.launches == n + 1
    assert got.shape == q.shape and got.dtype == dt
    _p1_close(got, _p1_ref(q, k, v, temps), q, k, v, temps)
    assert torch.equal(got, ha.head_attention(q, k, v, temps))  # the same bits again


@pytest.mark.parametrize("elements", [1, 2])
@pytest.mark.parametrize("dt", DTYPES)
def test_p1_p10_take_tensors_off_16_byte_alignment(cuda, dt, elements):
    """q, k, v ``elements`` past a 16-byte boundary with N a multiple of 8:
    narrower loads (2 elements or 1), the same results."""
    q0, k0, v0, temps = _heads((2, 36, 8, 16), 2, cuda, dt, True, seed=80)
    shifted = []
    for t in (q0, k0, v0):
        base = torch.empty(t.numel() + elements, dtype=dt, device=cuda)
        shifted.append(base[elements:].view(t.shape).copy_(t))
    q, k, v = shifted
    assert q.data_ptr() % 16 != 0
    _p1_close(ha.head_attention(q, k, v, temps), _p1_ref(q0, k0, v0, temps), q, k, v, temps)
    got = bq.batched_qk(q, k)
    _qk_close(got, bq.batched_qk_plain(q0.cpu(), k0.cpu()).to(cuda), q, k)


def _qk_close(got, ref, q, k):
    nq, nk = (t.float().square().sum(-1).sqrt() for t in (q, k))
    allowed = 1e-5 * nq[:, :, None] * nk[:, None, :]
    excess = ((got - ref).abs() - allowed).max().item()
    assert excess <= 0, f"max err {(got - ref).abs().max().item():.3e}, over by {excess:.3e}"


@pytest.mark.parametrize("case", HEAD_SHAPES, ids=str)
@pytest.mark.parametrize("dt", DTYPES)
def test_p10_p15_matches_plain(cuda, dt, case):
    *shape, heads = case
    q, k, _, _ = _heads(tuple(shape), heads, cuda, dt, False, seed=sum(shape) + 3)
    n = bq.BATCHED_QK.launches
    got = bq.batched_qk(q, k)
    assert bq.BATCHED_QK.launches == n + 1
    assert got.shape == (q.shape[0], q.shape[1], q.shape[1]) and got.dtype == torch.float32
    _qk_close(got, bq.batched_qk_plain(q.cpu(), k.cpu()).to(cuda), q, k)
    assert torch.equal(got, bq.batched_qk(q, k))


# (B, C_in, H, W, C_out, pad): K = 9 C_in
P6_CASES = [(2, 1, 7, 9, 36, "edge"), (1, 3, 19, 37, 36, "edge"), (1, 36, 17, 33, 2, "edge"),
            (1, 36, 9, 9, 1, "zero"), (2, 144, 7, 9, 72, "zero"), (1, 72, 50, 75, 144, "zero"),
            (1, 36, 40, 64, 36, "zero"), (3, 5, 1, 1, 13, "zero"), (1, 8, 16, 16, 17, "edge")]


@pytest.mark.parametrize("case", P6_CASES, ids=str)
@pytest.mark.parametrize("dt", DTYPES)
def test_p6_matches_plain(cuda, dt, case):
    b, cin, h, w, cout, pad = case
    x = _rand((b, cin, h, w), cuda, dt, -1.0, 1.0, seed=cout)
    wt = _rand((cout, cin, 3, 3), cuda, dt, -cin**-0.5, cin**-0.5, seed=cout + 1)
    a = icol.stage_3x3(x, pad)
    wmat = wt.reshape(cout, cin * 9)
    n = icol.IM2COL_DOTS.launches
    got = icol.im2col_dots(a, wmat)
    assert icol.IM2COL_DOTS.launches == n + 1
    assert got.shape == (b, cout, h * w) and got.dtype == dt
    _fused_close(got, icol.im2col_dots_plain(a, wmat), dt)
    conv = icol.conv3x3_im2col(x, wt, pad)
    assert torch.equal(conv, got.view(b, cout, h, w))
    # the whole conv against cuDNN's (TF32 off), fp32 at the P6 bar
    if dt == torch.float32:
        _fused_close(conv, cc.conv3x3_plain(x, wt, pad), dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_p6_takes_an_operand_off_16_byte_alignment(cuda, dt):
    """N a multiple of the vector but the operand 2 (4) bytes past a
    16-byte boundary: element loads, the same result."""
    b, k, n, cout = 2, 27, 264, 36
    base = _rand((b * k * n + 1,), cuda, dt, -1.0, 1.0, seed=60)
    a = base[1:].view(b, k, n)
    assert a.data_ptr() % 16 != 0
    wmat = _rand((cout, k), cuda, dt, -0.2, 0.2, seed=61)
    _fused_close(icol.im2col_dots(a, wmat), icol.im2col_dots_plain(a, wmat), dt)


def test_probe_kernels_backward_runs_the_plain_autograd(cuda):
    q, k, v, temps = _heads((1, 36, 5, 7), 2, cuda, torch.float32, True, seed=70)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    temps = temps.requires_grad_()
    for fn, plain, args in ((ha.head_attention, ha.head_attention_plain, (q, k, v, temps)),
                            (bq.batched_qk, bq.batched_qk_plain, (q, k))):
        g1 = torch.autograd.grad(fn(*args).square().sum(), args)
        g2 = torch.autograd.grad(plain(*args).square().sum(), args)
        for x, y in zip(g1, g2):
            torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)
    a = _rand((2, 27, 40), cuda, torch.float32, -1.0, 1.0, seed=71).requires_grad_()
    wmat = _rand((5, 27), cuda, torch.float32, -0.2, 0.2, seed=72).requires_grad_()
    g1 = torch.autograd.grad(icol.im2col_dots(a, wmat).sum(), (a, wmat))
    g2 = torch.autograd.grad(icol.im2col_dots_plain(a, wmat).sum(), (a, wmat))
    for x, y in zip(g1, g2):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)


def test_probe_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    q, k, v, temps = _heads((2, 36, 5, 7), 2, cuda, torch.float32, True, seed=73)
    with pytest.raises(ValueError, match="temps"):
        ha.head_attention_kernel(q, k, v, temps.double())
    with pytest.raises(ValueError, match="temps"):
        ha.head_attention_kernel(q, k, v, torch.ones(3, device=cuda))
    with pytest.raises(ValueError, match="q and k"):
        ha.head_attention_kernel(q, k[:, :, :-1].contiguous(), v, temps)
    with pytest.raises(ValueError, match="contiguous"):
        bq.batched_qk_kernel(q.transpose(1, 2), k.transpose(1, 2))
    with pytest.raises(ValueError, match="c <= 32"):
        bq.batched_qk_kernel(q.reshape(1, 72, -1), k.reshape(1, 72, -1))
    a = _rand((1, 27, 40), cuda, torch.float32, seed=74)
    with pytest.raises(ValueError, match="wmat"):
        icol.im2col_dots_kernel(a, torch.ones((4, 26), device=cuda))
    with pytest.raises(ValueError, match="C_out <= 144"):
        icol.im2col_dots_kernel(a, torch.ones((145, 27), device=cuda))
    with pytest.raises(TypeError, match="dtype"):
        icol.im2col_dots_kernel(a.double(), torch.ones((4, 27), device=cuda))


@pytest.mark.parametrize("variant", ["base", "mssa", "tnsm"])
def test_probe_route_forward_matches_cpu(cuda, variant):
    """The full-width forward on the probe route, 1 x 64 x 96, card fp32
    against the same weights' CPU fp32 forward on the same route (the
    forward's bars, max 1e-4, mean 1e-6; TNSM's mean 1e-5), and its
    launches: every CAB a P1, every noise-aware attention a P10/P15, the 16
    dense 3x3 convs P6, no K5."""
    import numpy as np

    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, cidnet_forward
    from hvi_cidnet_torch.ops.routes import PROBE

    cfg = CIDNetConfig(variant=variant)
    cpu = CIDNet(cfg, generator=torch.Generator().manual_seed(0)).eval()
    gpu = CIDNet(cfg, generator=torch.Generator().manual_seed(0)).to(cuda).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 64, 96, 3)).astype(np.float32))
    kernels = (ha.HEAD_ATTENTION, icol.IM2COL_DOTS, bq.BATCHED_QK, ac.ATTENTION, rc.HALF_PRELU)
    pick = (lambda o: o[0]) if variant == "tnsm" else (lambda o: o)
    with torch.no_grad():
        ref = pick(cidnet_forward(cpu, x, routes=PROBE))
        start = [k.launches for k in kernels]
        got = pick(cidnet_forward(gpu, x.to(cuda), routes=PROBE)).cpu()
        launched = [k.launches - n for k, n in zip(kernels, start)]
    lcas = 11 if variant == "base" else 12
    assert launched == [lcas, 16, 11 if variant == "tnsm" else 0, 0, 6]
    assert (got - ref).abs().max().item() <= 1e-4
    assert (got - ref).abs().mean().item() <= (1e-5 if variant == "tnsm" else 1e-6)


# ---------------------------------------------------------------------------
# P7, P8/P9/P11, P12/P13, P14: the relayout (csrc/relayout.cu), bitwise
# ---------------------------------------------------------------------------

from hvi_cidnet_torch.ops import relayout as rplain  # noqa: E402
from hvi_cidnet_torch.ops import relayout_cuda as rl  # noqa: E402

# (name, input shape, kwargs): odd extents, blocks > 1, unit axes (a copy,
# a transpose of the middle axis), tiles cut at both edges, several slabs
# to a work item (P7 at steps 1, the last item cut), and the HWCB entry and
# exit at batch 1, 3 and 8 on a 24 x 40 image
RELAYOUT_CASES = [
    ("P7", (21, 3, 5), {"hwt": 7, "steps": 1}), ("P7", (21, 3, 5), {"hwt": 7, "steps": 2}),
    ("P7", (21, 3, 5), {"hwt": 7, "steps": 3}), ("P7", (96, 36, 8), {"hwt": 32, "steps": 3}),
    ("P7", (20, 4, 8), {"hwt": 5, "steps": 0}), ("P7", (100, 36, 8), {"hwt": 20, "steps": 1}),
    ("P7", (999, 5, 3), {"hwt": 333, "steps": 1}),
    ("P8", (150, 72, 8), {}), ("P8", (37, 5, 3), {}), ("P8", (1000, 3, 1), {}),
    ("P9", (130, 2, 70), {}), ("P11", (8, 36, 375), {}), ("P11", (3, 5, 37), {}),
    ("P11", (1, 3, 333), {}), ("P12", (60, 36, 8), {"n_blk": 20}),
    ("P13", (63, 5, 3), {"n_blk": 21}), ("P14", (4100, 1, 2), {"n_blk": 4100}),
    ("P14", (60, 4, 8), {"n_blk": 15}),
    ("P14", (960, 3, 1), {"n_blk": 960}), ("P14", (960, 3, 3), {"n_blk": 960}),
    ("P14", (960, 3, 8), {"n_blk": 960}), ("P11", (1, 1, 2880), {}), ("P11", (3, 1, 2880), {}),
    ("P11", (8, 1, 2880), {}), ("P11", (8, 3, 960), {}),
]
RELAYOUT_FNS = {"P7": ("transpose_steps", "P7"), "P8": ("relayout_t3", "P8/P9/P11"),
                "P9": ("relayout_t2", "P8/P9/P11"), "P11": ("relayout_t2_rev", "P8/P9/P11"),
                "P12": ("t3_blocked", "P12/P13"), "P13": ("t2_blocked", "P12/P13"),
                "P14": ("pack_blocked", "P14")}


@pytest.mark.parametrize("case", RELAYOUT_CASES, ids=str)
@pytest.mark.parametrize("dt", DTYPES + [torch.float16])
def test_relayout_is_bitwise_the_plain_version(cuda, dt, case):
    name, shape, kw = case
    fn, counter = RELAYOUT_FNS[name]
    x = _rand(shape, cuda, dt, -2.0, 2.0, seed=80)
    n = rl.KERNELS[counter].launches
    got = getattr(rl, fn)(x, **kw)
    assert rl.KERNELS[counter].launches == n + 1
    torch.cuda.synchronize()
    assert torch.equal(got, getattr(rplain, fn)(x, **kw))


@pytest.mark.parametrize("elements", [1, 2, 3])
@pytest.mark.parametrize("dt", DTYPES)
def test_relayout_takes_tensors_off_16_byte_alignment(cuda, dt, elements):
    """Input and output views ``elements`` past a 16-byte boundary: the plan
    narrows the vectors to what the starts allow."""
    buf = _rand((elements + 96 * 36 * 8,), cuda, dt, seed=81)
    x = buf[elements:].view(96, 36, 8)
    assert x.data_ptr() % 16 != 0
    for fn in (rl.relayout_t3, rl.relayout_t2_rev):
        assert torch.equal(fn(x), fn(x.cpu()).to(cuda))
    assert rl.relayout_plan(1, 96, 36, 8, x.element_size(), x.data_ptr() % 16).vi * \
        x.element_size() < 16


def test_relayout_backward_runs_the_plain_autograd(cuda):
    x = _rand((24, 4, 8), cuda, torch.float32, seed=82).requires_grad_()
    for fn in (lambda t: rl.transpose_steps(t, 6, 2), rl.relayout_t3, rl.relayout_t2_rev,
               lambda t: rl.t3_blocked(t, 6), lambda t: rl.pack_blocked(t, 6)):
        out = fn(x)
        grad = torch.randn(out.shape, device=cuda)
        (gx,) = torch.autograd.grad(out, x, grad)
        assert torch.equal(fn(gx.contiguous()), grad)  # the plain autograd's grad is a view


def test_relayout_raises_on_what_the_kernel_does_not_take(cuda):
    x = _rand((24, 4, 8), cuda, torch.float32, seed=83)
    with pytest.raises(ValueError, match="contiguous"):
        rl.relayout_t3(x.transpose(0, 2))
    with pytest.raises(TypeError, match="2- or 4-byte"):
        rl.relayout_t3(x.double())
    with pytest.raises(ValueError, match="does not divide"):
        rl.pack_blocked(x, 5)


@pytest.mark.parametrize("variant", ["base", "mssa", "tnsm"])
def test_hwcb_forward_is_the_nhwc_forward_permuted(cuda, variant):
    """The full-width HWCB forward at 24 x 40, batch 3, fp32: bitwise the
    card's NHWC forward permuted (TNSM's training noise map too), one P14
    and one P8/P9/P11 launch more (two with TNSM's noise map)."""
    import numpy as np

    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, cidnet_forward

    gpu = CIDNet(CIDNetConfig(variant=variant), generator=torch.Generator().manual_seed(0))
    gpu = gpu.to(cuda).eval()
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (3, 24, 40, 3)).astype(
        np.float32)).to(cuda)
    training = variant == "tnsm"
    with torch.no_grad():
        ref = cidnet_forward(gpu, x, training=training)
        start = [rl.P14.launches, rl.P8_P9_P11.launches]
        got = cidnet_forward(gpu, x.permute(1, 2, 3, 0).contiguous(), training=training,
                             input_layout="hwcb")
        launched = [rl.P14.launches - start[0], rl.P8_P9_P11.launches - start[1]]
    assert launched == [1, 2 if training else 1]
    got, ref = (got, ref) if training else ((got,), (ref,))
    for a, b in zip(got, ref):
        assert torch.equal(a, b.permute(1, 2, 3, 0))
