"""The probe route of the PyTorch port vs the JAX package (CPU, fp32).

The route's kernels take their plain versions on a CPU tensor; each plain
version is held here to the JAX Pallas kernel it replaces, run in interpret
mode (its module's ``pl`` swapped for one whose ``pallas_call``
interprets), on inputs from numpy with a seed:

* P1, ``ops/head_attention_cuda.py:head_attention``, against ``experiments/
  attn_kernel_probe_r2.py:attn_pallas`` per head, each head's temperature
  passed as its float (P1 bakes one in and has no heads);
* P6, ``ops/im2col_cuda.py:im2col_dots``, against ``experiments/
  flat_pilot_r3.py:pallas_im2col_dots`` with the module's ``K`` and
  ``COUT`` set (its block shapes read them) and N a multiple of its tile
  (its grid drops the rest), on operands staged with zero and edge padding;
  and ``conv3x3_im2col`` against the port's plain convs;
* P10/P15, ``ops/batched_qk_cuda.py:batched_qk``, against ``experiments/
  mosaic_micro_r5h.py:bdot`` and against P10's body
  (``experiments/relayout_probe_r5h.py:_dot_kernel``) run over several N
  blocks into a zeroed aliased output. ``dot_bcn`` as written never zeroes
  its output (one test pins that it is not finite), so it is no reference.

Tolerance 1e-5 for the single ops (fp32 sums in another order), for the
scores of P10/P15 1e-5 * |q_r| |k_c| (Cauchy-Schwarz: a sum of N products
can cancel to far below its terms, so a bar relative to it is wrong). The tiny
base, MSSA and TNSM forwards on the probe route are held to the JAX
``cidnet_forward`` at the whole-forward bar, 2e-5, on weights carried
across by ``jax_params_to_torch``, and to the port's default route at the
same bar (the route sums in other orders: unfold + matmul for the convs,
per-head attention with ``project_out`` after it). Counting the route's
calls pins which sites take it.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.models.cidnet import cidnet_forward as jax_forward
from hvi_cidnet_torch.cli import demo, net_test
from hvi_cidnet_torch.compat.jax_params import jax_params_to_torch, load_weights
from hvi_cidnet_torch.models import layers, tnsm
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, cast_conv_weights, cidnet_forward
from hvi_cidnet_torch.ops import batched_qk_cuda, head_attention_cuda, im2col_cuda, routes
from hvi_cidnet_torch.ops.conv import conv3x3_replpad, conv3x3_same
from hvi_cidnet_torch.ops.routes import FUSED, PROBE, UNFUSED, Routes
from hvi_cidnet_torch.serve import Enhancer
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
TOL = 1e-5
TOL_FORWARD = 2e-5


def _experiment(name: str):
    """An ``experiments/`` module, loaded by path (a fresh module object)."""
    path = os.path.join(REPO, "experiments", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_exp_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _InterpretPallas:
    """``jax.experimental.pallas`` with ``pallas_call`` in interpret mode."""

    pallas_call = staticmethod(functools.partial(pl.pallas_call, interpret=True))

    def __getattr__(self, name):
        return getattr(pl, name)


@pytest.fixture(scope="module")
def exp():
    mods = {n: _experiment(n) for n in ("attn_kernel_probe_r2", "flat_pilot_r3",
                                        "relayout_probe_r5h", "mosaic_micro_r5h")}
    for mod in mods.values():
        mod.pl = _InterpretPallas()
    return mods


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# P1: per-head channel attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b, c, heads, n", [(2, 8, 1, 96), (2, 8, 2, 96), (1, 16, 4, 200),
                                           (3, 18, 1, 37)])
def test_p1_plain_matches_pallas_per_head(exp, b, c, heads, n):
    rng = np.random.default_rng(b * 100 + c + heads)
    q, k, v = _f32(rng, b, c, n, scale=0.5), _f32(rng, b, c, n, scale=0.5), _f32(rng, b, c, n)
    k = k + 0.5 * q  # each q row meets its own k row at a high cosine: peaked rows
    temps = rng.uniform(0.5, 4.0, heads).astype(np.float32)
    cp = c // heads
    ref = np.concatenate([
        np.asarray(exp["attn_kernel_probe_r2"].attn_pallas(
            *(jnp.asarray(t[:, h * cp:(h + 1) * cp]) for t in (q, k, v)), temp=float(temps[h])))
        for h in range(heads)], axis=1)
    view = lambda t: torch.from_numpy(t).reshape(b * heads, cp, n)
    got = head_attention_cuda.head_attention(view(q), view(k), view(v), torch.from_numpy(temps))
    assert got.shape == (b * heads, cp, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.reshape(b, c, n).numpy(), ref, atol=TOL, rtol=0)


def test_p1_is_the_cab_attention_unfolded():
    """Per head, P1's function is the CAB's attention (K5's plain version)
    without the ``project_out`` fold: with the fold applied after it as a
    1x1 conv, the two agree."""
    from hvi_cidnet_torch.ops.attention import channel_attention

    rng = np.random.default_rng(3)
    b, c, heads, h, w = 2, 16, 4, 6, 7
    q, k, v = (torch.from_numpy(_f32(rng, b, c, h, w)) for _ in range(3))
    temp = torch.from_numpy(rng.uniform(0.5, 3.0, (heads, 1, 1)).astype(np.float32))
    wp = torch.from_numpy(_f32(rng, c, c, 1, 1, scale=c**-0.5))
    out = head_attention_cuda.head_attention(*(layers.heads_view(t, heads) for t in (q, k, v)),
                                             temp.reshape(heads))
    got = F.conv2d(out.view(b, c, h, w), wp)
    ref = channel_attention(q, k, v, temp, heads, w_proj=wp)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# P6: im2col products
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
@pytest.mark.parametrize("cin, cout, tile_n", [(3, 5, 128), (8, 16, 64)])
def test_p6_plain_matches_pallas(exp, cin, cout, tile_n, pad_mode):
    mod = exp["flat_pilot_r3"]
    rng = np.random.default_rng(cin + cout + (pad_mode == "edge"))
    x = torch.from_numpy(_f32(rng, 1, cin, 16, 16))  # N = 256: whole tiles
    w = torch.from_numpy(_f32(rng, cout, cin, 3, 3, scale=(9 * cin) ** -0.5))
    a = im2col_cuda.stage_3x3(x, pad_mode)
    wmat = w.reshape(cout, cin * 9)
    mod.K, mod.COUT = cin * 9, cout
    ref = mod.pallas_im2col_dots(jnp.asarray(a[0].numpy()), jnp.asarray(wmat.numpy()), tile_n)
    got = im2col_cuda.im2col_dots(a, wmat)
    assert got.shape == (1, cout, 256)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
def test_conv3x3_im2col_matches_the_plain_conv(pad_mode):
    """Staging, the weight's (c, kh, kw) order and the view back to NCHW
    give the port's zero-padded and replication-padded convs, at H x W not
    a multiple of P6's tile and batch 2."""
    rng = np.random.default_rng(11 if pad_mode == "zero" else 12)
    x = torch.from_numpy(_f32(rng, 2, 6, 13, 21))
    w = torch.from_numpy(_f32(rng, 7, 6, 3, 3, scale=0.2))
    got = im2col_cuda.conv3x3_im2col(x, w, pad_mode)
    ref = conv3x3_same(x, w) if pad_mode == "zero" else conv3x3_replpad(x, w)
    assert got.shape == (2, 7, 13, 21)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="pad_mode"):
        im2col_cuda.conv3x3_im2col(x, w, "reflect")


# ---------------------------------------------------------------------------
# P10/P15: batched q k^T
# ---------------------------------------------------------------------------


def _assert_scores_close(got, ref, q, k):
    """Each entry within 1e-5 * |q_r| |k_c|."""
    allowed = TOL * np.sqrt((q.astype(np.float64) ** 2).sum(-1))[:, :, None] \
        * np.sqrt((k.astype(np.float64) ** 2).sum(-1))[:, None, :]
    assert (np.abs(got - ref) <= allowed).all(), np.abs(got - ref).max()


def _p10_zeroed(mod, q, k, n_blk):
    """P10's body over N blocks into a zeroed output aliased to its input
    (the call P10 was meant to be)."""
    b, c, n = q.shape
    spec = pl.BlockSpec((b, c, n_blk), lambda i: (0, 0, i), memory_space=pltpu.VMEM)
    out_spec = pl.BlockSpec((b, c, c), lambda i: (0, 0, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(
        lambda q_ref, k_ref, z_ref, o_ref: mod._dot_kernel(q_ref, k_ref, o_ref),
        grid=(n // n_blk,),
        in_specs=[spec, spec, out_spec],
        out_specs=out_spec,
        out_shape=jax.ShapeDtypeStruct((b, c, c), jnp.float32),
        input_output_aliases={2: 0},
        interpret=True,
    )(q, k, jnp.zeros((b, c, c), jnp.float32))


@pytest.mark.parametrize("g, c, n", [(4, 8, 96), (2, 18, 300), (3, 5, 7)])
def test_p10_p15_plain_matches_bdot(exp, g, c, n):
    rng = np.random.default_rng(g + c + n)
    q, k = _f32(rng, g, c, n), _f32(rng, g, c, n)
    ref = np.asarray(exp["mosaic_micro_r5h"].bdot(jnp.asarray(q), jnp.asarray(k)))
    got = batched_qk_cuda.batched_qk(torch.from_numpy(q), torch.from_numpy(k))
    assert got.shape == (g, c, c) and got.dtype == torch.float32
    _assert_scores_close(got.numpy(), ref, q, k)


@pytest.mark.parametrize("n_blk", [32, 96])
def test_p10_p15_plain_matches_p10_with_a_zeroed_output(exp, n_blk):
    rng = np.random.default_rng(n_blk)
    q, k = _f32(rng, 4, 8, 192), _f32(rng, 4, 8, 192)
    ref = np.asarray(_p10_zeroed(exp["relayout_probe_r5h"], jnp.asarray(q), jnp.asarray(k), n_blk))
    got = batched_qk_cuda.batched_qk(torch.from_numpy(q), torch.from_numpy(k))
    _assert_scores_close(got.numpy(), ref, q, k)


def test_p10_as_written_is_not_finite(exp):
    """``dot_bcn`` accumulates into an output it never zeroes: in interpret
    mode the result is NaN, with one N block and with several. The port
    must not copy it; its reference is P15 or the zeroed call above."""
    rng = np.random.default_rng(5)
    q, k = (jnp.asarray(_f32(rng, 4, 8, 96)) for _ in range(2))
    for n_blk in (96, 32):
        out = np.asarray(exp["relayout_probe_r5h"].dot_bcn(q, k, n_blk))
        assert not np.isfinite(out).all()


# ---------------------------------------------------------------------------
# the forward on the probe route
# ---------------------------------------------------------------------------


def _jax_layout(model: CIDNet) -> dict:
    return {
        k: np.ascontiguousarray(v.numpy().transpose(2, 3, 1, 0)) if v.dim() == 4 else v.numpy().copy()
        for k, v in model.state_dict().items()
    }


def _rgb(out, variant):
    return out[0] if variant == "tnsm" else out


@pytest.mark.parametrize("variant", ["base", "mssa", "tnsm"])
def test_probe_route_tiny_forward_matches_jax(variant):
    cfg = CIDNetConfig(variant=variant, **TINY)
    np_params = _jax_layout(CIDNet(cfg, generator=torch.Generator().manual_seed(41)))
    port = load_weights(CIDNet(cfg), jax_params_to_torch(np_params)).eval()
    x = np.random.default_rng(16).uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    jcfg = JaxConfig(variant=variant, **TINY)
    ref = jax.jit(lambda p, x: _rgb(jax_forward(p, x, jcfg), variant))(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(x))
    with torch.no_grad():
        got = _rgb(cidnet_forward(port, torch.from_numpy(x), routes=PROBE), variant)
        default = _rgb(cidnet_forward(port, torch.from_numpy(x), routes=UNFUSED), variant)
    assert got.shape == (2, 16, 24, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL_FORWARD, rtol=0)
    np.testing.assert_allclose(got.numpy(), default.numpy(), atol=TOL_FORWARD, rtol=0)


def _count_route_calls(monkeypatch, contiguous=None):
    """Counts the calls of the sites' ops: P1 and K5's dispatcher in the
    CABs, P10/P15 and K5's in TNSM, the im2col conv (and its edge-padded
    calls), P4 and the NormDownsample tail; ``contiguous`` collects whether
    each kernel's tensor inputs were contiguous."""
    calls = {k: 0 for k in ("head_attn", "qk", "im2col", "edge", "k5_cab", "k5_tnsm", "conv3x3",
                            "half_prelu")}

    def counted(module, attr, key, edge=False):
        fn = getattr(module, attr)

        def wrapper(*args, **kw):
            calls[key] += 1
            if edge and args[-1] == "edge":
                calls["edge"] += 1
            if contiguous is not None and key in ("head_attn", "qk"):
                contiguous.extend(t.is_contiguous() for t in args if isinstance(t, torch.Tensor))
            return fn(*args, **kw)
        monkeypatch.setattr(module, attr, wrapper)

    if contiguous is not None:  # P6's operand and weight, staged inside conv3x3_im2col
        dots = im2col_cuda.im2col_dots

        def spy(a, wmat):
            contiguous.extend((a.is_contiguous(), wmat.is_contiguous()))
            return dots(a, wmat)
        monkeypatch.setattr(im2col_cuda, "im2col_dots", spy)
    counted(layers, "head_attention", "head_attn")
    counted(tnsm, "batched_qk", "qk")
    counted(layers, "conv3x3_im2col", "im2col", edge=True)
    counted(layers, "channel_attention", "k5_cab")
    counted(tnsm, "channel_attention", "k5_tnsm")
    counted(layers, "conv3x3", "conv3x3")
    counted(layers, "half_prelu", "half_prelu")
    return calls


# calls per forward on the probe route: one P1 an LCA (base skips I_LCA5),
# one P10/P15 a TNSM block (11 serving: I_TNSM5 reaches nothing), the 16
# dense 3x3 convs on im2col (the 4 replication-padded stems and heads, 6
# NormUpsamples, 6 NormDownsamples, each followed by K3)
PROBE_CALLS = {
    "base": {"head_attn": 11, "qk": 0, "im2col": 16, "edge": 4, "half_prelu": 6},
    "mssa": {"head_attn": 12, "qk": 0, "im2col": 16, "edge": 4, "half_prelu": 6},
    "tnsm": {"head_attn": 12, "qk": 11, "im2col": 16, "edge": 4, "half_prelu": 6},
}


@pytest.mark.parametrize("variant", ["base", "mssa", "tnsm"])
def test_probe_route_takes_every_site(monkeypatch, variant):
    contiguous = []
    calls = _count_route_calls(monkeypatch, contiguous)
    model = CIDNet(CIDNetConfig(variant=variant, **TINY)).eval()
    with torch.no_grad():
        cidnet_forward(model, torch.rand(2, 16, 16, 3), routes=PROBE)
    assert calls == dict(PROBE_CALLS[variant], k5_cab=0, k5_tnsm=0, conv3x3=0)
    # the kernels take contiguous tensors only: at batch 2 the I stem's input
    # is a view (channel 2 of the HVI map), and every kernel input is whole
    assert len(contiguous) == 2 * 16 + 4 * PROBE_CALLS[variant]["head_attn"] \
        + 2 * PROBE_CALLS[variant]["qk"] and all(contiguous)


def test_probe_route_tnsm_training_takes_i_tnsm5(monkeypatch):
    calls = _count_route_calls(monkeypatch)
    model = CIDNet(CIDNetConfig(variant="tnsm", **TINY)).eval()
    with torch.no_grad():
        rgb, noise = cidnet_forward(model, torch.rand(1, 16, 16, 3), training=True, routes=PROBE)
    assert noise.shape == (1, 16, 16, 3)
    assert (calls["head_attn"], calls["qk"], calls["k5_tnsm"]) == (12, 12, 0)


@pytest.mark.parametrize("switch", ["head_attn", "im2col"])
def test_each_probe_switch_alone(monkeypatch, switch):
    calls = _count_route_calls(monkeypatch)
    model = CIDNet(CIDNetConfig(variant="tnsm", **TINY)).eval()
    with torch.no_grad():
        cidnet_forward(model, torch.rand(1, 16, 16, 3), routes=Routes(**{switch: True}))
    got = {k: calls[k] for k in ("head_attn", "qk", "im2col", "k5_cab", "k5_tnsm")}
    want = {"head_attn": {"head_attn": 12, "qk": 11, "im2col": 0, "k5_cab": 0, "k5_tnsm": 0},
            "im2col": {"head_attn": 0, "qk": 0, "im2col": 16, "k5_cab": 12, "k5_tnsm": 11}}
    assert got == want[switch]


def test_probe_route_with_the_fused_down(monkeypatch):
    """``down`` takes NormDownsample before ``im2col``: P5 at the 6 downs,
    im2col at the other 10 convs."""
    calls = _count_route_calls(monkeypatch)
    model = CIDNet(CIDNetConfig(**TINY)).eval()
    with torch.no_grad():
        cidnet_forward(model, torch.rand(1, 16, 16, 3), routes=Routes(im2col=True, down=True))
    assert (calls["im2col"], calls["half_prelu"]) == (10, 0)


def test_env_overrides(monkeypatch):
    for var in routes.ENV.values():
        monkeypatch.delenv(var, raising=False)
    assert routes.resolve(None) == UNFUSED
    monkeypatch.setenv("HVI_TORCH_HEAD_ATTN", "1")
    monkeypatch.setenv("HVI_TORCH_IM2COL", "1")
    assert routes.resolve(None) == PROBE
    assert routes.resolve(UNFUSED) == UNFUSED  # an explicit route wins
    monkeypatch.setenv("HVI_TORCH_IM2COL", "0")
    assert routes.from_env(PROBE) == Routes(head_attn=True)
    monkeypatch.setenv("HVI_TORCH_IM2COL", "1")
    monkeypatch.setenv("HVI_TORCH_CONV3X3", "1")
    with pytest.raises(ValueError, match="im2col and conv3x3"):
        routes.resolve(None)
    with pytest.raises(ValueError, match="im2col and conv3x3"):
        Routes(im2col=True, conv3x3=True)
    monkeypatch.setenv("HVI_TORCH_HEAD_ATTN", "on")
    with pytest.raises(ValueError, match="expected 0 or 1"):
        routes.resolve(None)


def test_probe_route_bf16_stays_near_fp32():
    cfg = CIDNetConfig(variant="tnsm", **TINY)
    model = CIDNet(cfg, generator=torch.Generator().manual_seed(2)).eval()
    bf = cast_conv_weights(CIDNet(cfg, generator=torch.Generator().manual_seed(2)),
                           torch.bfloat16).eval()
    x = torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (1, 16, 24, 3)).astype(np.float32))
    with torch.no_grad():
        ref = cidnet_forward(model, x, routes=PROBE)[0]
        got = cidnet_forward(bf, x.bfloat16(), compute_dtype=torch.bfloat16, routes=PROBE)[0]
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert (got.float() - ref).abs().mean().item() < 2e-2


def test_enhancer_and_clis_take_the_probe_route(tmp_path):
    model = CIDNet(CIDNetConfig(**TINY), generator=torch.Generator().manual_seed(4))
    img = np.random.default_rng(8).uniform(0, 1, (19, 26, 3)).astype(np.float32)
    probe = Enhancer(model, routes=PROBE, device="cpu")
    assert probe.routes == PROBE
    np.testing.assert_allclose(probe.enhance(img), Enhancer(model, device="cpu").enhance(img),
                               atol=TOL_FORWARD, rtol=0)
    res = net_test.main(["--cpu", "--size", "32", "--iters", "1", "--probe"])
    assert res["out_shape"] == (1, 32, 32, 3)
    with pytest.raises(SystemExit):
        net_test.parse_args(["--probe", "--fused"])
    with pytest.raises(SystemExit):
        demo.parse_args(["--probe", "--fused", "--input", "x.png"])
    assert FUSED != PROBE
