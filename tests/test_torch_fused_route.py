"""The fused block route of the PyTorch port vs the JAX package (CPU, fp32).

The route's kernels take their plain versions on a CPU tensor; each plain
version is held here to the JAX Pallas kernel it replaces, run in interpret
mode, on inputs from numpy with a seed:

* P2/P3, ``ops/ln_iel.py:ln_iel``, against ``experiments/iel_fused_pallas.py:
  fused_iel`` (its module's ``INTERPRET`` set) and ``experiments/
  iel_pallas_nhcw.py:_pallas_ln_iel(..., interpret=True)``, residual on and
  off, at H x W not a multiple of either kernel's tile;
* P4's plain conv (``ops/conv3x3_cuda.py:conv3x3_plain``) against
  ``experiments/conv_pallas_nhcw.py:_pallas_conv3x3``, zero and edge pad;
* P5's plain version against ``experiments/fused_pallas_nhcw.py:_pallas_down``.

P4's and P5's Pallas functions take no ``interpret`` argument: the tests
swap their module's ``pl`` for one whose ``pallas_call`` interprets. The
experiments load by path. Their public wrappers (``fused_ln_iel``,
``fused_norm_downsample``) take, off the TPU, XLA twins written for the NHCW
layout that now call the HWCB-layout ``hvi_cidnet_tpu/ops/conv.py``; those
twins are wrong (one test pins that), so nothing here calls the wrappers.
Tolerance 1e-5 (fp32 sums over C, the hidden width or nine taps in another
order).

The tiny base, MSSA and TNSM forwards with every route on are held to the
JAX ``cidnet_forward`` at the whole-forward bar, 2e-5, on weights carried
across by ``jax_params_to_torch``, and to the port's unfused route (in fp32
on the CPU the route's plain versions run the same ops in the same order,
so the two are bitwise equal). Counting the route's calls pins which blocks
take it.
"""

import functools
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.models.cidnet import cidnet_forward as jax_forward
from hvi_cidnet_torch.cli import net_test
from hvi_cidnet_torch.compat.jax_params import jax_params_to_torch, load_weights
from hvi_cidnet_torch.models import layers
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, cast_conv_weights, cidnet_forward
from hvi_cidnet_torch.ops import conv3x3_cuda, ln_iel_cuda, routes
from hvi_cidnet_torch.ops.routes import FUSED, UNFUSED, Routes
from hvi_cidnet_torch.serve import Enhancer
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
TOL = 1e-5


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
    mods = {n: _experiment(n) for n in ("iel_fused_pallas", "iel_pallas_nhcw",
                                        "conv_pallas_nhcw", "fused_pallas_nhcw")}
    mods["iel_fused_pallas"].INTERPRET = True
    for n in ("conv_pallas_nhcw", "fused_pallas_nhcw"):
        mods[n].pl = _InterpretPallas()
    return mods


def _nhcw(x: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))


def _nchw(y) -> np.ndarray:
    return np.asarray(y, np.float32).transpose(0, 2, 1, 3)


def _hwio(w: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(np.ascontiguousarray(w.transpose(2, 3, 1, 0)))


def _ln_iel_inputs(c: int, seed: int):
    """x (1, c, 20, 36) and LN + IEL weights (OIHW) with hidden = int(2.66 c)."""
    rng = np.random.default_rng(seed)
    hid = int(c * 2.66)
    f = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)
    x = f(1, c, 20, 36) + 0.3
    ln_w = rng.uniform(0.5, 1.5, c).astype(np.float32)
    ln_b = f(c, s=0.1)
    w_pi, w_dw = f(2 * hid, c, 1, 1, s=c**-0.5), f(2 * hid, 1, 3, 3, s=1 / 3)
    w_dw1, w_dw2 = f(hid, 1, 3, 3, s=1 / 3), f(hid, 1, 3, 3, s=1 / 3)
    w_po = f(c, hid, 1, 1, s=hid**-0.5)
    return x, (ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po)


def _port_ln_iel(x, weights, residual):
    return ln_iel_cuda.ln_iel(torch.from_numpy(x), *map(torch.from_numpy, weights),
                              residual).numpy()


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no_residual"])
@pytest.mark.parametrize("c", [12, 36])
def test_ln_iel_matches_p3(exp, c, residual):
    x, (ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po) = _ln_iel_inputs(c, c + residual)
    ref = exp["iel_pallas_nhcw"]._pallas_ln_iel(
        _nhcw(x), jnp.asarray(ln_w), jnp.asarray(ln_b), *map(_hwio, (w_pi, w_dw, w_dw1, w_dw2, w_po)),
        residual, interpret=True)
    got = _port_ln_iel(x, (ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po), residual)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, _nchw(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no_residual"])
@pytest.mark.parametrize("c", [12, 36])
def test_ln_iel_matches_p2(exp, c, residual):
    x, (ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po) = _ln_iel_inputs(c, 10 * c + residual)
    ref = exp["iel_fused_pallas"].fused_iel(
        _nhcw(x), *map(_hwio, (w_pi, w_dw, w_dw1, w_dw2, w_po)), jnp.asarray(ln_w),
        jnp.asarray(ln_b), residual)
    got = _port_ln_iel(x, (ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po), residual)
    np.testing.assert_allclose(got, _nchw(ref), atol=TOL, rtol=0)


def test_ln_iel_zero_pads_the_intermediates():
    """SAME zero padding applies to pi(LN(x)) and to the first depthwise
    conv's output, not to x: an LN of the zero ring would give pi(ln_b)
    there, and a first dw computed on the ring would feed the gate's dw.
    Either changes the border pixels."""
    x, weights = _ln_iel_inputs(12, 3)
    ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po = map(torch.from_numpy, weights)
    xt = torch.from_numpy(x)
    got = ln_iel_cuda.ln_iel(xt, ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po, False)
    hid = w_pi.shape[0] // 2
    conv = torch.nn.functional.conv2d

    def wrong(ring_ln: bool):
        xp = torch.nn.functional.pad(xt, (2, 2, 2, 2))
        t = layers.layer_norm(xp, ln_w, ln_b)
        if not ring_ln:  # zero ring for pi, but the first dw computed on the ring
            t = torch.nn.functional.pad(t[:, :, 2:-2, 2:-2], (2, 2, 2, 2))
        gates = []
        for half, wg in ((slice(0, hid), w_dw1), (slice(hid, None), w_dw2)):
            t1 = conv(conv(t, w_pi[half]), w_dw[half], groups=hid)  # 1-pixel ring left
            gates.append(torch.tanh(conv(t1, wg, groups=hid)) + t1[:, :, 1:-1, 1:-1])
        return conv(gates[0] * gates[1], w_po)

    for ring_ln in (True, False):
        diff = (got - wrong(ring_ln)).abs()
        assert diff[:, :, [0, -1]].max() > 1e-3 and diff[:, :, 2:-2, 2:-2].max() < TOL


@pytest.mark.parametrize("pad_mode", ["zero", "edge"])
def test_p4_plain_matches_pallas(exp, pad_mode):
    rng = np.random.default_rng(1 if pad_mode == "zero" else 2)
    x = rng.standard_normal((1, 12, 20, 36)).astype(np.float32)
    w = (rng.standard_normal((8, 12, 3, 3)) / 6).astype(np.float32)
    ref = exp["conv_pallas_nhcw"]._pallas_conv3x3(_nhcw(x), _hwio(w), pad_mode)
    got = conv3x3_cuda.conv3x3(torch.from_numpy(x), torch.from_numpy(w), pad_mode).numpy()
    assert got.shape == (1, 8, 20, 36)
    np.testing.assert_allclose(got, _nchw(ref), atol=TOL, rtol=0)


def test_p5_plain_matches_pallas(exp):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 12, 20, 36)).astype(np.float32)
    w = (rng.standard_normal((8, 12, 3, 3)) / 6).astype(np.float32)
    alpha = np.full((1,), 0.25, np.float32)
    ref = exp["fused_pallas_nhcw"]._pallas_down(_nhcw(x), _hwio(w), jnp.asarray(alpha[0]))
    got = conv3x3_cuda.conv3x3_half_prelu(torch.from_numpy(x), torch.from_numpy(w),
                                          torch.from_numpy(alpha)).numpy()
    assert got.shape == (1, 8, 10, 18)
    np.testing.assert_allclose(got, _nchw(ref), atol=TOL, rtol=0)


def test_stale_xla_twins_disagree_with_their_kernels(exp):
    """The experiments' XLA twins of P3 and P5 call today's HWCB-layout ops
    on NHCW data and are wrong (by 0.05 and 1.23 where first measured), so
    the wrappers that return them off the TPU are no reference. The
    interpret-mode kernels are, and agree with the port above."""
    x, (ln_w, ln_b, w_pi, w_dw, w_dw1, w_dw2, w_po) = _ln_iel_inputs(12, 8)
    args = (_nhcw(x), jnp.asarray(ln_w), jnp.asarray(ln_b),
            *map(_hwio, (w_pi, w_dw, w_dw1, w_dw2, w_po)), True)
    kernel = exp["iel_pallas_nhcw"]._pallas_ln_iel(*args, interpret=True)
    stale = exp["iel_pallas_nhcw"]._xla_ln_iel(*args)
    assert float(jnp.abs(kernel - stale).max()) > 1e-2

    rng = np.random.default_rng(9)
    xd = _nhcw(rng.standard_normal((1, 12, 20, 36)).astype(np.float32))
    wd = _hwio((rng.standard_normal((8, 12, 3, 3)) / 6).astype(np.float32))
    kernel = exp["fused_pallas_nhcw"]._pallas_down(xd, wd, jnp.float32(0.25))
    stale = exp["fused_pallas_nhcw"]._xla_down(xd, wd, jnp.float32(0.25))
    assert float(jnp.abs(kernel - stale).max()) > 1e-2


# ---------------------------------------------------------------------------
# the forward with every route on
# ---------------------------------------------------------------------------


def _jax_layout(model: CIDNet) -> dict:
    return {
        k: np.ascontiguousarray(v.numpy().transpose(2, 3, 1, 0)) if v.dim() == 4 else v.numpy().copy()
        for k, v in model.state_dict().items()
    }


def _rgb(out, variant):
    return out[0] if variant == "tnsm" else out


@pytest.mark.parametrize("variant", ["base", "mssa", "tnsm"])
def test_fused_route_tiny_forward_matches_jax(variant):
    cfg = CIDNetConfig(variant=variant, **TINY)
    np_params = _jax_layout(CIDNet(cfg, generator=torch.Generator().manual_seed(31)))
    # the JAX parameters reach the port through the bridge
    port = load_weights(CIDNet(cfg), jax_params_to_torch(np_params)).eval()
    x = np.random.default_rng(6).uniform(0, 1, (2, 16, 24, 3)).astype(np.float32)
    jcfg = JaxConfig(variant=variant, **TINY)
    ref = jax.jit(lambda p, x: _rgb(jax_forward(p, x, jcfg), variant))(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(x))
    with torch.no_grad():
        got = _rgb(cidnet_forward(port, torch.from_numpy(x), routes=FUSED), variant)
        unfused = _rgb(cidnet_forward(port, torch.from_numpy(x), routes=UNFUSED), variant)
    assert got.shape == (2, 16, 24, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    assert torch.equal(got, unfused)


# calls of each route's function per forward, with every route on: one
# P2/P3 an LCA (base skips I_LCA5), P4 at the 4 stems/heads and 6
# NormUpsamples, P5 at the 6 NormDownsamples; the LayerNorm keeps the CAB's
# two an LCA and TNSM's four a block (11 serving blocks)
ROUTE_CALLS = {
    "base": {"ln_iel": 11, "residual": 5, "conv3x3": 10, "edge": 4, "down": 6, "layer_norm": 22},
    "mssa": {"ln_iel": 12, "residual": 6, "conv3x3": 10, "edge": 4, "down": 6, "layer_norm": 24},
    "tnsm": {"ln_iel": 12, "residual": 6, "conv3x3": 10, "edge": 4, "down": 6,
             "layer_norm": 24 + 44},
}


def _count_route_calls(monkeypatch):
    """Counts the calls of the blocks' ops in ``models/layers.py``: the
    route's three (P2/P3 with and without the residual, P4 with each pad,
    P5) and the unfused ones they replace."""
    calls = {k: 0 for k in ("ln_iel", "residual", "conv3x3", "edge", "down", "layer_norm",
                            "iel_branch", "half_prelu")}

    def counted(attr, key, sub=None):
        fn = getattr(layers, attr)

        def wrapper(*args, **kw):
            calls[key] += 1
            if sub is not None and sub[1](args):
                calls[sub[0]] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(layers, attr, wrapper)

    counted("ln_iel", "ln_iel", ("residual", lambda a: a[-1]))
    counted("conv3x3", "conv3x3", ("edge", lambda a: a[-1] == "edge"))
    counted("conv3x3_half_prelu", "down")
    for attr in ("layer_norm", "iel_branch", "half_prelu"):
        counted(attr, attr)
    return calls


@pytest.mark.parametrize("variant", ["base", "mssa", "tnsm"])
def test_fused_route_takes_every_site(monkeypatch, variant):
    calls = _count_route_calls(monkeypatch)
    model = CIDNet(CIDNetConfig(variant=variant, **TINY)).eval()
    with torch.no_grad():
        cidnet_forward(model, torch.rand(1, 16, 16, 3), routes=FUSED)
    want = dict(ROUTE_CALLS[variant], iel_branch=0, half_prelu=0)
    assert calls == want


@pytest.mark.parametrize("variant", ["base", "mssa", "tnsm"])
def test_fused_route_hands_the_kernels_contiguous_inputs(monkeypatch, variant):
    """The kernels take contiguous tensors only (they raise on a view): at
    batch 2 the I stem's input, channel 2 of the HVI map, is a view, and the
    route must copy it."""
    seen = []

    def spy(name, fn):
        def wrapper(x, *args):
            seen.append((name, x.is_contiguous()))
            return fn(x, *args)
        monkeypatch.setattr(layers, name, wrapper)

    for name in ("ln_iel", "conv3x3", "conv3x3_half_prelu"):
        spy(name, getattr(layers, name))
    model = CIDNet(CIDNetConfig(variant=variant, **TINY)).eval()
    with torch.no_grad():
        cidnet_forward(model, torch.rand(2, 16, 16, 3), routes=FUSED)
    assert len(seen) == sum(ROUTE_CALLS[variant][k] for k in ("ln_iel", "conv3x3", "down"))
    assert all(contiguous for _, contiguous in seen), seen


def test_route_off_is_the_unfused_forward(monkeypatch):
    calls = _count_route_calls(monkeypatch)
    model = CIDNet(CIDNetConfig(**TINY)).eval()
    with torch.no_grad():
        cidnet_forward(model, torch.rand(1, 16, 16, 3))
    assert calls == {"ln_iel": 0, "residual": 0, "conv3x3": 0, "edge": 0, "down": 0,
                     "layer_norm": 33, "iel_branch": 22, "half_prelu": 6}


@pytest.mark.parametrize("switch", ["ln_iel", "down", "conv3x3"])
def test_each_switch_alone(monkeypatch, switch):
    """Each switch takes its own sites only; with ``down`` off and
    ``conv3x3`` on, NormDownsample's conv is P4 too."""
    calls = _count_route_calls(monkeypatch)
    model = CIDNet(CIDNetConfig(**TINY)).eval()
    with torch.no_grad():
        cidnet_forward(model, torch.rand(1, 16, 16, 3), routes=Routes(**{switch: True}))
    got = {k: calls[k] for k in ("ln_iel", "down", "conv3x3", "iel_branch", "half_prelu")}
    want = {"ln_iel": {"ln_iel": 11, "down": 0, "conv3x3": 0, "iel_branch": 0, "half_prelu": 6},
            "down": {"ln_iel": 0, "down": 6, "conv3x3": 0, "iel_branch": 22, "half_prelu": 0},
            "conv3x3": {"ln_iel": 0, "down": 0, "conv3x3": 16, "iel_branch": 22,
                        "half_prelu": 6}}[switch]
    assert got == want


def test_env_overrides(monkeypatch):
    for var in routes.ENV.values():
        monkeypatch.delenv(var, raising=False)
    assert routes.resolve(None) == UNFUSED
    monkeypatch.setenv("HVI_TORCH_LN_IEL", "1")
    monkeypatch.setenv("HVI_TORCH_CONV3X3", "0")
    assert routes.resolve(None) == Routes(ln_iel=True)
    assert routes.from_env(FUSED) == Routes(ln_iel=True, down=True, conv3x3=False)
    assert routes.resolve(UNFUSED) == UNFUSED  # an explicit route wins
    monkeypatch.setenv("HVI_TORCH_FUSED_DOWN", "yes")
    with pytest.raises(ValueError, match="expected 0 or 1"):
        routes.resolve(None)


def test_fused_route_bf16_rounds_once():
    """In bf16 the route keeps its stages in fp32 but for the TPU kernels'
    own rounding points (P2/P3: the LayerNorm's output and the gates'
    product; P5: the H pass's rows and the W taps) and rounds each kernel's
    result once, where the unfused chain rounds between every stage: both
    stay near the fp32 forward, and they differ."""
    cfg = CIDNetConfig(**TINY)
    model = CIDNet(cfg, generator=torch.Generator().manual_seed(2)).eval()
    bf = cast_conv_weights(CIDNet(cfg, generator=torch.Generator().manual_seed(2)),
                           torch.bfloat16).eval()
    x = torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (1, 16, 24, 3)).astype(np.float32))
    with torch.no_grad():
        ref = cidnet_forward(model, x)
        fused = cidnet_forward(bf, x.bfloat16(), compute_dtype=torch.bfloat16, routes=FUSED)
        unfused = cidnet_forward(bf, x.bfloat16(), compute_dtype=torch.bfloat16)
    assert fused.dtype == torch.bfloat16 and torch.isfinite(fused.float()).all()
    assert (fused.float() - ref).abs().mean().item() < 2e-2
    assert (unfused.float() - ref).abs().mean().item() < 2e-2
    assert not torch.equal(fused, unfused)


def test_enhancer_and_cli_take_the_route(tmp_path):
    model = CIDNet(CIDNetConfig(**TINY), generator=torch.Generator().manual_seed(4))
    img = np.random.default_rng(8).uniform(0, 1, (19, 26, 3)).astype(np.float32)
    fused = Enhancer(model, routes=FUSED, device="cpu")
    assert fused.routes == FUSED
    np.testing.assert_array_equal(fused.enhance(img), Enhancer(model, device="cpu").enhance(img))
    res = net_test.main(["--cpu", "--size", "32", "--iters", "1", "--fused"])
    assert res["out_shape"] == (1, 32, 32, 3)
