"""The port's utilities vs the JAX package's (CPU, tiny widths).

* ``utils/registry.py``: the registry's keys and each model config, field
  for field, against ``hvi_cidnet_tpu/utils/registry.py``; the ``KeyError``s.
* ``utils/profiling.py``: ``StepTimer`` against the JAX one on one patched
  clock; ``op_breakdown`` on a hand-written trace (argument lists, ``void``
  and ``.N`` suffixes stripped, exact sums, largest first, the CPU ops where
  a trace has no device events) and on an empty directory; ``trace`` of a
  real forward; the ranges of a traced base, MSSA and TNSM forward against
  the ``named_scope``s the JAX forward's lowered text carries, names and
  nesting; ``scope`` on an exception.
* The operation count (``utils/flops.py``): ``model_card``'s ``flops``
  on a tiny base forward equals a count by hand of its convs, its weight
  fold and the kernels' formulas; the plain versions' own aten ops are
  hidden; the routes count their kernels' formulas; ``net_test`` prints it.
* The kernel-flag registry (``ops/routes.py``): override > environment >
  default; set and clear; the scope restores on an exception; the
  ``KeyError`` texts; a flip taken by the next forward (bitwise the forward
  with ``routes=FUSED``); DP replicas' threads see an override;
  ``spatial_enhance_fn`` raises naming it.
* A CPU row group's first call: the 4-shard TNSM spatial forward's first
  call in a fresh process (JAX's CPU backend started first) is bitwise its
  second; MKL's first calls are made before the shards start, and a
  shard's thread takes its caller's intra-op thread count.
"""

import collections
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvi_cidnet_torch.cli import net_test
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, cidnet_forward
from hvi_cidnet_torch.ops import routes
from hvi_cidnet_torch.ops.routes import FUSED, Routes
from hvi_cidnet_torch.parallel.inference import dp_enhance_fn, spatial_enhance_fn
from hvi_cidnet_torch.parallel.mesh import make_mesh
from hvi_cidnet_torch.serve import Enhancer
from hvi_cidnet_torch.utils import flops, profiling, registry
from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.models.cidnet import cidnet_forward as jax_forward
from hvi_cidnet_tpu.models.cidnet import init_cidnet
from hvi_cidnet_tpu.ops.pallas_gate import _FLAG_DEFAULTS as jax_flag_defaults
from hvi_cidnet_tpu.utils import profiling as jax_profiling
from hvi_cidnet_tpu.utils import registry as jax_registry
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
CPU = torch.device("cpu")


def _model(variant="base", seed=0):
    return CIDNet(CIDNetConfig(variant=variant, **TINY),
                  generator=torch.Generator().manual_seed(seed)).eval()


def _x(h=16, w=24, seed=0, n=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32))


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------


def test_model_registry_matches_jax():
    assert list(registry.MODEL_REGISTRY.keys()) == list(jax_registry.MODEL_REGISTRY.keys()) \
        == ["base", "mssa", "tnsm"]
    for name, cfg in registry.MODEL_REGISTRY:
        ref = jax_registry.MODEL_REGISTRY.get(name)
        assert isinstance(cfg, CIDNetConfig)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), name
    for reg in ("ARCH_REGISTRY", "DATASET_REGISTRY", "LOSS_REGISTRY", "METRIC_REGISTRY"):
        assert getattr(registry, reg)._name == getattr(jax_registry, reg)._name


def test_registry_errors_and_decorator():
    reg = registry.Registry("demo")

    @reg.register
    def thing():
        return 1

    reg.register(2, name="two")
    assert reg.get("thing") is thing and "two" in reg and dict(iter(reg)) == {"thing": thing,
                                                                               "two": 2}
    with pytest.raises(KeyError, match="already registered in 'demo'"):
        reg.register(3, name="two")
    with pytest.raises(KeyError, match=r"'nope' not found in registry 'demo'; available"):
        reg.get("nope")
    with pytest.raises(KeyError, match="already registered"):
        registry.MODEL_REGISTRY.register(CIDNetConfig(), name="base")


# --------------------------------------------------------------------------
# StepTimer, trace, op_breakdown, scope
# --------------------------------------------------------------------------


def test_step_timer_matches_jax(monkeypatch):
    clock = [0.0, 0.5, 1.25, 1.5, 3.0, 3.125, 4.0]
    got = {}
    for name, mod in (("port", profiling), ("jax", jax_profiling)):
        ticks = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timer = mod.StepTimer(window=3)
        got[name] = [timer.tick() for _ in clock] + [timer.mean(), timer.window]
    assert got["port"] == got["jax"]
    assert got["port"][0] is None and got["port"][-2] == pytest.approx((1.5 + 0.125 + 0.875) / 3)


def _event(name, dur, cat="kernel", ts=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


def test_op_breakdown_on_a_hand_written_trace(tmp_path):
    events = [
        _event("void hvi_rgb_to_hvi_kernel<float, 4>(float const*, float*, int)", 3.5),
        _event("void hvi_rgb_to_hvi_kernel<float, 4>(float const*, float*, int)", 1.25),
        _event("void at::native::(anonymous namespace)::elementwise<(int)2>(int, "
               "at::native::(anonymous namespace)::F (*)(float))", 2.0),
        _event("layer_norm_channels_kernel.12", 7.0),
        _event("layer_norm_channels_kernel.3", 0.5),
        _event("Memcpy HtoD (Pageable -> Device)", 4.0, cat="gpu_memcpy"),
        _event("aten::conv2d", 100.0, cat="cpu_op"),           # not device time
        _event("HV_LCA1", 50.0, cat="user_annotation"),
        _event("iel_branch_kernel(float*)", 0, cat="kernel"),  # zero duration: skipped
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0},
    ]
    (tmp_path / "00000000000000000001.1.pt.trace.json").write_text(json.dumps(
        {"traceEvents": [_event("old_kernel(int)", 9.0)]}))
    newest = tmp_path / "00000000000000000002.1.pt.trace.json"
    newest.write_text(json.dumps({"traceEvents": events}))
    os.utime(newest, (time.time() + 5, time.time() + 5))
    got = profiling.op_breakdown(str(tmp_path))
    assert list(got.items()) == [
        ("layer_norm_channels_kernel", 7.5),
        ("hvi_rgb_to_hvi_kernel<float, 4>", 4.75),
        ("Memcpy HtoD", 4.0),
        ("at::native::(anonymous namespace)::elementwise<(int)2>", 2.0),
    ]
    assert list(profiling.op_breakdown(str(tmp_path), top=2)) == [
        "layer_norm_channels_kernel", "hvi_rgb_to_hvi_kernel<float, 4>"]
    # a CPU trace: its ops, the same way
    newest.write_text(json.dumps({"traceEvents": [
        _event("aten::conv2d", 3.0, cat="cpu_op"), _event("aten::conv2d", 4.0, cat="cpu_op"),
        _event("aten::add", 1.0, cat="cpu_op"), _event("HVIT", 9.0, cat="user_annotation")]}))
    assert profiling.op_breakdown(str(tmp_path)) == {"aten::conv2d": 7.0, "aten::add": 1.0}


def test_op_breakdown_without_a_trace(tmp_path):
    with pytest.raises(FileNotFoundError, match="no trace under"):
        profiling.op_breakdown(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        jax_profiling.op_breakdown(str(tmp_path))


def _annotations(log_dir):
    with open(profiling.newest_trace(log_dir)) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"),
                  key=lambda e: (e["tid"], e["ts"], -e["dur"]))


def _parents(spans):
    """(innermost enclosing range, range) name pairs of ``spans`` on one
    thread, ordered by start."""
    pairs, stack = set(), []
    for e in spans:
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"] + e["dur"]:
            stack.pop()
        if stack:
            pairs.add((stack[-1]["name"], e["name"]))
        stack.append(e)
    return pairs


def _jax_scopes(variant):
    """The named scopes and their (parent, child) pairs in the JAX forward's
    lowered text: the name stacks of its ops' locations, less the
    transforms (``jit(...)``), the einsum specs and the primitive."""
    cfg = JaxConfig(variant=variant, **TINY)
    p = jax.eval_shape(lambda: init_cidnet(jax.random.PRNGKey(0), cfg))  # shapes only
    text = jax.jit(lambda p, x: jax_forward(p, x, cfg)).lower(
        p, jax.ShapeDtypeStruct((1, 16, 16, 3), jnp.float32)).as_text(debug_info=True)
    names, pairs = set(), set()
    for stack in re.findall(r'loc\("jit\(<lambda>\)/([^"]*)"', text):
        scopes = [s for s in stack.split("/")[:-1]
                  if not (s.startswith("jit") or "->" in s or "(" in s)]
        names.update(scopes)
        pairs.update(zip(scopes, scopes[1:]))
    return names, pairs


@pytest.mark.parametrize("variant", ["base", "mssa", "tnsm"])
def test_forward_ranges_are_the_jax_named_scopes(tmp_path, variant):
    names, pairs = _jax_scopes(variant)
    assert {"HVIT", "IE_block0", "HVE_block0", "ID_block0", "HVD_block0", "hvi_residual",
            "PHVIT", "HV_LCA1.norm"} <= names
    model = _model(variant)
    with torch.no_grad(), profiling.trace(str(tmp_path)):
        cidnet_forward(model, _x(16, 16))
    spans = _annotations(str(tmp_path))
    counts = collections.Counter(e["name"] for e in spans)
    assert set(counts) == names
    assert _parents(spans) == pairs
    # once a forward, but the shared LayerNorms: thrice in an LCA, TNSM's
    # norm1 twice (x and y)
    for name, n in counts.items():
        if name.endswith(".norm") and "LCA" in name:
            assert n == 3, name
        elif name.endswith(".norm1"):
            assert n == 2, name
        else:
            assert n == 1, name


def test_scope_closes_on_an_exception(tmp_path):
    with profiling.trace(str(tmp_path)):
        with pytest.raises(RuntimeError, match="boom"):
            with profiling.scope("outer"):
                with profiling.scope("inner"):
                    torch.ones(2) + 1
                    raise RuntimeError("boom")
        with profiling.scope("after"):
            torch.ones(2) * 2
    spans = _annotations(str(tmp_path))
    assert [e["name"] for e in spans] == ["outer", "inner", "after"]
    assert _parents(spans) == {("outer", "inner")}


def test_the_ranges_are_told_apart_from_ops():
    """``is_range`` picks out exactly the forward's ranges in a profiler's
    events and rows, so sums over ops or kernels (``cli/profile_forward.py``,
    ``chip_smoke.py``) leave them out."""
    names, _ = _jax_scopes("base")
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        cidnet_forward(_model(), _x(16, 16))
    for events in (prof.events(), prof.key_averages()):
        ranges = {getattr(e, "key", getattr(e, "name", None)) for e in events
                  if profiling.is_range(e)}
        assert ranges == names
    assert not any(profiling.is_range(e) for e in prof.key_averages() if e.key.startswith("aten::"))


def test_trace_of_a_forward_breaks_it_down_by_op(tmp_path):
    model = _model()
    with torch.no_grad(), profiling.trace(str(tmp_path / "t")):
        cidnet_forward(model, _x())
    got = profiling.op_breakdown(str(tmp_path / "t"), top=5)
    assert len(got) == 5 and list(got.values()) == sorted(got.values(), reverse=True)
    assert "aten::conv2d" in got and all("(" not in k for k in got)


# --------------------------------------------------------------------------
# the operation count and model_card
# --------------------------------------------------------------------------


def _conv(b, cout, cin_per_group, k, h, w):
    return 2 * b * cout * cin_per_group * k * k * h * w


def _hand_count(cfg, b, h, w):
    """A tiny base forward's operations: its convs and NormUpsample's
    weight fold as torch's flop counter counts them, the kernels K1-K7 by
    their formulas (utils/flops.py: OPS_PER_ELEMENT, K5's products)."""
    c1, c2, c3, c4 = cfg.channels
    _, h2, h3, h4 = cfg.heads
    ops = collections.Counter()
    ops["K1"] = ops["K2"] = 0
    ops["K1"] += 40 * b * h * w
    ops["K2"] += 50 * b * h * w
    # stems and heads (replication pad + 3x3)
    ops["conv"] += _conv(b, c1, 1, 3, h, w) + _conv(b, c1, 3, 3, h, w)
    ops["conv"] += _conv(b, 1, c1, 3, h, w) + _conv(b, 2, c1, 3, h, w)
    # NormDownsample (x2 branches): 3x3 conv at the input size, K3 on its output
    for cin, cout, s in ((c1, c2, 1), (c2, c3, 2), (c3, c4, 4)):
        ops["conv"] += 2 * _conv(b, cout, cin, 3, h // s, w // s)
        ops["K3"] += 2 * 24 * b * cout * (h // (2 * s)) * (w // (2 * s))
    # NormUpsample (x2): the folded 3x3, K4 (12 an output element), the skip 1x1, the fold
    for cin, cout, s in ((c4, c3, 8), (c3, c2, 4), (c2, c1, 2)):
        ops["conv"] += 2 * (_conv(b, cout, cin, 3, h // s, w // s)
                            + _conv(b, cout, cout, 1, 2 * h // s, 2 * w // s))
        ops["fold"] += 2 * 2 * cout * cout * cin * 9
        ops["K4"] += 2 * 12 * b * cout * (2 * h // s) * (2 * w // s)
    # the LCAs: 11 in base (I_LCA5 skipped)
    levels = {1: (c2, h2, 2), 2: (c3, h3, 4), 3: (c4, h4, 8), 4: (c4, h4, 8), 5: (c3, h3, 4),
              6: (c2, h2, 2)}
    for idx, (dim, heads, s) in levels.items():
        n = (h // s) * (w // s)
        hid = int(dim * 2.66)
        for _ in range(1 if idx == 5 else 2):
            ops["K6"] += 3 * 8 * b * dim * n
            ops["conv"] += _conv(b, dim, dim, 1, h // s, w // s) + _conv(b, 2 * dim, dim, 1, h // s,
                                                                          w // s)
            ops["conv"] += _conv(b, 3 * dim, 1, 3, h // s, w // s)        # q, k, v depthwise
            cp = dim // heads
            ops["K5"] += 2 * b * dim * cp * n + 4 * b * dim * n + 2 * b * dim * dim * n
            ops["conv"] += _conv(b, 2 * hid, dim, 1, h // s, w // s)     # project_in
            ops["K7"] += 2 * 38 * b * hid * n
            ops["conv"] += _conv(b, dim, hid, 1, h // s, w // s)         # project_out
    return ops


def test_model_card_counts_the_kernels_by_their_formulas():
    cfg = CIDNetConfig(**TINY)
    model = _model()
    x = _x(16, 24)
    hand = _hand_count(cfg, 1, 16, 24)
    with torch.no_grad():
        card = profiling.model_card(lambda t: cidnet_forward(model, t), x, iters=2)
        with flops.count() as c:
            cidnet_forward(model, x)
    assert card["flops"] == sum(hand.values()) == c.total
    assert np.isnan(card["bytes_accessed"]) and 0 < card["seconds_per_call"] < 60
    assert dict(c.kernels) == {k: v for k, v in hand.items() if k.startswith("K")}
    assert c.aten == hand["conv"] + hand["fold"]
    # torch's counter alone also counts the plain versions' inner products
    # (the resizes' band matrices, K5's): a different number
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as raw:
        cidnet_forward(model, x)
    assert raw.get_total_flops() != c.total
    # outside a count nothing is hidden; a count is this thread's only
    with torch.no_grad(), FlopCounterMode(display=False) as raw2:
        t = threading.Thread(target=lambda: cidnet_forward(model, x))
        with flops.count() as other:
            t.start()
            t.join()
    assert other.total == 0 and raw2.get_total_flops() == 0


def test_the_routes_count_their_kernels():
    x = _x(16, 24)
    model = _model("tnsm")
    got = {}
    with torch.no_grad():
        for name, r in (("default", None), ("fused", FUSED), ("probe", routes.PROBE)):
            with flops.count() as c:
                cidnet_forward(model, x, routes=r)
            got[name] = c
    assert set(got["fused"].kernels) == {"K1", "K2", "K4", "K5", "K6", "P2/P3", "P4", "P5"}
    assert set(got["probe"].kernels) == {"K1", "K2", "K3", "K4", "K6", "K7", "P1", "P6",
                                         "P10/P15"}
    # P4 and P6 count a dense 3x3 conv as torch's counter counts cuDNN's
    assert got["probe"].kernels["P6"] == got["fused"].kernels["P4"] + sum(
        _conv(1, co, ci, 3, 16 // s, 24 // s) for ci, co, s in ((8, 8, 1), (8, 16, 2),
                                                                 (16, 32, 4)) for _ in (0, 1))
    for c in got.values():
        assert c.total > 0 and c.aten > 0


def test_net_test_prints_the_count(capsys):
    res = net_test.main(["--cpu", "--size", "16", "--iters", "1"])
    out = capsys.readouterr().out
    model = CIDNet(CIDNetConfig(), generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(0).random((1, 16, 16, 3))).float()
    with torch.no_grad(), flops.count() as c:
        cidnet_forward(model, x)
    assert res["flops"] == c.total
    assert f"({c.total:,}; convs and products by torch's flop counter, kernels" in out


# --------------------------------------------------------------------------
# the kernel-flag registry
# --------------------------------------------------------------------------


@pytest.fixture
def clean_env(monkeypatch):
    for var in routes.ENV.values():
        monkeypatch.delenv(var, raising=False)
    yield monkeypatch
    assert not routes._overrides


def test_flag_priorities(clean_env):
    assert routes.FLAG_DEFAULTS == {
        "ln_iel": ("HVI_TORCH_LN_IEL", False), "down": ("HVI_TORCH_FUSED_DOWN", False),
        "conv3x3": ("HVI_TORCH_CONV3X3", False), "head_attn": ("HVI_TORCH_HEAD_ATTN", False),
        "im2col": ("HVI_TORCH_IM2COL", False)}
    assert not any(routes.kernel_flag(n) for n in routes.FLAG_DEFAULTS)
    clean_env.setenv("HVI_TORCH_LN_IEL", "1")
    assert routes.kernel_flag("ln_iel")
    routes.set_kernel_flag("ln_iel", False)      # the override wins over the environment
    try:
        assert not routes.kernel_flag("ln_iel")
        assert routes.resolve(None) == routes.UNFUSED
        routes.set_kernel_flag("down", 1)
        assert routes.kernel_flag("down") is True
        assert routes.resolve(None) == Routes(down=True)
    finally:
        routes.set_kernel_flag("ln_iel", None)   # cleared: the environment again
        routes.set_kernel_flag("down", None)
    assert routes.kernel_flag("ln_iel") and not routes.kernel_flag("down")
    clean_env.setenv("HVI_TORCH_CONV3X3", "true")
    with pytest.raises(ValueError, match=r"HVI_TORCH_CONV3X3='true': expected 0 or 1"):
        routes.kernel_flag("conv3x3")
    with routes.kernel_flags(conv3x3=False):     # an override skips the environment
        assert not routes.kernel_flag("conv3x3")


def test_scoped_flags_restore(clean_env):
    routes.set_kernel_flag("im2col", True)
    try:
        with pytest.raises(RuntimeError, match="inside"):
            with routes.kernel_flags(ln_iel=True, im2col=None, head_attn=False):
                assert routes.resolve(None) == Routes(ln_iel=True)
                assert routes._overrides == {"ln_iel": True, "head_attn": False}
                raise RuntimeError("inside")
        assert routes._overrides == {"im2col": True}
        with routes.kernel_flags(im2col=False):
            with routes.kernel_flags(im2col=True, conv3x3=True):
                with pytest.raises(ValueError, match="im2col and conv3x3"):
                    routes.resolve(None)
            assert routes._overrides == {"im2col": False}
        assert routes._overrides == {"im2col": True}
    finally:
        routes.set_kernel_flag("im2col", None)
    with pytest.raises(KeyError):
        with routes.kernel_flags(ln_iel=True, nope=True):
            pass
    assert not routes._overrides  # nothing was set before the KeyError


@pytest.mark.parametrize("name,text", [
    ("nope", r"unknown kernel flag 'nope'; known: \['conv3x3', 'down', 'head_attn', 'im2col', "
             r"'ln_iel'\]"),
    *[(n, "on the card the kernel always runs; the plain versions serve the CPU and the tests")
      for n in ("hvi_pallas", "resize_pallas", "attn_pallas", "ln_pallas", "iel_pallas")],
    *[(n, r"a TPU layout seam, not ported \(ROADMAP.md, north star\)")
      for n in ("ln_stats_conv", "attn_ncb_feed", "hvi_hwb_order", "loss_blur_mxu")],
    ("upsample_fold", "always applied, as an exact rewrite"),
])
def test_flag_key_errors(clean_env, name, text):
    for call in (lambda: routes.kernel_flag(name), lambda: routes.set_kernel_flag(name, True)):
        with pytest.raises(KeyError, match=text):
            call()


def test_every_jax_flag_is_accounted_for():
    assert set(routes.NOT_PORTED) == set(jax_flag_defaults)
    assert not set(routes.FLAG_DEFAULTS) & set(jax_flag_defaults)


def test_a_flip_takes_the_next_forward(clean_env):
    model = _model()
    x = _x()
    with torch.no_grad():
        default = cidnet_forward(model, x)
        fused = cidnet_forward(model, x, routes=FUSED)
        with routes.kernel_flags(ln_iel=True, down=True, conv3x3=True), flops.count() as on:
            flipped = cidnet_forward(model, x)
        with flops.count() as off:
            after = cidnet_forward(model, x)
        enhancer = Enhancer(model, device="cpu")     # routes=None: read at each forward
        img = x[0].numpy()
        with routes.kernel_flags(ln_iel=True, down=True, conv3x3=True):
            served_fused = enhancer.enhance(img)
        served = enhancer.enhance(img)
    assert torch.equal(flipped, fused) and torch.equal(after, default)
    # the route's kernels ran under the flags, and the default ones after
    assert {"P2/P3", "P4", "P5"} <= set(on.kernels) and "K7" not in on.kernels
    assert not {"P2/P3", "P4", "P5"} & set(off.kernels) and "K7" in off.kernels
    np.testing.assert_array_equal(served_fused, Enhancer(model, device="cpu",
                                                         routes=FUSED).enhance(img))
    np.testing.assert_array_equal(served, Enhancer(model, device="cpu").enhance(img))


def test_dp_replicas_see_an_override(clean_env):
    model = _model()
    x = _x(n=2)
    fn = dp_enhance_fn(make_mesh(devices=[CPU] * 2, axis_names=("data",)), model)
    seen = []
    real = routes.resolve

    def spy(r):
        seen.append(threading.current_thread() is threading.main_thread())
        return real(r)

    clean_env.setattr("hvi_cidnet_torch.models.cidnet.resolve", spy)
    with routes.kernel_flags(ln_iel=True):
        got = fn(x)
    assert seen == [False, False]  # resolved on the replicas' threads
    one = Enhancer(model, device="cpu", routes=Routes(ln_iel=True))
    assert torch.equal(got, torch.cat([one._forward(x[i:i + 1]) for i in range(2)]))


def test_spatial_raises_naming_the_override(clean_env):
    fn = spatial_enhance_fn(make_mesh(devices=[CPU] * 2, axis_names=("spatial",)), _model())
    with routes.kernel_flags(ln_iel=True):
        with pytest.raises(ValueError, match=r"ln_iel \(kernel_flags override\) is on"):
            fn(_x())
    clean_env.setenv("HVI_TORCH_LN_IEL", "1")
    with pytest.raises(ValueError, match=r"ln_iel \(HVI_TORCH_LN_IEL\) is on"):
        fn(_x())


# --------------------------------------------------------------------------
# a CPU row group's first call in a process
# --------------------------------------------------------------------------

FIRST_CALL_CHILD = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
jnp.ones(4).block_until_ready()       # JAX's CPU backend first, as the suite has it
import numpy as np
import torch
torch.set_num_threads(1)
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, HVIGates
from hvi_cidnet_torch.parallel import rows
from hvi_cidnet_torch.parallel.inference import spatial_enhance_fn
from hvi_cidnet_torch.parallel.mesh import make_mesh

model = CIDNet(CIDNetConfig(variant="tnsm", channels=(8, 8, 16, 32), heads=(1, 2, 4, 8)),
               generator=torch.Generator().manual_seed(0))
x = np.random.default_rng(0).uniform(0, 1, (1, 40, 48, 3)).astype(np.float32)
fn = spatial_enhance_fn(make_mesh(devices=[torch.device("cpu")] * 4, axis_names=("spatial",)),
                        model, HVIGates(gated2=True, alpha=0.9), gamma=0.8)
assert rows.cpu_libraries_ready.cache_info().currsize == 0
first, second = fn(x), fn(x)
assert rows.cpu_libraries_ready.cache_info().currsize == 1  # MKL's first calls made here
tasks = lambda: len(os.listdir("/proc/self/task"))
def product(shard):
    before = tasks()
    q = torch.rand(2, 8, 192)
    torch.bmm(q, q.transpose(1, 2))
    return torch.get_num_threads(), tasks() - before
# one shard: no other thread of the group starts while it counts (threads
# of the calls before may still be ending)
group = rows.RowGroup([torch.device("cpu")])
print(json.dumps({{"equal": bool(torch.equal(first, second)),
                   "max": float((first - second).abs().max()),
                   "shard": rows.run_groups([group], product)[0][0]}}))
"""


def test_a_shards_first_call_is_its_second():
    """The reproduction, once, in a fresh process; and the repair's
    mechanisms: MKL's first calls made on the calling thread before the
    shards start, and a shard's thread on the caller's one intra-op
    thread, so that an MKL product there starts no thread pool."""
    out = subprocess.run([sys.executable, "-c", FIRST_CALL_CHILD.format(repo=REPO)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["equal"], res
    threads, started = res["shard"]
    assert threads == 1 and started <= 0, res
