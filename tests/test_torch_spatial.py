"""The port's spatial row sharding (``parallel/rows.py``,
``spatial_enhance_fn``, ``dp_spatial_enhance_fn``, ``demo --spatial``) vs
the port's single-device forward and the JAX package's (CPU, fp32).

Meshes are repeated CPU devices; widths are tiny; the port's seeded
weights are carried to JAX by ``torch_to_jax_params`` (the JAX
``init_cidnet`` costs ~30 s of eager dispatch or compilation on the CPU).

* The whole path: base, MSSA and TNSM over 2, 3 and 4 row shards within
  TOL_SINGLE of the port's single-device forward of the same padded input,
  and over 2 and 4 within TOL_JAX of the JAX ``spatial_enhance_fn`` on as
  many of the 8 fake devices; the pad rule (H = 40 over 2 and 3 shards, 72
  over 4 reflect-padded to 96, an 8-row sliver over 4 edge-padded to 32).
  TNSM holds the same bars: its sharded forward differs from the whole
  one only in the order of the attention's and the pools' sums.
* ``dp_spatial_enhance_fn`` on (2, 2) and (1, 4) meshes against the JAX one
  on (2, 2); the JAX indivisible-batch text.
* Each op that reaches across rows, alone, on row blocks at every level,
  2-4 shards: the 3x3 convs' zero and replicate halos and MSSA's 7x7 gate
  (TOL_OP), K7's, K3's and K4's plain versions on bands (bitwise the
  whole plane's rows), K5's split plain version against the one-call one
  (TOL_K5, both ``normalize_qk``, folded and not), TNSM's pools.
* A shard that raises makes the call raise at once; one that stalls, a
  ``TimeoutError`` within the timeout. Routes, HWCB and ``training=True``
  raise in a row group.
"""

import functools
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.models.cidnet import HVIGates as JaxGates
from hvi_cidnet_tpu.parallel import inference as jax_inference
from hvi_cidnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hvi_cidnet_torch.cli import demo
from hvi_cidnet_torch.compat.jax_params import torch_to_jax_params
from hvi_cidnet_torch.data import png
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, HVIGates, cidnet_forward
from hvi_cidnet_torch.models.layers import SpatialAttention
from hvi_cidnet_torch.models.tnsm import DynamicNoiseMap, global_pools
from hvi_cidnet_torch.ops import attention, conv, iel_cuda, resize, resize_cuda, routes
from hvi_cidnet_torch.ops.attention_cuda import channel_attention
from hvi_cidnet_torch.parallel import rows
from hvi_cidnet_torch.parallel.inference import (
    dp_spatial_enhance_fn,
    pad_to_mesh,
    spatial_enhance_fn,
)
from hvi_cidnet_torch.parallel.mesh import make_mesh, spatial_sharding
from _torch_port import on_rows, one_torch_thread  # noqa: F401 (autouse)

TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
VARIANTS = ("base", "mssa", "tnsm")
TOL_SINGLE = 1e-5   # sharded vs the port's single-device forward, fp32
TOL_JAX = 2e-5      # the port vs the JAX package (its own bar against torch)
TOL_OP = 1e-6       # one conv on row blocks vs the whole plane
TOL_K5 = 1e-6       # K5's split plain version vs the one-call one, relative to max(1, |ref|)
GAMMA = 0.8
GATES = dict(gated2=True, alpha=0.9)
CPU = torch.device("cpu")
# XLA's CPU backend at its lowest optimisation level: the JAX programs
# compile in a third less time
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@functools.lru_cache(maxsize=None)
def _model(variant):
    return CIDNet(CIDNetConfig(variant=variant, **TINY), generator=torch.Generator().manual_seed(0))


def _jax_params(variant):
    return {k: jnp.asarray(v) for k, v in torch_to_jax_params(_model(variant).state_dict()).items()}


@pytest.fixture(scope="module")
def models():
    """variant -> the port's seeded tiny CIDNet."""
    return {v: _model(v) for v in VARIANTS}


def _images(seed, n=1, h=40, w=48):
    return np.random.default_rng(seed).uniform(0, 1, (n, h, w, 3)).astype(np.float32)


def _single(model, x, n_row):
    """The port's single-device forward of ``x`` padded as ``n_row`` row
    shards pad it, cropped back."""
    h, w = x.shape[1:3]
    xp = pad_to_mesh(torch.from_numpy(x), n_row)
    with torch.no_grad():
        out = cidnet_forward(model, xp ** GAMMA, HVIGates(**GATES))
    if model.config.variant == "tnsm":
        out = out[0]
    return out.float().clamp(0, 1)[:, :h, :w].numpy()


# the JAX programs: (name, function, mesh shape, variant, input). At H = 32
# neither 2 nor 4 row shards pad, so one program holds both; base over 2
# shards at H = 40 holds the pad to 48, and over 4 through the (1, 4) DP mesh
JAX_CASES = [("spatial-base-2", "spatial", (2,), "base", _images(0)),
             ("spatial-mssa-4", "spatial", (4,), "mssa", _images(0, h=32)),
             ("spatial-tnsm-4", "spatial", (4,), "tnsm", _images(0, h=32)),
             ("dp-base-2x2", "dp", (2, 2), "base", _images(1, n=4, h=32))]


@pytest.fixture(scope="module")
def jax_ref():
    """name -> the JAX output, the programs compiled side by side."""
    gates = JaxGates(**GATES)

    def run(case):
        name, kind, shape, variant, x = case
        cfg = JaxConfig(variant=variant, **TINY)
        if kind == "spatial":
            mesh = jax_make_mesh(devices=jax.devices()[:shape[0]], axis_names=("spatial",))
            fn, sharding, rep = jax_inference.spatial_enhance_fn(mesh, cfg, gates, gamma=GAMMA)
        else:
            mesh = jax_make_mesh(shape=shape, axis_names=("data", "spatial"),
                                 devices=jax.devices()[:4])
            fn, sharding, rep = jax_inference.dp_spatial_enhance_fn(mesh, cfg, gates, gamma=GAMMA)
        args = (jax.device_put(_jax_params(variant), rep), jax.device_put(jnp.asarray(x), sharding))
        return name, np.asarray(fn.lower(*args).compile(compiler_options=FAST_COMPILE)(*args))

    with ThreadPoolExecutor(4) as pool:
        return dict(pool.map(run, JAX_CASES))


# --------------------------------------------------------------------------
# the whole path
# --------------------------------------------------------------------------


def _spatial(model, n, x):
    fn = spatial_enhance_fn(make_mesh(devices=[CPU] * n, axis_names=("spatial",)), model,
                            HVIGates(**GATES), gamma=GAMMA)
    return fn, fn(x)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n", [2, 3, 4])
def test_spatial_matches_the_single_device_forward(models, variant, n):
    model = models[variant]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = _images(0)
    fn, got = _spatial(model, n, x)
    assert got.shape == x.shape and got.dtype == torch.float32 and got.device == CPU
    got = got.numpy()
    np.testing.assert_allclose(got, _single(model, x, n), atol=TOL_SINGLE, rtol=0)
    # a tensor input gives the same; the caller's model is untouched
    np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), got)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("variant,n", [("base", 2), ("mssa", 2), ("mssa", 4), ("tnsm", 2),
                                       ("tnsm", 4)])
def test_spatial_matches_jax(models, jax_ref, variant, n):
    name = next(k for k in jax_ref if k.startswith(f"spatial-{variant}"))
    x = next(case[-1] for case in JAX_CASES if case[0] == name)
    got = _spatial(models[variant], n, x)[1].numpy()
    np.testing.assert_allclose(got, jax_ref[name], atol=TOL_JAX, rtol=0)


@pytest.mark.parametrize("h,n,padded", [(40, 2, 48), (72, 4, 96), (8, 4, 32), (40, 3, 48)])
def test_pad_to_mesh_rule(models, h, n, padded):
    """H pads to a multiple of 8 x shards (reflect, or edge for a sliver
    whose pad is not below H) and W to 8; the call crops back."""
    x = _images(2, h=h, w=44)
    xp = pad_to_mesh(torch.from_numpy(x), n)
    assert xp.shape == (1, padded, 48, 3)
    mode = "reflect" if padded - h < h else "edge"
    np.testing.assert_array_equal(xp.numpy(), np.pad(x, ((0, 0), (0, padded - h), (0, 4), (0, 0)),
                                                     mode=mode))
    fn = spatial_enhance_fn(make_mesh(devices=[CPU] * n), models["base"], HVIGates(**GATES),
                            gamma=GAMMA)
    got = fn(x).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, _single(models["base"], x, n), atol=TOL_SINGLE, rtol=0)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_dp_spatial_matches_jax(models, jax_ref, shape):
    x = _images(1, n=4, h=32)
    mesh = make_mesh(shape, ("data", "spatial"), [CPU] * 4)
    fn = dp_spatial_enhance_fn(mesh, models["base"], HVIGates(**GATES), gamma=GAMMA)
    got = fn(x).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, jax_ref["dp-base-2x2"], atol=TOL_JAX, rtol=0)
    np.testing.assert_allclose(got, _single(models["base"], x, shape[1]), atol=TOL_SINGLE, rtol=0)
    # H = 40 pads to 48 over 2 row shards
    x40 = _images(3, n=2, h=40)
    got = dp_spatial_enhance_fn(make_mesh((2, 2), ("data", "spatial"), [CPU] * 4),
                                models["base"], HVIGates(**GATES), gamma=GAMMA)(x40).numpy()
    np.testing.assert_allclose(got, _single(models["base"], x40, 2), atol=TOL_SINGLE, rtol=0)


def test_dp_spatial_rejects_an_indivisible_batch(models):
    fn = dp_spatial_enhance_fn(make_mesh((2, 2), ("data", "spatial"), [CPU] * 4), models["base"])
    with pytest.raises(ValueError) as ours:
        fn(_images(1, n=3, h=16, w=16))
    mesh = jax_make_mesh(shape=(2, 2), axis_names=("data", "spatial"), devices=jax.devices()[:4])
    jax_fn, _, rep = jax_inference.dp_spatial_enhance_fn(mesh, JaxConfig(**TINY), JaxGates())
    with pytest.raises(ValueError) as ref:  # the body's own check (jit's sharding check precedes it)
        jax_fn.__wrapped__(_jax_params("base"), jnp.asarray(_images(1, n=3, h=16, w=16)))
    assert str(ours.value) == str(ref.value)


def test_spatial_sharding_and_axes():
    mesh = make_mesh((2, 3), ("data", "spatial"), [CPU] * 6)
    assert mesh.axis_size("data") == 2 and mesh.axis_size("spatial") == 3
    want = [slice(0, 16), slice(16, 32), slice(32, 48)] * 2
    assert spatial_sharding(mesh, 48) == want
    assert spatial_sharding(mesh, 48, "data") == [slice(0, 24)] * 3 + [slice(24, 48)] * 3
    with pytest.raises(ValueError, match="not divisible by the 3-way 'spatial' axis"):
        spatial_sharding(mesh, 40)


# --------------------------------------------------------------------------
# each op that reaches across rows, alone
# --------------------------------------------------------------------------


def _on_rows(n, fn, *planes):
    """``on_rows``'s outputs stacked along H, as one tensor or a tuple."""
    outs = on_rows(n, fn, *planes)
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o, dim=-2) for o in zip(*outs))
    return torch.cat(outs, dim=-2)


def _plane(seed, c, h, w=20, b=2):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(b, c, h, w)).astype(np.float32))


# (local rows at level 0, shards): the levels of a padded image, 2-4 shards
LEVELS = [(8, 2), (8, 3), (8, 4), (16, 3)]


@pytest.mark.parametrize("rows0,n", LEVELS)
def test_conv_halos_zero_and_replicate(rows0, n):
    for level in range(4):
        x = _plane(level, 6, rows0 * n >> level)
        w3 = torch.randn(5, 6, 3, 3, generator=torch.Generator().manual_seed(level))
        wd = torch.randn(6, 1, 3, 3, generator=torch.Generator().manual_seed(level + 9))
        for op, wt in ((conv.conv3x3_same, w3), (conv.conv3x3_replpad, w3), (conv.dwconv3x3, wd)):
            got = _on_rows(n, lambda t: op(t, wt), x)
            torch.testing.assert_close(got, op(x, wt), atol=TOL_OP, rtol=0)
        # MSSA's 7x7 gate reads three rows each side, across shards where
        # a shard owns fewer
        sa = SpatialAttention()
        with torch.no_grad():
            sa.conv1.weight.copy_(torch.randn(1, 2, 7, 7, generator=torch.Generator().manual_seed(3)))
            torch.testing.assert_close(_on_rows(n, sa, x), sa(x), atol=TOL_OP, rtol=0)


@pytest.mark.parametrize("rows0,n", LEVELS)
def test_k3_k4_k7_bands_are_the_whole_plane_rows_bitwise(rows0, n):
    """The plain versions on each shard's band (K3: its rows and one below;
    K4: a halo row each side, the global taps, the outer outputs cropped;
    K7: two halo rows each side) give the whole plane's rows, bit for bit,
    at every level."""
    alpha = torch.tensor([0.2])
    w1, w2 = (torch.randn(4, 1, 3, 3, generator=torch.Generator().manual_seed(s)) for s in (1, 2))
    for level in range(4):
        x = _plane(level + 20, 4, rows0 * n >> level)
        if level < 3:
            assert torch.equal(_on_rows(n, lambda t: resize_cuda.half_prelu(t, alpha), x),
                               resize_cuda.half_prelu_plain(x, alpha))
        assert torch.equal(_on_rows(n, resize_cuda.double_bilinear, x),
                           resize_cuda.double_bilinear_plain(x))
        assert torch.equal(_on_rows(n, lambda t: iel_cuda.iel_branch(t, w1, w2), x),
                           iel_cuda.iel_branch_plain(x, w1, w2))


def test_a_wrong_halo_row_is_seen():
    """Planted faults: K4's band for the second of two shards of a 16-row
    plane (its halo row 7 above, none below) gives the whole plane's rows;
    with row 6 in the halo's place it does not. K3 with the band's own taps
    in place of the image's does not either."""
    x = _plane(5, 4, 16)
    whole = resize_cuda.double_bilinear_plain(x)[..., 16:, :]
    taps = resize.band_taps("double", 16, 7, 9, CPU)
    good = resize_cuda.double_bilinear_plain(x[..., 7:16, :], taps)[..., 2:, :]
    wrong = torch.cat([x[..., 6:7, :], x[..., 8:16, :]], dim=-2)
    assert torch.equal(good, whole)
    assert not torch.equal(resize_cuda.double_bilinear_plain(wrong, taps)[..., 2:, :], whole)
    # K3 on the same shard's rows with the band's own taps in place of the
    # whole image's: the align_corners drift shows
    alpha = torch.tensor([0.2])
    whole = resize_cuda.half_prelu_plain(x, alpha)[..., 4:, :]
    band = x[..., 8:, :]
    assert torch.equal(resize_cuda.half_prelu_plain(band, alpha,
                                                    resize.band_taps("half", 16, 4, 4, CPU)), whole)
    assert not torch.equal(resize_cuda.half_prelu_plain(band, alpha), whole)


@pytest.mark.parametrize("normalize_qk", [True, False])
@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("n", [2, 4])
def test_k5_split_plain_matches_the_one_call(normalize_qk, fold, n):
    g = torch.Generator().manual_seed(7)
    b, c, heads, h, w = 2, 16, 4, 8, 12
    q, k, v = (torch.randn(b, c, h, w, generator=g) for _ in range(3))
    k = q + 0.3 * k  # shared structure: a wrong pairing of rows shows
    temp = torch.rand(heads, 1, 1, generator=g) + 0.5
    w_proj = torch.randn(c, c, 1, 1, generator=g) / c ** 0.5 if fold else None
    one = attention.channel_attention(q, k, v, temp, heads, normalize_qk=normalize_qk,
                                      w_proj=w_proj)
    # the split on one shard, and over n shards' partials
    parts = attention.attention_partials(q, k, heads)
    assert parts.shape == (b, 1, c * c // heads + 2 * c)
    whole = attention.attention_from_partials(parts, v, temp, heads, normalize_qk=normalize_qk,
                                              w_proj=w_proj)
    torch.testing.assert_close(whole, one, atol=TOL_K5, rtol=TOL_K5)
    got = _on_rows(n, lambda q_, k_, v_: channel_attention(
        q_, k_, v_, temp, heads, normalize_qk=normalize_qk, w_proj=w_proj), q, k, v)
    torch.testing.assert_close(got, one, atol=TOL_K5, rtol=TOL_K5)
    # a planted fault: one shard's score entries met one column off
    bad = parts.clone()
    bad[:, 0, :c * c // heads] = bad[:, 0, :c * c // heads].roll(1, dims=-1)
    worse = attention.attention_from_partials(bad, v, temp, heads, normalize_qk=normalize_qk,
                                              w_proj=w_proj)
    assert (worse - one).abs().max() > 100 * TOL_K5


@pytest.mark.parametrize("n", [2, 4])
def test_tnsm_pools_over_shards(n):
    dnm = DynamicNoiseMap(16)
    CIDNet.reset_parameters(dnm, torch.Generator().manual_seed(4))
    x = _plane(9, 16, 16)
    torch.testing.assert_close(_on_rows(n, dnm, x), dnm(x), atol=TOL_OP, rtol=0)
    # the pools alone: the sum in rank order, the max exact
    got = _on_rows(n, lambda t: (rows.current().sum(t.sum(dim=(2, 3), keepdim=True)),
                                 rows.current().max(t.amax(dim=(2, 3), keepdim=True))), x)
    torch.testing.assert_close(got[0][..., :1, :], x.sum(dim=(2, 3), keepdim=True), atol=1e-5,
                               rtol=0)
    assert torch.equal(got[1][..., :1, :], x.amax(dim=(2, 3), keepdim=True))
    # the module's own pools, on every shard: the whole plane's
    avg, mx = global_pools(x)
    for r, (a, m) in enumerate(on_rows(n, global_pools, x)):
        torch.testing.assert_close(a, avg, atol=1e-6, rtol=0, msg=f"shard {r}'s mean")
        assert torch.equal(m, mx), f"shard {r}'s max"


def test_halo_rows_across_several_shards():
    """``extend`` takes rows from as many shards as hold them, and pads
    past the image as asked."""
    x = torch.arange(8.0).reshape(1, 1, 8, 1)
    got = _on_rows(4, lambda t: rows.current().extend(t, 3, 3, "zero")[0][None], x)
    bands = got.reshape(4, 8)
    padded = torch.cat([torch.zeros(3), torch.arange(8.0), torch.zeros(3)])
    for r in range(4):
        assert torch.equal(bands[r], padded[2 * r:2 * r + 8])
    edge = _on_rows(4, lambda t: rows.current().extend(t, 3, 0, "replicate")[0][None], x)
    assert torch.equal(edge.reshape(4, 5)[0], torch.tensor([0.0, 0, 0, 0, 1]))
    none = _on_rows(2, lambda t: torch.tensor([[[[rows.current().extend(t, 2, 2)[1]]]]]), x)
    assert none.flatten().tolist() == [0, 2]


# --------------------------------------------------------------------------
# failures, routes
# --------------------------------------------------------------------------


def test_a_failing_shard_raises_and_never_hangs(models, monkeypatch):
    plain = resize_cuda.half_prelu_plain

    def fail_on_rank_1(*a, **kw):
        if rows.current() is not None and rows.current().rank == 1:
            raise RuntimeError("shard 1 fails")
        return plain(*a, **kw)

    monkeypatch.setattr(resize_cuda, "half_prelu_plain", fail_on_rank_1)
    fn = spatial_enhance_fn(make_mesh(devices=[CPU] * 3), models["base"])
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="shard 1 fails"):
        fn(_images(0))
    assert time.perf_counter() - t0 < 10
    assert not [t for t in threading.enumerate() if t.name.startswith("row-shard")]


def test_a_stalled_shard_times_out(monkeypatch):
    monkeypatch.setattr(rows, "TIMEOUT", 0.5)
    group = rows.RowGroup([CPU] * 2)

    def shard(s):
        if s.rank == 1:
            time.sleep(1.5)
        return s.sum(torch.ones(1))

    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="row group"):
        rows.run_groups([group], shard)
    assert time.perf_counter() - t0 < 1.4
    # the stalled rank wakes, meets the broken barrier and ends
    stray = [t for t in threading.enumerate() if t.name.startswith("row-shard")]
    for t in stray:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in stray)


def test_exchanges_under_a_short_switch_interval():
    """Twelve shards (more than the host's cores) through 300 exchanges
    each, the interpreter switching threads every 10 us: every rank sees
    every rank's value of the same turn (a slot overwritten before it was
    read would show)."""
    n, turns = 12, 300
    group = rows.RowGroup([CPU] * n)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        seen = rows.run_groups([group], lambda s: [group.exchange(s.rank, (t, s.rank))
                                                   for t in range(turns)])[0]
    finally:
        sys.setswitchinterval(interval)
    want = [[(t, r) for r in range(n)] for t in range(turns)]
    assert all(got == want for got in seen)


def test_routes_hwcb_and_training_raise_in_a_row_group(models, monkeypatch):
    fn = spatial_enhance_fn(make_mesh(devices=[CPU] * 2), models["base"])
    monkeypatch.setenv("HVI_TORCH_LN_IEL", "1")
    with pytest.raises(ValueError, match="HVI_TORCH_LN_IEL"):
        fn(_images(0))
    monkeypatch.delenv("HVI_TORCH_LN_IEL")
    x = torch.from_numpy(_images(0, h=16))
    for kw, match in ((dict(training=True), "training"), (dict(input_layout="hwcb"), "NHWC"),
                      (dict(routes=routes.PROBE), "HVI_TORCH_HEAD_ATTN")):
        with pytest.raises(ValueError, match=match):
            rows.run_groups([rows.RowGroup([CPU] * 2)],
                            lambda s: cidnet_forward(models["tnsm"], x, **kw))
    assert rows.current() is None


# --------------------------------------------------------------------------
# demo --spatial
# --------------------------------------------------------------------------


def test_demo_spatial(tmp_path, monkeypatch, capsys):
    img = (np.random.default_rng(4).uniform(0, 0.5, (32, 40, 3)) * 255).astype(np.uint8)
    src = tmp_path / "in.png"
    png.write(str(src), img)
    argv = ["--cpu", "--random_init", "--input", str(src)]
    plain = png.read(demo.main(argv + ["--output_dir", str(tmp_path / "a")]))
    # one device (--cpu): no effect
    same = png.read(demo.main(argv + ["--spatial", "--output_dir", str(tmp_path / "b")]))
    assert np.array_equal(same, plain) and "spatial serving" not in capsys.readouterr().out
    # several: the rows over all of them, within one uint8 level
    monkeypatch.setattr(demo, "spatial_devices", lambda args: [CPU] * 2)
    out = png.read(demo.main(argv + ["--spatial", "--output_dir", str(tmp_path / "c")]))
    assert "spatial serving: rows sharded over 2 devices" in capsys.readouterr().out
    assert np.abs(out.astype(int) - plain.astype(int)).max() <= 1
    for flag in ("--fused", "--probe"):
        with pytest.raises(SystemExit):
            demo.parse_args(argv + ["--spatial", flag])
