"""The port's data-parallel serving and its helpers (``parallel/mesh.py``,
``parallel/inference.py``, ``Evaluator(mesh=)``, the loaders'
process-sharded arm) vs the JAX package's (CPU, fp32).

* Mesh helpers: ``make_mesh``, ``batch_slices`` and ``replicate`` unit
  cases; ``process_local_slice`` equals the JAX one on a grid of (global
  batch, process count, index), its ``ValueError`` included.
* DP serving: ``dp_enhance_fn`` on ``make_mesh(devices=[cpu] * 2)`` and
  ``[cpu] * 4`` at batch 8, tiny widths, base / MSSA / TNSM, gamma and the
  gates on, within TOL_JAX (the JAX package's own bar,
  ``tests/test_parallel_inference.py``) of the JAX ``dp_enhance_fn`` on the
  8-device mesh, and bitwise the port's single-device forward of each
  replica's rows (each replica runs that forward on its block). An
  indivisible batch raises with the JAX text.
* DP eval: ``Evaluator(mesh=)``'s ``run_dataset`` on a folder of 5 images
  (a tail padded to the mesh by repeated rows) writes the PNGs the JAX
  ``Evaluator(mesh=)`` writes (the model of ``test_parallel_inference.py``),
  each within one uint8 level (truncation at a level's boundary), with
  MIN_EQUAL of the values equal.
* The loaders: ``eval_batches`` is bitwise the JAX one; ``TrainLoader(
  batch_rows=)`` is bitwise the JAX ``TrainLoader(batch_rows=,
  device_put=False)``, and the ranks' slices put together are the full
  batch.
* The launch counters stay exact when replicas launch from many threads.
"""

import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hvi_cidnet_tpu.data import datasets as jds
from hvi_cidnet_tpu.data.pipeline import TrainLoader as JaxLoader
from hvi_cidnet_tpu.data.pipeline import eval_batches as jax_eval_batches
from hvi_cidnet_tpu.eval.evaluator import Evaluator as JaxEvaluator
from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.models.cidnet import HVIGates as JaxGates
from hvi_cidnet_tpu.parallel import inference as jax_inference
from hvi_cidnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hvi_cidnet_tpu.parallel.multihost import process_local_slice as jax_local_slice
from hvi_cidnet_torch.compat.jax_params import torch_to_jax_params
from hvi_cidnet_torch.data import datasets as ds
from hvi_cidnet_torch.data import png
from hvi_cidnet_torch.data.pipeline import TrainLoader, eval_batches
from hvi_cidnet_torch.eval.evaluator import Evaluator
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, HVIGates, cidnet_forward
from hvi_cidnet_torch.ops import _build
from hvi_cidnet_torch.parallel.inference import dp_enhance_fn
from hvi_cidnet_torch.parallel.mesh import batch_slices, make_mesh, replicate
from hvi_cidnet_torch.parallel.multihost import MultiHostTrainLoader, process_local_slice
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
VARIANTS = ("base", "mssa", "tnsm")
TOL_JAX = 2e-5      # port DP vs JAX DP, fp32 (the JAX package's bar against torch)
MIN_EQUAL = 0.999   # share of PNG values equal, DP eval vs the JAX DP eval
GAMMA = 0.8
GATES = dict(gated2=True, alpha=0.9)
CPU = torch.device("cpu")


def _model(variant, seed=0):
    return CIDNet(CIDNetConfig(variant=variant, **TINY),
                  generator=torch.Generator().manual_seed(seed))


def _jax_params(model):
    return {k: jnp.asarray(v) for k, v in torch_to_jax_params(model.state_dict()).items()}


def _images(seed, n=8, h=32, w=48):
    return np.random.default_rng(seed).uniform(0, 1, (n, h, w, 3)).astype(np.float32)


# --------------------------------------------------------------------------
# mesh helpers
# --------------------------------------------------------------------------


def test_make_mesh_shapes_and_devices(monkeypatch):
    mesh = make_mesh(devices=[CPU] * 2)
    assert (mesh.devices, mesh.shape, mesh.axis_names, mesh.size) == ((CPU, CPU), (2,), ("data",), 2)
    two_d = make_mesh(axis_names=("data", "spatial"), devices=["cpu"] * 4)
    assert two_d.shape == (4, 1) and two_d.devices == (CPU,) * 4
    assert make_mesh((2, 2), ("data", "spatial"), [CPU] * 4).shape == (2, 2)
    with pytest.raises(ValueError, match="does not hold 4 devices"):
        make_mesh((3,), devices=[CPU] * 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_batch_slices_and_replicate():
    mesh = make_mesh(devices=[CPU] * 4)
    assert batch_slices(mesh, 8) == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="not divisible by the 4-device mesh"):
        batch_slices(mesh, 6)
    model = _model("base")
    copies = replicate(model, mesh)
    assert len(copies) == 4 and len({id(c) for c in copies} | {id(model)}) == 5
    for c in copies:
        assert all(a is not b and torch.equal(a, b)
                   for a, b in zip(c.parameters(), model.parameters()))
    with torch.no_grad():
        copies[0].trans.density_k.add_(1.0)
    assert not torch.equal(copies[0].trans.density_k, model.trans.density_k)


@pytest.mark.parametrize("global_batch,count", [(8, 1), (8, 2), (8, 4), (16, 8), (6, 3), (8, 3)])
def test_process_local_slice_is_the_jax_one(global_batch, count):
    for index in range(count):
        kw = dict(process_index=index, process_count=count)
        if global_batch % count:
            with pytest.raises(ValueError) as ours:
                process_local_slice(global_batch, **kw)
            with pytest.raises(ValueError) as ref:
                jax_local_slice(global_batch, **kw)
            assert str(ours.value) == str(ref.value)
        else:
            assert process_local_slice(global_batch, **kw) == jax_local_slice(global_batch, **kw)
    assert process_local_slice(8) == slice(0, 8)  # no process group: one process


# --------------------------------------------------------------------------
# DP serving
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_dp():
    """variant -> the JAX ``dp_enhance_fn`` output on the 8-device mesh,
    the three programs compiled at once."""
    mesh = jax_make_mesh(axis_names=("data",))
    x = jnp.asarray(_images(0))
    gates = JaxGates(**GATES)

    def run(variant):
        fn, bs, rep = jax_inference.dp_enhance_fn(mesh, JaxConfig(variant=variant, **TINY),
                                                  gates, gamma=GAMMA)
        params = jax.device_put(_jax_params(_model(variant)), rep)
        return np.asarray(fn(params, jax.device_put(x, bs)))

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(zip(VARIANTS, pool.map(run, VARIANTS)))


def _single(model, x):
    """The port's single-device serving forward of ``x``."""
    with torch.no_grad():
        out = cidnet_forward(model, torch.from_numpy(x) ** GAMMA, HVIGates(**GATES))
    if model.config.variant == "tnsm":
        out = out[0]
    return out.float().clamp(0, 1).numpy()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n", [2, 4])
def test_dp_enhance_matches_jax_and_the_single_device_forward(jax_dp, variant, n):
    model = _model(variant)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = _images(0)
    fn = dp_enhance_fn(make_mesh(devices=[CPU] * n), model, HVIGates(**GATES), gamma=GAMMA)
    got = fn(x).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_dp[variant], atol=TOL_JAX, rtol=0)
    per = 8 // n
    single = np.concatenate([_single(model, x[i:i + per]) for i in range(0, 8, per)])
    np.testing.assert_array_equal(got, single)
    # a tensor input gives the same rows; the caller's model is untouched
    np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), got)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_dp_enhance_rejects_an_indivisible_batch():
    """The JAX text, raised before any replica runs."""
    fn = dp_enhance_fn(make_mesh(devices=[CPU] * 4), _model("base"))
    with pytest.raises(ValueError) as ours:
        fn(_images(1, n=5, h=16, w=16))
    jax_fn, _, rep = jax_inference.dp_enhance_fn(jax_make_mesh(devices=jax.devices()[:4]),
                                                 JaxConfig(**TINY), JaxGates())
    with pytest.raises(ValueError) as ref:
        jax_fn(jax.device_put(_jax_params(_model("base")), rep), jnp.asarray(_images(1, 5, 16, 16)))
    assert str(ours.value) == str(ref.value)


# --------------------------------------------------------------------------
# DP eval
# --------------------------------------------------------------------------


def test_evaluator_mesh_writes_what_the_jax_mesh_evaluator_writes(tmp_path):
    rng = np.random.default_rng(4)
    low = tmp_path / "low"
    low.mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (24, 32, 3)).astype(np.uint8)).save(low / f"{i}.png")
    model = _model("base", seed=7)
    ref = JaxEvaluator(_jax_params(model), JaxConfig(**TINY), JaxGates(),
                       mesh=jax_make_mesh(axis_names=("data",)))
    assert ref.run_dataset(jds.EvalDataset(str(low)), str(tmp_path / "jax"), verbose=False) == 5
    ours = Evaluator(model, None, HVIGates(), device="cpu", mesh=make_mesh(devices=[CPU] * 4))
    assert ours.mesh.size == 4
    assert ours.run_dataset(ds.EvalDataset(str(low)), str(tmp_path / "port"), verbose=False) == 5
    equal = total = 0
    for i in range(5):
        got = png.read(str(tmp_path / "port" / f"{i}.png")).astype(np.int16)
        want = np.asarray(Image.open(tmp_path / "jax" / f"{i}.png")).astype(np.int16)
        assert got.shape == want.shape == (24, 32, 3)
        assert np.abs(got - want).max() <= 1
        equal, total = equal + (got == want).sum(), total + got.size
    assert equal / total >= MIN_EQUAL, equal / total
    # a one-device mesh is the single-device path
    assert Evaluator(_model("base"), None, device="cpu", mesh=make_mesh(devices=[CPU])).mesh is None


# --------------------------------------------------------------------------
# the loaders
# --------------------------------------------------------------------------


def _pairs(root, n, size=(40, 52)):
    rng = np.random.default_rng(0)
    for d in ("low", "high"):
        os.makedirs(f"{root}/{d}")
    for i in range(n):
        img = rng.integers(0, 256, (*size, 3)).astype(np.uint8)
        Image.fromarray(img // 3).save(f"{root}/low/{i:03d}.png")
        Image.fromarray(img).save(f"{root}/high/{i:03d}.png")


def test_eval_batches_are_the_jax_ones(tmp_path):
    rng = np.random.default_rng(2)
    for i, (h, w) in enumerate([(16, 24), (13, 21), (30, 8)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(tmp_path / f"{i}.png")
    for pad in (False, True):
        ours = list(eval_batches(ds.EvalDataset(str(tmp_path), pad=pad)))
        on_cpu = list(eval_batches(ds.EvalDataset(str(tmp_path), pad=pad), device="cpu"))
        ref = list(jax_eval_batches(jds.EvalDataset(str(tmp_path), pad=pad)))
        assert len(ours) == len(ref) == 3
        for (x, name, h, w), (t, *rest), (rx, *want) in zip(ours, on_cpu, ref):
            assert [name, h, w] == want == rest and x.dtype == np.float32
            assert np.array_equal(x, np.asarray(rx)) and torch.equal(t, torch.from_numpy(x))


def test_train_loader_rows_are_the_jax_ones(tmp_path):
    _pairs(tmp_path, 16)
    port_ds = ds.PairedFolderDataset(f"{tmp_path}/low", f"{tmp_path}/high", crop_size=16)
    jax_ds = jds.PairedFolderDataset(f"{tmp_path}/low", f"{tmp_path}/high", crop_size=16)
    full = TrainLoader(port_ds, 8, seed=7, num_threads=2)
    full_batches = list(full.epoch())
    full.close()
    parts = []
    for p in range(4):
        rows = process_local_slice(8, process_index=p, process_count=4)
        ours = TrainLoader(port_ds, 8, seed=7, num_threads=2, batch_rows=rows)
        ref = JaxLoader(jax_ds, 8, seed=7, num_threads=2, device_put=False, batch_rows=rows)
        multi = MultiHostTrainLoader(port_ds, 8, seed=7, num_threads=2, device="cpu",
                                     process_index=p, process_count=4)
        assert multi.local == rows and multi.steps_per_epoch == 2
        got, want, tensors = list(ours.epoch()), list(ref.epoch()), list(multi.epoch())
        for loader in (ours, ref, multi):
            loader.close()
        assert len(got) == len(want) == len(tensors) == 2
        for (lo, hi), (rlo, rhi), (tlo, thi) in zip(got, want, tensors):
            assert lo.shape == (2, 16, 16, 3)
            assert np.array_equal(lo, rlo) and np.array_equal(hi, rhi)
            assert torch.equal(tlo, torch.from_numpy(lo)) and torch.equal(thi, torch.from_numpy(hi))
        parts.append(got)
    for step, (lo, hi) in enumerate(full_batches):
        assert np.array_equal(np.concatenate([p[step][0] for p in parts]), lo)
        assert np.array_equal(np.concatenate([p[step][1] for p in parts]), hi)


# --------------------------------------------------------------------------
# launch counters under threads
# --------------------------------------------------------------------------


def test_launch_counts_are_exact_under_threads(monkeypatch):
    """Replicas launch from one host thread each: 16 threads x 2000 launches
    of one kernel, with a short switch interval, count exactly."""
    kernel = _build.CudaKernel("stress", [])
    kernel._fn = lambda *args: 0
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    device = torch.device("cuda", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernel(device) for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernel.launches == 16 * 2000
