"""The port's multi-process training (``parallel/multihost.py``,
``train_step(group=)``, ``broadcast_state_``, ``train/async_ckpt.py`` and
``cli/train.py --multihost``) on the CPU, with gloo.

* The data-parallel step: two processes (``spawn_local``) take one step of
  the tiny CIDNet (fp32, the clip on, batch 8, 4 rows a rank) with
  ``grad_accum`` 1 and 2. The ranks' parameters and losses are bitwise
  equal, and held to the JAX ``make_train_step(mesh=)`` step on a 2-device
  mesh from the same init and batch in units of lr (LR_BARS, as
  ``test_torch_train.py`` holds the single-device step), the loss within
  TOL_LOSS relative. One JAX program (``grad_accum`` 1) is compiled: the
  accumulated step is the full batch's up to rounding (every loss term is
  a batch mean), and a second compile would cost ~30 s. The microbatch
  error carries the JAX text (the JAX ``grad_accum`` 2 step raises it while
  tracing).
* The CLI, mirroring ``tests/test_multihost_cli.py``: ``cli/train.py --cpu
  --multihost true`` as two processes (full width, crop 32, global batch 8,
  2 epochs of 2 steps, ``--ckpt_backend orbax --ckpt_keep 1``) against
  the same command in one process: the printed per-epoch losses are
  equal, the final parameters within LR_BARS, the two ranks' state digests
  equal to each other and to the file rank 0 wrote in the background (the
  only one kept), which the JAX ``load_checkpoint`` reads. Two more ranks
  resume ``--start_epoch 2`` from an ``epoch_2.npz`` (another seed's model
  after one step) that only rank 0's working directory holds: both report
  the file's state.
* Unit cases: the seed requirement, one process per card, a failing rank
  failing ``spawn_local``, the backend rule, the launch errors, and
  ``AsyncCheckpoints`` (bitwise the
  synchronous ``.npz``, retention, the latest epoch restored).

Subprocesses run with OMP_NUM_THREADS=1; the JAX program compiles while
the ranks train.
"""

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvi_cidnet_tpu.models.cidnet import CIDNetConfig as JaxConfig
from hvi_cidnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hvi_cidnet_tpu.train import checkpoint as jax_ckpt
from hvi_cidnet_tpu.train import trainer as jt
from hvi_cidnet_torch.cli import train
from hvi_cidnet_torch.compat.jax_params import torch_to_jax_params
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig
from hvi_cidnet_torch.parallel import multihost
from hvi_cidnet_torch.parallel.multihost import ProcessInfo, choose_backend, free_port, spawn_local
from hvi_cidnet_torch.train import checkpoint as ckpt
from hvi_cidnet_torch.train import trainer as pt
from hvi_cidnet_torch.train.async_ckpt import AsyncCheckpoints
from _torch_port import dp_step_rank, failing_rank, one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
LR = 1e-3
TOL_LOSS = 1e-5  # relative, the loss of one step against the JAX mesh step's
# parameters after steps of two runs, in units of lr (test_torch_train.py's)
LR_BARS = {"mean": 1e-3, "share_past_0.1": 1e-2, "max_per_step": 2.0}
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
CLI = ["--cpu", "--synthetic_steps", "2", "--nEpochs", "2", "--snapshots", "1", "--batchSize",
       "8", "--cropSize", "32", "--threads", "2", "--seed", "1", "--start_warmup", "false",
       "--compute_dtype", "float32", "--allow_random_vgg", "true", "--variant", "base"]
SEED_TEXT = ("multihost training requires an explicit --seed: every process must draw the "
             "same global batch order and augmentation stream")


def _batch(seed, n=8, hw=32):
    rng = np.random.default_rng(seed)
    low = rng.uniform(0, 0.3, (n, hw, hw, 3)).astype(np.float32)
    high = np.clip(low * 3 + rng.normal(0, 0.05, low.shape), 0, 1).astype(np.float32)
    return low, high


def _lr_units(got: dict, ref: dict, steps: int) -> None:
    diff = np.concatenate([np.abs(got[k] - ref[k]).ravel() for k in ref]) / LR
    assert diff.mean() <= LR_BARS["mean"], diff.mean()
    assert (diff > 0.1).mean() <= LR_BARS["share_past_0.1"], (diff > 0.1).mean()
    assert diff.max() <= LR_BARS["max_per_step"] * steps, diff.max()


def _jax_cfg(accum):
    return jt.TrainConfig(model=JaxConfig(**TINY), compute_dtype="float32", lr=LR,
                          use_perceptual=False, grad_clip_mode="clip", grad_accum=accum)


def _jax_params():
    model = CIDNet(CIDNetConfig(**TINY), generator=torch.Generator().manual_seed(0))
    return {k: jnp.asarray(v) for k, v in torch_to_jax_params(model.state_dict()).items()}


def _jax_mesh_step(batch):
    """One JAX ``make_train_step(mesh=)`` step on a 2-device mesh: (params,
    loss)."""
    cfg = _jax_cfg(1)
    opt = jt.make_optimizer(cfg)
    step = jt.make_train_step(cfg, opt, mesh=jax_make_mesh(devices=jax.devices()[:2]))
    params = _jax_params()
    args = (jnp.asarray(batch[0]), jnp.asarray(batch[1]), np.float32(1.0), None)
    compiled = step.lower(params, opt.init(params), *args).compile(compiler_options=FAST_COMPILE)
    new, _, loss, _ = compiled(params, opt.init(params), *args)
    return {k: np.array(v) for k, v in new.items()}, float(loss)


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        env.pop(key, None)
    return env


def _ranks(argv, dirs):
    """Start ``cli/train.py --multihost true`` as one process per working
    directory, on a fresh port."""
    port = free_port()
    procs = []
    for rank, d in enumerate(dirs):
        os.makedirs(d, exist_ok=True)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "hvi_cidnet_torch.cli.train", *argv, "--multihost", "true",
             "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", str(len(dirs)),
             "--process_id", str(rank)],
            cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env()))
    return procs


def _finish(procs) -> list:
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append(out)
            assert p.returncode == 0, out + err
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _losses(text: str) -> list:
    return re.findall(r"Loss: ([0-9.]+)", text)


def _digests(text: str, what: str) -> list:
    return re.findall(rf"rank \d+: {what}.*state sha256 ([0-9a-f]+)", text)


def _without(argv: list, flag: str) -> list:
    i = argv.index(flag)
    return argv[:i] + argv[i + 2:]


def _file_digest(path: str) -> str:
    model = CIDNet(CIDNetConfig(variant="base"))
    opt = pt.make_optimizer(model, pt.TrainConfig(model=model.config))
    ckpt.load_checkpoint(path, model, opt)
    return ckpt.state_digest(model, opt)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything that runs processes or compiles, overlapped: the CLI's two
    ranks, the resume's two ranks, the two-rank step, the JAX mesh step and
    the CLI's single process."""
    root = tmp_path_factory.mktemp("multihost")
    model, opt = _stepped(5, CIDNetConfig(variant="base"))
    ckpt.save_checkpoint(str(root / "resume0/weights/train/epoch_2.npz"), model, opt, epoch=2)
    cli_ranks = _ranks(CLI + ["--ckpt_backend", "orbax", "--ckpt_keep", "1"],
                       [root / "rank0", root / "rank1"])
    resume_ranks = _ranks(CLI + ["--start_epoch", "2", "--nEpochs", "1"],
                          [root / "resume0", root / "resume1"])
    batch = _batch(0)
    step_dir = root / "step"
    step_dir.mkdir()
    with ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(spawn_local, 2, dp_step_rank, str(step_dir), batch, (1, 2), LR)
        jax_step = pool.submit(_jax_mesh_step, batch)
        with pytest.MonkeyPatch.context() as mp:
            (root / "single").mkdir()
            mp.chdir(root / "single")
            single = train.main(CLI)
        ranks.result()
        jax_step = jax_step.result()
    return dict(root=root, step_dir=step_dir, jax=jax_step, single=single,
                cli=_finish(cli_ranks), resume=_finish(resume_ranks))


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_step_matches_the_jax_mesh_step(runs, accum):
    ranks = [dict(np.load(runs["step_dir"] / f"accum{accum}_rank{r}.npz")) for r in (0, 1)]
    assert set(ranks[0]) == set(ranks[1])
    assert all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0])  # bitwise
    ref, ref_loss = runs["jax"]
    loss = float(ranks[0].pop("loss"))
    assert abs(loss - ref_loss) <= TOL_LOSS * abs(ref_loss)
    _lr_units(ranks[0], ref, steps=1)


def test_dp_step_microbatch_error_is_the_jax_text(runs):
    errors = {(runs["step_dir"] / f"error_rank{r}.txt").read_text() for r in (0, 1)}
    assert len(errors) == 1
    cfg = _jax_cfg(2)
    step = jt.make_train_step(cfg, jt.make_optimizer(cfg),
                              mesh=jax_make_mesh(devices=jax.devices()[:2]))
    params = _jax_params()
    low, high = (jnp.asarray(a[:6]) for a in _batch(0))
    with pytest.raises(ValueError) as ref:  # raised while tracing
        step(params, jt.make_optimizer(cfg).init(params), low, high, np.float32(1.0), None)
    head = str(ref.value).split(" must be divisible by the 2-")[0]
    assert head == "microbatch 3 (batch 6 / grad_accum 2)"
    assert errors.pop().startswith(head + " must be divisible by the 2-process group")


def test_cli_two_ranks_match_one_process(runs):
    single = runs["single"]
    rank0, rank1 = runs["cli"]
    want = [f"{sum(ep) / len(ep):.4f}" for ep in single["losses"]]
    assert _losses(rank0) == want and _losses(rank1) == []  # rank 0 logs
    digests = _digests(rank0, "") + _digests(rank1, "")
    assert len(digests) == 2 and digests[0] == digests[1]
    # rank 0 wrote the background checkpoints, keeping the newest only
    orbax = runs["root"] / "rank0/weights/train/orbax"
    assert sorted(os.listdir(orbax)) == ["2"]
    assert not (runs["root"] / "rank1/weights").exists()
    path = str(orbax / "2/checkpoint.npz")
    assert _file_digest(path) == digests[0]
    got, _, epoch = jax_ckpt.load_checkpoint(path)
    assert epoch == 2
    ref = dict(np.load(runs["root"] / "single/weights/train/epoch_2.npz"))
    ref = {k[len("param::"):]: v for k, v in ref.items() if k.startswith("param::")}
    _lr_units({k: np.asarray(v) for k, v in got.items()}, ref, steps=4)


def test_resume_is_broadcast_to_a_rank_without_the_file(runs):
    path = runs["root"] / "resume0/weights/train/epoch_2.npz"
    assert _file_digest(str(path)) != _digests(runs["cli"][0], "")[0]
    assert not (runs["root"] / "resume1/weights/train/epoch_2.npz").exists()
    resumed = [_digests(text, "resumed from") for text in runs["resume"]]
    assert resumed[0] == resumed[1] == [_file_digest(str(path))]
    assert "Epoch[3]" in runs["resume"][0]


def test_multihost_requires_a_seed(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(train, "initialize_distributed", lambda **kw: ProcessInfo(
        0, 2, 0, "gloo", torch.device("cpu"), created=False))
    argv = _without(CLI, "--seed") + ["--multihost", "true"]
    with pytest.raises(SystemExit, match=re.escape(SEED_TEXT)):
        train.main(argv)


def test_one_process_per_card(tmp_path, monkeypatch):
    """From the command line (``launch``), without --multihost and --cpu, a
    machine with two cards trains in two processes, each with the same
    seed (drawn once, here); ``main`` itself, and ``launch`` with
    --multihost or --cpu, train in the calling process."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    calls, mains = [], []
    monkeypatch.setattr(train, "spawn_local", lambda *a: calls.append(a))
    argv = _without(CLI[1:], "--seed")
    assert train.launch(argv) is None
    (n, fn, args), = calls
    assert n == 2 and fn is train._rank_main
    assert args[:-4] == argv and args[-4:-1] == ["--multihost", "true", "--seed"]
    assert int(args[-1]) > 0
    assert not os.path.exists("weights")
    monkeypatch.setattr(train, "main", lambda a: mains.append(a) or {"losses": []})
    for extra in (["--multihost", "true"], ["--cpu"]):
        assert train.launch(argv + extra) == {"losses": []}
    assert mains == [argv + ["--multihost", "true"], argv + ["--cpu"]] and len(calls) == 1


def test_one_process_a_host_with_several_cards_raises(monkeypatch):
    """``--multihost`` with a coordinator on another host and no torchrun
    environment means one process on this host: with two cards visible it
    would leave one idle, so it raises before joining any group."""
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def no_group(*a, **kw):
        raise AssertionError("init_process_group must not be reached")

    monkeypatch.setattr(multihost.dist, "init_process_group", no_group)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        multihost.initialize_distributed(coordinator_address="192.0.2.1:1234",
                                         num_processes=2, process_id=0)


def test_a_failing_rank_fails_the_launcher():
    with pytest.raises(Exception, match="rank 1 fails"):
        spawn_local(2, failing_rank)


@pytest.mark.parametrize("local,cards,cpu,want", [
    (1, 1, False, "nccl"), (2, 2, False, "nccl"), (2, 1, False, "gloo"),
    (1, 0, False, "gloo"), (2, 2, True, "gloo"), (4, 8, False, "nccl")])
def test_backend_rule(local, cards, cpu, want):
    assert choose_backend(local, cards, cpu) == want


@pytest.mark.parametrize("kw,env,match", [
    ({}, {}, "no coordinator"),
    ({"coordinator_address": "127.0.0.1:1"}, {}, "--num_processes and --process_id"),
    ({}, {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1", "WORLD_SIZE": "2"},
     "--num_processes and --process_id"),
    ({"coordinator_address": "127.0.0.1:1", "num_processes": 2, "process_id": 2}, {},
     r"process id 2 is not in \[0, 2\)"),
])
def test_launch_errors_are_clear(monkeypatch, kw, env, match):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match=match):
        multihost.initialize_distributed(cpu=True, **kw)


def _stepped(seed, config=CIDNetConfig(**TINY)):
    """A CIDNet (the tiny one by default) and its Adam after one step."""
    cfg = pt.TrainConfig(model=config, lr=LR, compute_dtype="float32", use_perceptual=False)
    model = CIDNet(cfg.model, generator=torch.Generator().manual_seed(seed))
    opt = pt.make_optimizer(model, cfg)
    low, high = (torch.from_numpy(a) for a in _batch(seed, n=2, hw=16))
    pt.train_step(model, opt, low, high, 1.0, None, cfg)
    return model, opt


def test_async_checkpoints_write_the_synchronous_npz(tmp_path):
    model, opt = _stepped(3)
    ckpt.save_checkpoint(str(tmp_path / "sync.npz"), model, opt, epoch=3)
    with AsyncCheckpoints(str(tmp_path / "ck"), max_to_keep=2) as ck:
        assert ck.latest_epoch() == 0
        for epoch in (1, 2, 3):
            ck.save(epoch, model, opt)
        ck.wait()
        assert ck.epochs() == [2, 3] and sorted(os.listdir(tmp_path / "ck")) == ["2", "3"]
        sync, written = np.load(tmp_path / "sync.npz"), np.load(ck.path(3))
        assert sorted(sync.files) == sorted(written.files)
        assert all(np.array_equal(sync[k], written[k]) for k in sync.files)
        fresh = CIDNet(CIDNetConfig(**TINY))
        fresh_opt = pt.make_optimizer(fresh, pt.TrainConfig(model=fresh.config))
        assert ck.restore(None, fresh, fresh_opt) == 3
    assert ckpt.state_digest(fresh, fresh_opt) == ckpt.state_digest(model, opt)
    params, _, epoch = jax_ckpt.load_checkpoint(str(tmp_path / "ck/3/checkpoint.npz"))
    ref = torch_to_jax_params(model.state_dict())
    assert epoch == 3 and all(np.array_equal(np.asarray(params[k]), ref[k]) for k in ref)
    with pytest.raises(FileNotFoundError):
        AsyncCheckpoints(str(tmp_path / "none")).restore(None, fresh, fresh_opt)
