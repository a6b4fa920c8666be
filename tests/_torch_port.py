"""Shared by the PyTorch port's CPU tests (``tests/test_torch_*.py``).

``run_jax_cli``: one of the JAX package's ``cli/*.py`` run in this process
as ``python cli/<script> argv`` runs it (several parse their flags at
import), for the port's CLIs to be held to.

``on_rows``: a function run on the row blocks of its inputs in a row group
(the spatial tests, on the CPU and on the card).

``one_torch_thread``: an autouse module fixture (import it into a test
module) that runs the module's torch CPU ops on one intra-op thread and
restores the count after. The port's tests run tiny shapes, where torch's
OpenMP pool buys nothing; with several pytest-xdist workers on one host,
every worker's pool of one thread per core spins in each parallel region,
and the oversubscribed host ran the port's files about 8x slower.
"""

import runpy
import sys
from pathlib import Path

import pytest
import torch

JAX_CLI = Path(__file__).resolve().parents[1] / "cli"


def run_jax_cli(script: str, argv: list) -> None:
    saved = sys.argv
    sys.argv = [script, *argv]
    try:
        runpy.run_path(str(JAX_CLI / script), run_name="__main__")
    finally:
        sys.argv = saved


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def on_rows(n: int, fn, *planes) -> list:
    """``fn`` on each of ``n`` row blocks of the NCHW ``planes`` (each shard
    its contiguous block of every plane, rows on dim -2) in a row group on
    the planes' device, repeated (``parallel/rows.py``); the shards'
    outputs in rank order."""
    from hvi_cidnet_torch.parallel import rows

    group = rows.RowGroup([planes[0].device] * n)
    per = planes[0].shape[-2] // n

    def shard(s):
        with torch.no_grad():
            return fn(*(p[..., s.rank * per:(s.rank + 1) * per, :].contiguous() for p in planes))

    return rows.run_groups([group], shard)[0]


def dp_step_rank(rank: int, out_dir: str, batch: tuple, accums: tuple, lr: float) -> None:
    """One rank of the two-process data-parallel step test
    (``tests/test_torch_multihost.py``), started by ``spawn_local``: joins
    the group from torchrun's environment (gloo on the CPU), takes one
    ``train_step(group=)`` per ``grad_accum`` in ``accums`` on its rows of
    ``batch`` (the tiny CIDNet, fp32, the clip on), and writes its
    parameters (JAX layout) and loss to ``out_dir``; then checks the
    microbatch error. Imports torch and the port only."""
    import numpy as np
    import torch.distributed as dist

    from hvi_cidnet_torch.compat.jax_params import torch_to_jax_params
    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig
    from hvi_cidnet_torch.parallel.multihost import initialize_distributed, process_local_slice
    from hvi_cidnet_torch.train import trainer as pt

    torch.set_num_threads(1)
    info = initialize_distributed(cpu=True)
    try:
        for accum in accums:
            cfg = pt.TrainConfig(model=CIDNetConfig(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8)),
                                 lr=lr, compute_dtype="float32", use_perceptual=False,
                                 grad_clip_mode="clip", grad_accum=accum)
            model = CIDNet(cfg.model, generator=torch.Generator().manual_seed(0))
            opt = pt.make_optimizer(model, cfg)
            low, high = batch
            rows = process_local_slice(low.shape[0])
            loss, _ = pt.train_step(model, opt, torch.from_numpy(low[rows]),
                                    torch.from_numpy(high[rows]), 1.0, None, cfg,
                                    group=dist.group.WORLD)
            params = torch_to_jax_params(model.state_dict())
            np.savez(f"{out_dir}/accum{accum}_rank{info.rank}.npz", loss=loss.item(), **params)
        try:
            pt.train_step(model, opt, torch.from_numpy(low[:3]), torch.from_numpy(high[:3]), 1.0,
                          None, cfg, group=dist.group.WORLD)
            error = ""
        except ValueError as e:
            error = str(e)
        with open(f"{out_dir}/error_rank{info.rank}.txt", "w") as f:
            f.write(error)
    finally:
        dist.destroy_process_group()


def failing_rank(rank: int) -> None:
    """A ``spawn_local`` target whose rank 1 fails."""
    if rank == 1:
        raise ValueError("rank 1 fails")
