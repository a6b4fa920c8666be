"""Shared by the PyTorch port's CPU tests (``tests/test_torch_*.py``).

``run_jax_cli``: one of the JAX package's ``cli/*.py`` run in this process
as ``python cli/<script> argv`` runs it (several parse their flags at
import), for the port's CLIs to be held to.

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
