"""Multi-process data-parallel training on ``torch.distributed``.

Counterpart of ``hvi_cidnet_tpu/parallel/multihost.py``. Launch contract:
one process per card (or per host on the CPU), every process running the
same command with the same ``--seed``:

    info = initialize_distributed()          # flags, or torchrun's environment
    loader = MultiHostTrainLoader(dataset, global_batch, seed=..., device=info.device)
    for low, high in loader.epoch(): ...     # this rank's rows of each global batch

Every process draws the same global index order and augmentation seeds and
decodes only its ``process_local_slice`` of each batch. PyTorch has no
global array, so where the JAX loader stitches the shards into one
``jax.Array`` the port's step reduces the gradients itself
(``train/trainer.py:train_step(group=)``). Rank order is row order by
construction, so the JAX ``sharding_local_slice`` (rows owned by a
process's devices under a reordered mesh) has no counterpart.

``spawn_local`` starts one process per local card from one command, as the
JAX CLI uses every local chip.
"""

from __future__ import annotations

import dataclasses
import datetime
import ipaddress
import os
import socket
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from hvi_cidnet_torch.data.pipeline import TrainLoader

# the collectives' timeout: longer than process 0's in-loop eval, during
# which the other ranks wait in the next step's all-reduce
TIMEOUT = datetime.timedelta(hours=2)


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    """This process's place in the group and the device it trains on."""

    rank: int
    world: int
    local_rank: int
    backend: str
    device: torch.device
    created: bool  # this call started the group (and its owner destroys it)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def _loopback(address: str) -> bool:
    host = address.rsplit(":", 1)[0].strip("[]")
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def choose_backend(local_processes: int, cards: int, cpu: bool) -> str:
    """``nccl`` when every local process has a card of its own; ``gloo`` on
    the CPU or when local processes share a card (NCCL refuses two ranks on
    one device)."""
    if cpu or cards == 0 or local_processes > cards:
        return "gloo"
    return "nccl"


def initialize_distributed(
    *,
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu: bool = False,
) -> ProcessInfo:
    """Join (or start) the process group; idempotent when one exists.

    Each omitted argument is read from torchrun's environment:
    ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; the local
    rank and the number of processes on this host from ``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE``, else, for a loopback coordinator, from the
    process id and count (all processes on this host), else one process
    on this host, which must then see one card only: one process a host
    with several cards would leave all but one idle, so that raises and
    names ``torchrun --nproc_per_node``. A missing value, an unreachable
    coordinator or a bad environment raises: a process that went on alone
    would train a model of its own. The backend follows ``choose_backend``
    and is printed with the rule. The device is ``cuda:<local rank>`` (the
    CPU with ``cpu``)."""
    if dist.is_initialized():
        return _info(created=False, cpu=cpu)
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise ValueError("multihost: no coordinator; pass --coordinator_address host:port "
                             "or launch with torchrun (MASTER_ADDR / MASTER_PORT)")
        coordinator_address = f"{addr}:{port}"
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError("multihost: pass --num_processes and --process_id, or launch with "
                         "torchrun (WORLD_SIZE / RANK)")
    if not 0 <= rank < world:
        raise ValueError(f"multihost: process id {rank} is not in [0, {world})")
    cards = 0 if cpu else torch.cuda.device_count()
    if not cpu and cards == 0:
        raise RuntimeError("multihost: no CUDA device is visible; pass --cpu to train on the CPU")
    local = _env_int("LOCAL_WORLD_SIZE")
    local_rank = _env_int("LOCAL_RANK")
    loopback = _loopback(coordinator_address)
    if local is None and local_rank is None and not loopback and cards > 1:
        raise ValueError(
            f"multihost: this process sees {cards} cards but would train on one (one process "
            f"a host); start one process per card, e.g. torchrun --nproc_per_node {cards} "
            "(which sets LOCAL_RANK / LOCAL_WORLD_SIZE), or show it one card "
            "(CUDA_VISIBLE_DEVICES)")
    if local is None:
        local = world if loopback else 1
    if local_rank is None:
        local_rank = rank if loopback else 0
    backend = choose_backend(local, cards, cpu)
    device = torch.device("cpu") if cpu else torch.device("cuda", local_rank % cards)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    print(f"===> torch.distributed rank {rank} of {world}: backend {backend} (rule: nccl when "
          f"each of the {local} local processes has a card of its own, {cards} visible, else "
          f"gloo), device {device}, coordinator {coordinator_address}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    return ProcessInfo(rank, world, local_rank, backend, device, created=True)


def _info(*, created: bool, cpu: bool) -> ProcessInfo:
    local_rank = _env_int("LOCAL_RANK") or 0
    if cpu or not torch.cuda.is_available():
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", torch.cuda.current_device())
    return ProcessInfo(dist.get_rank(), dist.get_world_size(), local_rank, dist.get_backend(),
                       device, created)


def process_local_slice(
    global_batch: int,
    *,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> slice:
    """This process's contiguous row range of every global batch: rank p
    takes rows [p * per, (p + 1) * per)."""
    grouped = dist.is_available() and dist.is_initialized()
    pi = process_index if process_index is not None else dist.get_rank() if grouped else 0
    pc = process_count if process_count is not None else dist.get_world_size() if grouped else 1
    if global_batch % pc:
        raise ValueError(f"global batch {global_batch} not divisible by {pc} processes")
    per = global_batch // pc
    return slice(pi * per, (pi + 1) * per)


class MultiHostTrainLoader:
    """This rank's rows of every global batch, as tensors on ``device``.

    Wraps ``TrainLoader`` with ``batch_rows``: every process draws the same
    global permutation and the augmentation seeds of the full batch (one
    seed stream in every rank) and decodes only its own rows."""

    def __init__(
        self,
        dataset,
        global_batch: int,
        *,
        seed: int = 0,
        num_threads: int = 8,
        shuffle: bool = True,
        prefetch: int = 4,
        device=None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.global_batch = global_batch
        self.local = process_local_slice(global_batch, process_index=process_index,
                                         process_count=process_count)
        self._inner = TrainLoader(dataset, global_batch, seed=seed, num_threads=num_threads,
                                  shuffle=shuffle, prefetch=prefetch, device=device,
                                  batch_rows=self.local)
        self.steps_per_epoch = self._inner.steps_per_epoch

    def close(self):
        self._inner.close()

    def epoch(self) -> Iterator[Tuple]:
        return self._inner.epoch()


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now (for a local rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(local_rank: int, nprocs: int, port: int, fn, args) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(nprocs),
                      RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      LOCAL_WORLD_SIZE=str(nprocs))
    fn(local_rank, *args)


def spawn_local(nprocs: int, fn, *args) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh processes on this host
    (``torch.multiprocessing.spawn``), with torchrun's environment set for
    a rendezvous on 127.0.0.1 at a free port, so ``initialize_distributed()``
    needs no arguments there. ``fn`` must be importable (it is pickled by
    name). Returns when every process has ended; a process that fails makes
    this raise, after the others are stopped."""
    import torch.multiprocessing as mp

    mp.spawn(_spawned, args=(nprocs, free_port(), fn, args), nprocs=nprocs, join=True)
