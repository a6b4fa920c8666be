"""Asynchronous checkpoints: ``--ckpt_backend orbax`` in the port.

Counterpart of ``OrbaxCheckpoints`` (``hvi_cidnet_tpu/train/orbax_ckpt.py``).
The card's machine has no orbax, so the port keeps what the backend is
for and its layout, not its file format:

- **asynchronous**: ``save`` copies the parameters and the optimizer state
  to host memory on the calling thread, then writes them on a background
  thread while training goes on; the next ``save`` first waits for the
  previous write, so snapshots never interleave; ``wait`` (or ``close``)
  returns once every queued write is on disk;
- **layout**: one directory per epoch, ``<dir>/<epoch>/checkpoint.npz``,
  each file the JAX trainer's ``.npz`` (``train/checkpoint.py``; the JAX
  ``load_checkpoint`` reads it), with retention by ``max_to_keep``;
- **multi-process**: rank 0 writes; every rank calls ``save`` (a no-op
  elsewhere) and ``wait``, which also waits for the whole group.
"""

from __future__ import annotations

import os
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import torch
import torch.distributed as dist

from hvi_cidnet_torch.compat import checkpoint as _compat
from hvi_cidnet_torch.train.checkpoint import load_checkpoint, optimizer_leaves

FILE = "checkpoint.npz"


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


class AsyncCheckpoints:
    """Checkpoints under ``directory``, one per epoch, written in the
    background; at most ``max_to_keep`` kept (the newest), all when None."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._writes = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, str(int(epoch)), FILE)

    def save(self, epoch: int, model: torch.nn.Module,
             optimizer: Optional[torch.optim.Optimizer] = None) -> None:
        """Snapshot ``model`` (and ``optimizer``) as epoch ``epoch`` now;
        write it in the background (rank 0 only)."""
        if _grouped() and dist.get_rank() != 0:
            return
        self._wait_local()
        state = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
        leaves = optimizer_leaves(model, optimizer) if optimizer is not None else None
        self._pending = self._writes.submit(self._write, int(epoch), state, leaves)

    def _write(self, epoch: int, state, leaves) -> None:
        _compat.save_checkpoint(self.path(epoch), state, epoch, leaves)
        if self.max_to_keep is not None:
            for old in self.epochs()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))

    def epochs(self) -> list:
        """The epochs on disk, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if re.fullmatch(r"\d+", d) and os.path.isfile(self.path(int(d))))

    def latest_epoch(self) -> int:
        """The newest epoch on disk, 0 when none (as ``latest_epoch`` of the
        ``.npz`` files)."""
        done = self.epochs()
        return done[-1] if done else 0

    def restore(self, epoch: Optional[int], model: torch.nn.Module,
                optimizer: Optional[torch.optim.Optimizer] = None) -> int:
        """Load epoch ``epoch`` (the newest when None) into ``model`` and
        ``optimizer``; returns the epoch."""
        self._wait_local()
        epoch = self.latest_epoch() if epoch is None else int(epoch)
        if epoch <= 0 or not os.path.isfile(self.path(epoch)):
            raise FileNotFoundError(f"no checkpoint of epoch {epoch} under {self.directory}")
        load_checkpoint(self.path(epoch), model, optimizer)
        return epoch

    def _wait_local(self) -> None:
        if self._pending is not None:
            self._pending.result()  # raises a failed write here
            self._pending = None

    def wait(self) -> None:
        """Return once every queued write is on disk (in every rank of the
        group, when there is one)."""
        self._wait_local()
        if _grouped():
            dist.barrier()

    def close(self) -> None:
        self.wait()
        self._writes.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
