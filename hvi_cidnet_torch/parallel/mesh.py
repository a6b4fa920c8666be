"""Device meshes: which devices serve a batch, and which rows each takes.

Counterpart of ``hvi_cidnet_tpu/parallel/mesh.py``. PyTorch has no global
array and no sharding annotations, so a mesh here is a frozen list of
``torch.device``s with the JAX mesh's shape and axis names; a batch is
split into contiguous row blocks in device order (``batch_slices``, the
``P("data")`` sharding of ``batch_sharding``) and the model is copied once
per device (``replicate``, the replicated sharding of ``shard_params``).
A device may appear more than once: two replicas on one card run
one after the other on it, which is how a one-card machine exercises the
multi-replica path. A ``spatial`` axis splits one image's rows
(``spatial_sharding``, the ``P(None, "spatial")`` sharding): on a 2-D
("data", "spatial") mesh, batch block i is served by the row group of the
devices in row i of the mesh.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out in ``shape`` with one name per axis."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...] = ("data",)

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not match axes {self.axis_names}")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} does not hold {len(self.devices)} devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, name: str) -> int:
        """The length of axis ``name`` (the JAX ``mesh.shape[name]``)."""
        return self.shape[self.axis_names.index(name)]


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data",),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over every visible card (``cuda:0`` .. ``cuda:n-1``) or over
    ``devices`` (which may repeat one, e.g. ``[cpu, cpu]``). Default shape:
    all devices on the first axis, 1 on the others."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= "
                               "(e.g. [torch.device('cpu')] * 2) for a mesh off the card")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = tuple(torch.device(d) for d in devices)
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    return Mesh(devices, tuple(shape), tuple(axis_names))


def batch_slices(mesh: Mesh, n: int) -> List[slice]:
    """The contiguous rows of an ``n``-row batch that each device takes, in
    device order."""
    if n % mesh.size:
        raise ValueError(f"batch {n} is not divisible by the {mesh.size}-device mesh")
    per = n // mesh.size
    return [slice(i * per, (i + 1) * per) for i in range(mesh.size)]


def spatial_sharding(mesh: Mesh, h: int, axis: str = "spatial") -> List[slice]:
    """The global rows of an ``h``-row image that each device of the mesh
    takes, in device order: contiguous blocks along ``axis`` (a device's
    block is its index on that axis), the same on every other axis."""
    n = mesh.axis_size(axis)
    if h % n:
        raise ValueError(f"{h} rows are not divisible by the {n}-way {axis!r} axis")
    per = h // n
    stride = math.prod(mesh.shape[mesh.axis_names.index(axis) + 1:])
    return [slice((i // stride) % n * per, ((i // stride) % n + 1) * per)
            for i in range(mesh.size)]


def replicate(model: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """One deep copy of ``model`` on each device of the mesh (a device that
    appears twice gets two copies); ``model`` itself is left as it is."""
    return [copy.deepcopy(model).to(d) for d in mesh.devices]
