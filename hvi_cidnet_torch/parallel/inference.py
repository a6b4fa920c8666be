"""Data-parallel inference: a batch split over the replicas of a mesh.

Counterpart of ``dp_enhance_fn`` in ``hvi_cidnet_tpu/parallel/inference.py``.
The JAX function runs each chip's shard under ``shard_map``; here one host
thread per replica drives that replica's forward under
``torch.cuda.device(d)`` (the idiom of ``torch.nn.parallel.parallel_apply``),
so each device runs the single-device forward, kernels included, on its
rows. Embarrassingly parallel: no collective. The rows come back
concatenated on the mesh's first device.

Spatial row sharding (``spatial_enhance_fn``, ``dp_spatial_enhance_fn``)
is not ported yet.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from hvi_cidnet_torch.models.cidnet import CIDNet, HVIGates
from hvi_cidnet_torch.ops.routes import Routes
from hvi_cidnet_torch.parallel.mesh import Mesh, batch_slices, replicate
from hvi_cidnet_torch.serve import Enhancer


def dp_enhance_fn(
    mesh: Mesh,
    model: CIDNet,
    gates: HVIGates = HVIGates(),
    *,
    gamma: float = 1.0,
    compute_dtype: torch.dtype = torch.float32,
    routes: Optional[Routes] = None,
) -> Callable[[Union[torch.Tensor, np.ndarray]], torch.Tensor]:
    """``fn(x)``: the enhanced NHWC batch ``x`` (H, W multiples of 8, any
    device), rows split over the mesh, as fp32 clipped to [0, 1] on the
    mesh's first device.

    The replicas are made here, once: a ``serve.Enhancer`` on each device
    of a copy of ``model`` (never the caller's model itself), its conv
    weights cast to ``compute_dtype``; each runs ``Enhancer``'s forward on
    its rows. The batch must divide the mesh size (the JAX serving
    contract); the evaluator pads its tail chunks to make it so."""
    return over_replicas(mesh, [
        Enhancer(m, gates, gamma=gamma, compute_dtype=compute_dtype, device=d, routes=routes)
        for m, d in zip(replicate(model, mesh), mesh.devices)])


def over_replicas(
    mesh: Mesh, replicas: Sequence[Enhancer]
) -> Callable[[Union[torch.Tensor, np.ndarray]], torch.Tensor]:
    """``dp_enhance_fn``'s ``fn`` over given replicas, one a device of the
    mesh in its order (``Evaluator(mesh=)`` passes itself as the first)."""

    def local(replica: Enhancer, x: torch.Tensor) -> torch.Tensor:
        on_card = replica.device.type == "cuda"
        with torch.cuda.device(replica.device) if on_card else contextlib.nullcontext():
            return replica._forward(x)

    def fn(x: Union[torch.Tensor, np.ndarray]) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        if x.shape[0] % mesh.size:
            raise ValueError(
                f"global batch {x.shape[0]} must be divisible by the "
                f"{mesh.size}-device mesh for dp_enhance_fn — pad the tail "
                "batch (eval/evaluator.py buckets do this) or drop it"
            )
        rows = batch_slices(mesh, x.shape[0])
        with ThreadPoolExecutor(max_workers=mesh.size) as pool:
            futures = [pool.submit(local, r, x[s]) for r, s in zip(replicas, rows)]
            outs = [f.result() for f in futures]
        return torch.cat([o.to(mesh.devices[0]) for o in outs])

    return fn
