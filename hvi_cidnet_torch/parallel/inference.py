"""Multi-device inference: a batch split over the replicas of a mesh, and
one image's rows split over a row group.

Counterpart of ``hvi_cidnet_tpu/parallel/inference.py``.
The JAX function runs each chip's shard under ``shard_map``; here one host
thread per replica drives that replica's forward under
``torch.cuda.device(d)`` (the idiom of ``torch.nn.parallel.parallel_apply``),
so each device runs the single-device forward, kernels included, on its
rows. Embarrassingly parallel: no collective. The rows come back
concatenated on the mesh's first device.

``spatial_enhance_fn`` splits each image's rows over the devices of one
mesh axis, and ``dp_spatial_enhance_fn`` the batch over one axis and each
image's rows over another. JAX hands that program to GSPMD, which inserts
the halo exchanges and cross-shard sums and runs no Pallas kernel; here
each shard runs the single-device forward (``models/cidnet.py:
_hvi_and_noise``, the kernels K1-K7 included) on its rows, on a host
thread of its own, and the ops that reach across rows exchange with the
other shards of its row group (``parallel/rows.py``): halo rows around the
3x3 and 7x7 convs, the IEL branch (K7) and both resizes (K3, K4), the
channel attention (K5) split at its sum over space, TNSM's global mean and
max combined across shards. The JAX contract is kept: H is padded to a
multiple of 8 x the row shards and W to 8 (reflect, or edge where reflect
cannot), gamma is applied before the forward, the output is cropped back
and clipped, fp32 on the mesh's first device. Serving only, on the default
route, NHWC.
"""

from __future__ import annotations

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from hvi_cidnet_torch.models.cidnet import CIDNet, HVIGates
from hvi_cidnet_torch.ops import _build
from hvi_cidnet_torch.ops.routes import Routes, require_default, resolve
from hvi_cidnet_torch.parallel import rows
from hvi_cidnet_torch.parallel.mesh import Mesh, batch_slices, replicate, spatial_sharding
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


def spatial_enhance_fn(
    mesh: Mesh,
    model: CIDNet,
    gates: HVIGates = HVIGates(),
    *,
    gamma: float = 1.0,
    compute_dtype: torch.dtype = torch.float32,
    axis: Optional[str] = None,
) -> Callable[[Union[torch.Tensor, np.ndarray]], torch.Tensor]:
    """``fn(x)``: the enhanced NHWC batch ``x`` (any H and W, any device or
    numpy), each image's rows split over the devices of ``axis`` (default:
    the mesh's first), as fp32 clipped to [0, 1] on the mesh's first
    device. H is padded to a multiple of 8 x the axis's length and W to a
    multiple of 8 inside the call and cropped back (a 1280 x 720 frame pads
    720 -> 736 over 4 shards). The mesh's other axes, if any, would hold
    copies of the same result: the row group is the devices at index 0 of
    them. The replicas are made here, once, as ``dp_enhance_fn`` makes
    them."""
    axis = axis or mesh.axis_names[0]
    return _rows_fn(mesh, model, gates, gamma, compute_dtype, None, axis, "spatial_enhance_fn")


def dp_spatial_enhance_fn(
    mesh: Mesh,
    model: CIDNet,
    gates: HVIGates = HVIGates(),
    *,
    gamma: float = 1.0,
    compute_dtype: torch.dtype = torch.float32,
    batch_axis: str = "data",
    row_axis: str = "spatial",
) -> Callable[[Union[torch.Tensor, np.ndarray]], torch.Tensor]:
    """``spatial_enhance_fn`` over a 2-D mesh: the batch split over
    ``batch_axis`` (it must divide that axis: the JAX ``ValueError``) and
    each block's rows over ``row_axis`` (e.g. 4 frames at a time, each
    split over 2 devices)."""
    return _rows_fn(mesh, model, gates, gamma, compute_dtype, batch_axis, row_axis,
                    "dp_spatial_enhance_fn")


def pad_to_mesh(x: torch.Tensor, n_row: int) -> torch.Tensor:
    """NHWC ``x`` with H padded to a multiple of ``8 * n_row`` and W to a
    multiple of 8: reflect where both pads are smaller than their axes,
    else edge (a sliver), as the JAX functions pad."""
    h, w = x.shape[1], x.shape[2]
    mh = 8 * n_row
    ph, pw = (mh - h % mh) % mh, (8 - w % 8) % 8
    if not (ph or pw):
        return x
    mode = "reflect" if ph < h and pw < w else "replicate"
    return F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode=mode).permute(0, 2, 3, 1)


def _row_groups(mesh: Mesh, row_axis: str, batch_axis: Optional[str]) -> List[List[int]]:
    """Indices into ``mesh.devices``: one list a batch block, its row
    shards in order (without ``batch_axis``, one list: index 0 of every
    other axis)."""
    names = list(mesh.axis_names)
    grid = np.arange(mesh.size).reshape(mesh.shape)
    r = names.index(row_axis)
    if batch_axis is None:
        return np.moveaxis(grid, r, -1).reshape(-1, mesh.shape[r])[:1].tolist()
    b = names.index(batch_axis)
    if b == r:
        raise ValueError(f"batch_axis and row_axis are both {row_axis!r}")
    grid = np.moveaxis(grid, (b, r), (0, -1)).reshape(mesh.shape[b], -1, mesh.shape[r])
    return grid[:, 0].tolist()


def _rows_fn(mesh, model, gates, gamma, compute_dtype, batch_axis, row_axis, name):
    groups = _row_groups(mesh, row_axis, batch_axis)
    n_batch, n_row = len(groups), len(groups[0])
    replicas = {i: Enhancer(copy.deepcopy(model), gates, gamma=gamma,
                            compute_dtype=compute_dtype, device=mesh.devices[i])
                for g in groups for i in g}

    def fn(x: Union[torch.Tensor, np.ndarray]) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        if batch_axis is not None and x.shape[0] % n_batch:
            raise ValueError(
                f"global batch {x.shape[0]} must be divisible by the "
                f"{n_batch}-way {batch_axis!r} axis for dp_spatial_enhance_fn"
            )
        require_default(resolve(None), name)
        if any(r.device.type == "cuda" for r in replicas.values()):
            _build.library()  # built once here, not by the first shard to launch
        h, w = x.shape[1], x.shape[2]
        padded = pad_to_mesh(x, n_row)
        row_slices = spatial_sharding(mesh, padded.shape[1], row_axis)
        size = x.shape[0] // n_batch
        blocks = [slice(i * size, (i + 1) * size) for i in range(n_batch)]
        row_groups = [rows.RowGroup([mesh.devices[i] for i in g]) for g in groups]

        def shard(s: rows.Shard) -> torch.Tensor:
            gi = row_groups.index(s.group)
            i = groups[gi][s.rank]
            return replicas[i]._forward(padded[blocks[gi], row_slices[i]])

        outs = rows.run_groups(row_groups, shard)
        first = mesh.devices[0]
        out = torch.cat([torch.cat([o.to(first) for o in g], dim=1) for g in outs])
        return out[:, :h, :w]

    return fn
