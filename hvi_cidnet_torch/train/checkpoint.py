"""Training checkpoints that resume exactly, in the JAX trainer's format.

Counterpart of ``hvi_cidnet_tpu/train/checkpoint.py``: the reference
snapshots ``model.state_dict()`` only (train.py:93-101); the native format
is one ``.npz`` with the parameters (``param::<name>``, convs HWIO), the
optimizer state (``opt::<i>``) and the epoch (``meta::epoch``), written by
``compat/checkpoint.py``. Either package resumes the other's file with its
Adam moments, step count and learning rate.

The ``opt::<i>`` leaves are the flatten order of the JAX optimizer state
(``optax.inject_hyperparams(optax.adam)``, after ``clip_by_global_norm``'s
leafless state with ``"clip"``), laid out by ``opt_leaf_names``:

  0          the injected hyperparameters' step count (int32)
  1 - 5      b1, b2, eps, eps_root, learning_rate (float32)
  6          Adam's step count (int32): torch's ``state["step"]``
  next n     Adam's first moment (``exp_avg``) per parameter, sorted by name
  last n     Adam's second moment (``exp_avg_sq``), sorted by name

Conv weights' moments are HWIO, as their ``param::`` entries are.

``broadcast_state_`` hands process 0's parameters and Adam state to every
rank of a group (the JAX CLI's ``multihost_utils.broadcast_one_to_all`` of
a resumed checkpoint); ``state_digest`` names a state by its bytes, so
ranks and files can be compared.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from hvi_cidnet_torch.compat import checkpoint as _compat
from hvi_cidnet_torch.compat.jax_params import (
    _JAX_PARAM,
    jax_params_to_torch,
    load_state_dict_file,
    load_weights,
    torch_to_jax_params,
)
from hvi_cidnet_torch.train.trainer import ADAM

HYPERPARAMS = ("b1", "b2", "eps", "eps_root", "learning_rate")
MOMENTS = (("mu", "exp_avg"), ("nu", "exp_avg_sq"))


def opt_leaf_names(param_names) -> List[str]:
    """The name of each ``opt::<i>`` leaf, in order."""
    names = sorted(param_names)
    return (["count", *(f"hyperparams.{h}" for h in HYPERPARAMS), "adam.count"]
            + [f"{m}.{n}" for m, _ in MOMENTS for n in names])


def optimizer_leaves(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> List[np.ndarray]:
    """The optimizer's state as the JAX state's leaves (``opt_leaf_names``)."""
    named = dict(model.named_parameters())
    names = sorted(named)
    state = optimizer.state
    held = [state[p]["step"] for p in named.values() if "step" in state.get(p, {})]
    steps = set(torch.stack(held).tolist()) if held else set()  # one read from the card
    if len(held) < len(named):
        steps.add(0)
    if len(steps) != 1:
        raise ValueError(f"parameters at different Adam step counts {sorted(steps)}: the JAX "
                         "state holds one count for all")
    count = np.asarray(int(steps.pop()), np.int32)
    group = optimizer.param_groups[0]
    hyper = {"b1": group["betas"][0], "b2": group["betas"][1], "eps": group["eps"],
             "eps_root": ADAM["eps_root"], "learning_rate": group["lr"]}
    leaves = [count, *(np.asarray(hyper[h], np.float32) for h in HYPERPARAMS), count]
    for _, key in MOMENTS:
        moments = {n: state[named[n]][key] if key in state.get(named[n], {})
                   else torch.zeros_like(named[n]) for n in names}
        hwio = torch_to_jax_params(moments)
        leaves.extend(hwio[n] for n in names)
    return leaves


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None, epoch: int = 0) -> str:
    """Write ``model``'s parameters, ``optimizer``'s state (if given) and
    ``epoch`` as the JAX trainer's ``.npz`` (atomic rename)."""
    leaves = optimizer_leaves(model, optimizer) if optimizer is not None else None
    return _compat.save_checkpoint(path, model.state_dict(), epoch, leaves)


def _load_adam_state(model, optimizer, moments: Dict[str, Dict[str, torch.Tensor]],
                     steps: Dict[str, float], lr: float) -> None:
    """Give ``optimizer`` these Adam moments (``exp_avg`` / ``exp_avg_sq``
    by parameter name), step counts and lr, through ``load_state_dict``
    (which puts each on its parameter's device, as Adam keeps it)."""
    named = dict(model.named_parameters())
    sd = optimizer.state_dict()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    index = {id(p): i for i, p in enumerate(params)}
    sd["state"] = {index[id(named[n])]: {"step": torch.tensor(float(steps[n])),
                                         **{key: moments[key][n] for _, key in MOMENTS}}
                   for n in named}
    for g in sd["param_groups"]:
        g["lr"] = lr
    optimizer.load_state_dict(sd)


def _set_optimizer_state(model, optimizer, leaves: List[np.ndarray]) -> None:
    named = dict(model.named_parameters())
    names = sorted(named)
    want = opt_leaf_names(names)
    if len(leaves) != len(want):
        raise ValueError(f"{len(leaves)} optimizer leaves, the model's Adam state has {len(want)}")
    leaf = dict(zip(want, leaves))
    count = float(leaf["adam.count"])
    moments = {key: jax_params_to_torch({n: leaf[f"{m}.{n}"] for n in names})
               for m, key in MOMENTS}
    _load_adam_state(model, optimizer, moments, dict.fromkeys(names, count),
                     float(leaf["hyperparams.learning_rate"]))


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Load a native ``.npz`` into ``model`` (strict) and, when given and the
    file holds one, its optimizer state into ``optimizer``. Returns the
    file's epoch (0 when it has none)."""
    with np.load(path) as z:
        params = {k[len(_JAX_PARAM):]: z[k] for k in z.files if k.startswith(_JAX_PARAM)}
        opt_keys = sorted((k for k in z.files if k.startswith(_compat._OPT)),
                          key=lambda k: int(k[len(_compat._OPT):]))
        leaves = [z[k] for k in opt_keys]
        epoch = int(z[_compat._META + "epoch"]) if _compat._META + "epoch" in z.files else 0
    load_weights(model, jax_params_to_torch(params), strict=True)
    if optimizer is not None and leaves:
        _set_optimizer_state(model, optimizer, leaves)
    return epoch


def load_any(path: str) -> Dict[str, torch.Tensor]:
    """Model weights from any supported container (``.npz``, ``.pth``,
    ``.safetensors``, an HF folder), as a reference-layout state dict."""
    return load_state_dict_file(path)


def latest_epoch(weights_dir: str) -> int:
    """The newest ``epoch_N.npz`` for resume (train.py:160-162 analog)."""
    best = 0
    if os.path.isdir(weights_dir):
        for f in os.listdir(weights_dir):
            m = re.fullmatch(r"epoch_(\d+)\.npz", f)
            if m:
                best = max(best, int(m.group(1)))
    return best


def broadcast_state_(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
                     src: int = 0, group=None) -> None:
    """Make every rank's parameters and Adam state (moments, step counts,
    lr) rank ``src``'s, bit for bit: a header (whether ``src`` holds Adam
    state, its lr) and one flat fp32 buffer (parameters, then first and
    second moments, then step counts, in ``named_parameters`` order) are
    broadcast on the parameters' device. Only ``src`` needs to have read
    the checkpoint; a rank without the file resumes all the same."""
    named = list(model.named_parameters())
    device = named[0][1].device
    is_src = dist.get_rank() == src
    states = [optimizer.state.get(p, {}) for _, p in named] if optimizer is not None else []
    has = is_src and bool(states) and all("exp_avg" in st for st in states)
    lr = optimizer.param_groups[0]["lr"] if optimizer is not None else 0.0
    header = torch.tensor([float(has), lr], dtype=torch.float64, device=device)
    dist.broadcast(header, src, group=group)
    has, lr = bool(header[0].item()), header[1].item()
    sizes = [p.numel() for _, p in named] * (3 if has else 1) + ([len(named)] if has else [])
    if is_src:
        parts = [p.detach().float().reshape(-1) for _, p in named]
        if has:
            for _, key in MOMENTS:
                parts += [st[key].float().reshape(-1) for st in states]
            parts.append(torch.stack([torch.as_tensor(st["step"]).float().to(device)
                                      for st in states]))
        flat = torch.cat(parts)
    else:
        flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    dist.broadcast(flat, src, group=group)
    if is_src:
        return
    chunks = iter(flat.split(sizes))
    with torch.no_grad():
        for _, p in named:
            p.copy_(next(chunks).view_as(p))
    if optimizer is None:
        return
    if has:
        moments = {key: {n: next(chunks).view_as(p).clone() for n, p in named}
                   for _, key in MOMENTS}
        steps = dict(zip((n for n, _ in named), next(chunks).tolist()))
        _load_adam_state(model, optimizer, moments, steps, lr)
    else:
        for g in optimizer.param_groups:
            g["lr"] = lr


def state_digest(model: torch.nn.Module, optimizer: Optional[torch.optim.Optimizer] = None) -> str:
    """A sha256 (16 hex digits) of the parameters' bytes and, when given,
    Adam's moments, step counts and lr, in ``named_parameters`` order."""
    h = hashlib.sha256()
    named = list(model.named_parameters())
    for _, p in named:
        h.update(p.detach().float().cpu().numpy().tobytes())
    if optimizer is not None:
        for _, p in named:
            st = optimizer.state.get(p, {})
            h.update(repr(float(st["step"]) if "step" in st else 0.0).encode())
            for _, key in MOMENTS:
                if key in st:
                    h.update(st[key].detach().float().cpu().numpy().tobytes())
        h.update(repr(float(optimizer.param_groups[0]["lr"])).encode())
    return h.hexdigest()[:16]
