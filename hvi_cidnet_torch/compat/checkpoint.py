"""Weight writers: the JAX package's ``.npz`` checkpoint, a ``.pth`` state
dict and an HF folder.

Counterparts of ``save_checkpoint``, ``export_pth`` and ``save_pretrained``
(``hvi_cidnet_tpu/train/checkpoint.py:27,86,97``). Each takes a
reference-layout state dict (OIHW convs, the port's own layout and
``load_state_dict_file``'s output) and writes what the JAX writer writes
from the same parameters, so each package reads the other's files:

* ``save_checkpoint``: ``.npz`` with ``param::<name>`` keys in HWIO,
  ``meta::epoch`` and, when given, the optimizer state's leaves as
  ``opt::<i>`` in the JAX state's flatten order (``train/checkpoint.py``
  lays them out from a torch optimizer);
* ``export_pth``: ``torch.save`` of the fp32 state dict;
* ``save_pretrained``: ``model.safetensors`` (``compat/safetensors_io.py``:
  the machine with the card has no ``safetensors``) beside a
  ``config.json`` of the constructor's kwargs, with ``variant`` for MSSA
  and TNSM.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from hvi_cidnet_torch.compat import safetensors_io
from hvi_cidnet_torch.compat.jax_params import _JAX_PARAM, HF_WEIGHTS, torch_to_jax_params
from hvi_cidnet_torch.models.cidnet import CIDNetConfig

_OPT = "opt::"
_META = "meta::"
HF_CONFIG = "config.json"


def _fp32(state: Mapping[str, torch.Tensor]):
    return {k: torch.as_tensor(v).detach().to("cpu", torch.float32).contiguous()
            for k, v in state.items()}


def save_checkpoint(path: str, state: Mapping[str, torch.Tensor], epoch: int = 0,
                    opt_leaves: Optional[Sequence[np.ndarray]] = None) -> str:
    """Write the JAX trainer's native ``.npz`` (atomic rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {_JAX_PARAM + k: v for k, v in torch_to_jax_params(state).items()}
    for i, leaf in enumerate(opt_leaves or ()):
        payload[f"{_OPT}{i}"] = np.asarray(leaf)
    payload[_META + "epoch"] = np.asarray(epoch)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)
    return path


def export_pth(path: str, state: Mapping[str, torch.Tensor]) -> str:
    """Write a state dict the reference's ``load_state_dict`` takes
    (eval.py:42)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.clone() for k, v in _fp32(state).items()}, path)
    return path


def save_pretrained(directory: str, state: Mapping[str, torch.Tensor],
                    config: Optional[CIDNetConfig] = None) -> str:
    """HF layout: ``model.safetensors`` + ``config.json``, the reference's
    ``PyTorchModelHubMixin.save_pretrained`` (net/CIDNet.py:6-8) and the
    inverse of ``utils/hf_config.config_from_hf_json``."""
    os.makedirs(directory, exist_ok=True)
    safetensors_io.save_file(_fp32(state), os.path.join(directory, HF_WEIGHTS))
    cfg = {}
    if config is not None:
        cfg = {"channels": list(config.channels), "heads": list(config.heads),
               "norm": bool(config.norm)}
        # the reference mixin serializes the base model's kwargs only; an
        # MSSA or TNSM folder records its variant, or a reload that defaults
        # to base would shape-filter its extra tensors away
        if config.variant != "base":
            cfg["variant"] = config.variant
    with open(os.path.join(directory, HF_CONFIG), "w") as f:
        json.dump(cfg, f, indent=2)
    return directory
