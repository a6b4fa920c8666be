"""Parameters across the two packages, and weight loading.

The JAX package keeps the reference's parameter names with HWIO conv
weights; this package keeps the same names with the reference's OIHW
layout. So moving parameters across is a per-tensor layout change:

* ``jax_params_to_torch``: 4-D HWIO -> OIHW, every other tensor as it is,
  and its inverse ``torch_to_jax_params``;
* ``load_state_dict_file``: a reference-layout state dict from ``.pth``
  (``torch.load(weights_only=True)``, unwrapping ``{"state_dict": ...}``),
  ``.safetensors`` (read by ``compat/safetensors_io.py``: the machine with
  the card has no ``safetensors`` package), an HF folder holding
  ``model.safetensors`` (``save_pretrained``'s output) or ``.npz``; an
  ``.npz`` with ``param::`` keys is the JAX trainer's native checkpoint
  (``hvi_cidnet_tpu/train/checkpoint.py:save_checkpoint``): its HWIO
  parameters are taken, as that package's ``load_checkpoint`` takes them,
  and its optimizer state (``opt::<i>``) and epoch (``meta::*``) are
  dropped. Orbax checkpoint trees are not read;
* ``load_weights``: a load into a model with the semantics of the JAX
  ``compat/torch_ckpt.py:filtered_update``: strict (the reference's
  ``load_state_dict(strict=True)``, eval.py:42) or, for the TNSM evaluator
  (eval_tnsm.py:39-43), shape-filtered and non-strict.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Union

import numpy as np
import torch
from torch import nn

from hvi_cidnet_torch.compat import safetensors_io


def _is_conv_weight(name: str, arr) -> bool:
    return name.endswith(".weight") and getattr(arr, "ndim", 0) == 4


def jax_params_to_torch(np_params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX parameter dict (numpy arrays, HWIO convs) -> fp32 torch state dict."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in np_params.items():
        arr = np.asarray(value, dtype=np.float32)
        if _is_conv_weight(name, arr):
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[name] = torch.from_numpy(arr.copy())
    return out


def torch_to_jax_params(state: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Reference-layout state dict -> JAX parameter dict (numpy fp32, HWIO
    convs): the exact inverse of ``jax_params_to_torch``, as the JAX
    ``from_torch_state_dict`` is of its ``to_torch_state_dict``. The arrays
    are copies: a later in-place update of a parameter does not reach them."""
    out: Dict[str, np.ndarray] = {}
    for name, value in state.items():
        arr = torch.as_tensor(value).detach().to("cpu", torch.float32).numpy()
        if _is_conv_weight(name, arr):
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        out[name] = np.array(arr, order="C")
    return out


# key prefix of the parameters in a JAX trainer checkpoint; its other keys
# are "opt::<i>" (optimizer state) and "meta::epoch"
_JAX_PARAM = "param::"
# an HF folder (save_pretrained's output, hvi_cidnet_tpu/train/checkpoint.py:67-70)
HF_WEIGHTS = "model.safetensors"


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Reference-layout (OIHW) state dict from a ``.pth``, ``.safetensors``
    or ``.npz`` file or an HF folder, fp32.

    An ``.npz`` with ``param::`` keys is a JAX trainer checkpoint: its
    parameters, HWIO convs turned to OIHW; any other ``.npz`` is a state
    dict with bare keys in the reference's layout."""
    if os.path.isdir(path):
        hf_file = os.path.join(path, HF_WEIGHTS)
        if os.path.isfile(hf_file):
            return load_state_dict_file(hf_file)
        if any(re.fullmatch(r"\d+", d) for d in os.listdir(path)):
            raise NotImplementedError(
                f"{path}: an orbax checkpoint tree (digit step dirs); the PyTorch port does "
                "not read orbax checkpoints: export the weights as .npz, .pth or safetensors")
        raise FileNotFoundError(
            f"{path}: directory is neither an HF export ({HF_WEIGHTS}) "
            "nor an orbax checkpoint tree (digit step dirs)"
        )
    if path.endswith(".safetensors"):
        return {k: v.to(torch.float32) for k, v in safetensors_io.load_file(path).items()}
    if path.endswith(".npz"):
        with np.load(path) as z:
            if any(k.startswith(_JAX_PARAM) for k in z.files):
                return jax_params_to_torch(
                    {k[len(_JAX_PARAM):]: z[k] for k in z.files if k.startswith(_JAX_PARAM)})
            return {k: torch.from_numpy(np.asarray(z[k], np.float32)) for k in z.files}
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: torch.as_tensor(v).detach().to(torch.float32) for k, v in state.items()}


def filtered_keys(own: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor]) -> List[str]:
    """The keys a non-strict load takes: present in both with one shape
    (``filtered_update(..., strict=False)``)."""
    return [k for k in own if k in loaded and tuple(own[k].shape) == tuple(loaded[k].shape)]


def load_weights(
    model: nn.Module, weights: Union[str, Mapping[str, torch.Tensor]], *, strict: bool = True
) -> nn.Module:
    """Load a reference-layout state dict (or a file or folder of one) into
    ``model``. Values keep the model's dtype and device.

    ``strict=True``: ``KeyError`` on missing or unexpected keys,
    ``ValueError`` on a shape mismatch. ``strict=False``: the keys present
    with matching shapes are taken and every other tensor keeps its value;
    the count taken is printed, as the TNSM evaluator prints it.
    """
    loaded = load_state_dict_file(weights) if isinstance(weights, str) else dict(weights)
    own = model.state_dict()
    if strict:
        missing = set(own) - set(loaded)
        unexpected = set(loaded) - set(own)
        if missing or unexpected:
            raise KeyError(
                f"strict load failed: missing={sorted(missing)[:5]}... "
                f"unexpected={sorted(unexpected)[:5]}..."
            )
        bad = [k for k in own if tuple(own[k].shape) != tuple(loaded[k].shape)]
        if bad:
            raise ValueError(
                f"strict load failed: shape mismatch for {bad[:5]} "
                f"(model {tuple(own[bad[0]].shape)} vs file {tuple(loaded[bad[0]].shape)})"
            )
        taken = list(own)
    else:
        taken = filtered_keys(own, loaded)
        source = weights if isinstance(weights, str) else "a state dict"
        print(f"loaded {len(taken)}/{len(own)} tensors from {source} (shape-filtered, non-strict)")
    with torch.no_grad():
        for k in taken:
            own[k].copy_(torch.as_tensor(loaded[k]))
    return model
