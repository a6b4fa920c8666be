"""Parameters across the two packages, and strict weight loading.

The JAX package keeps the reference's parameter names with HWIO conv
weights; this package keeps the same names with the reference's OIHW
layout. So moving parameters across is a per-tensor layout change:

* ``jax_params_to_torch``: 4-D HWIO -> OIHW, every other tensor as it is;
* ``load_state_dict_file``: a reference-layout state dict from ``.pth``
  (``torch.load(weights_only=True)``, unwrapping ``{"state_dict": ...}``) or
  ``.npz``;
* ``load_weights``: a strict load into a model, with the semantics of the
  JAX ``compat/torch_ckpt.py:74-94`` with ``strict=True`` (the reference's
  ``load_state_dict(strict=True)``, eval.py:42). The shape-filtered
  non-strict load serves the TNSM evaluator and comes with that variant.

No safetensors: the machine with the card has no ``safetensors`` package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn


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


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Reference-layout (OIHW) state dict from a ``.pth`` or ``.npz`` file, fp32."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            state = {k: torch.from_numpy(np.asarray(z[k], np.float32)) for k in z.files}
        return state
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: torch.as_tensor(v).detach().to(torch.float32) for k, v in state.items()}


def load_weights(model: nn.Module, weights: Union[str, Mapping[str, torch.Tensor]]) -> nn.Module:
    """Load a reference-layout state dict (or a file of one) into ``model``,
    strictly: ``KeyError`` on missing or unexpected keys, ``ValueError`` on a
    shape mismatch. Values keep the model's dtype and device.
    """
    loaded = load_state_dict_file(weights) if isinstance(weights, str) else dict(weights)
    own = model.state_dict()
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
    with torch.no_grad():
        for k, v in loaded.items():
            own[k].copy_(torch.as_tensor(v))
    return model
