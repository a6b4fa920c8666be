"""The flagship forward and its example arguments: base CIDNet at full
width, bf16, on a 4 x 256 x 256 batch — the counterpart of
``__graft_entry__.entry``.

``fn(model, x)`` runs :func:`cidnet_forward` in bf16; conv weights are bf16,
every other parameter fp32. ``x`` is drawn with numpy from seed 0, as the
JAX entry draws it, and the weights from a ``torch.Generator`` seeded 0.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from hvi_cidnet_torch.models.cidnet import (
    CIDNet,
    CIDNetConfig,
    HVIGates,
    cast_conv_weights,
    cidnet_forward,
)


def entry(device: Union[str, torch.device] = "cuda"):
    """(forward fn, (model, x)) for the base model on ``device``."""
    model = CIDNet(CIDNetConfig(variant="base"), generator=torch.Generator().manual_seed(0))
    model = cast_conv_weights(model.to(device), torch.bfloat16).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (4, 256, 256, 3)))
    x = x.to(device, torch.bfloat16)

    def fn(model: CIDNet, x: torch.Tensor) -> torch.Tensor:
        return cidnet_forward(model, x, HVIGates(), compute_dtype=torch.bfloat16)

    return fn, (model, x)
