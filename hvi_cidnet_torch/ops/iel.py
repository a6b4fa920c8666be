"""The IEL gate branch in plain PyTorch: ``tanh(dw2(dw1(y))) + dw1(y)``.

Counterpart of ``_xla_branch`` (``hvi_cidnet_tpu/ops/iel_pallas.py:199-203``),
the default path of the JAX forward; reference net/LCA.py:53-60. Its kernel
(K7, the JAX ``_branch_kernel``) is ported in a later slice. dw2's zero SAME
padding pads dw1's output with zeros, which is what chaining two
``dwconv3x3`` calls does.
"""

from __future__ import annotations

import torch

from hvi_cidnet_torch.ops.conv import dwconv3x3


def iel_branch(y: torch.Tensor, w_dw1: torch.Tensor, w_dw2: torch.Tensor) -> torch.Tensor:
    """NCHW ``y``; ``w_dw1``/``w_dw2``: (C, 1, 3, 3) depthwise weights."""
    t1 = dwconv3x3(y, w_dw1)
    return torch.tanh(dwconv3x3(t1, w_dw2)) + t1
