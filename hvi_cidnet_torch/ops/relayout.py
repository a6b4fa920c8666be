"""Plain versions of the TPU relayout kernels P7-P9 and P11-P14.

Each is a copy of a 3-D array under an axis permutation, written as one
``permute(...).contiguous()``. Each function is named after the JAX
function it stands for (the Pallas kernels of ``experiments/``):

* ``transpose_steps`` (P7, ``transpose_kernel_r3.py:make_transpose``):
  (HW, C, B) -> (HW, C, B), (HW, B, C), (B, HW, C) or (B, C, HW) at
  ``steps`` 0, 1, 2, 3, in tiles of ``hwt`` rows;
* ``relayout_t3``, ``relayout_t2`` (P8, P9, ``relayout_probe_r5h.py:
  pallas_t3``, ``pallas_t2``): (N, C, B) -> (B, C, N), in blocks of
  ``n_blk`` rows of N;
* ``relayout_t2_rev`` (P11, ``pallas_t2_rev``): (B, C, N) -> (N, C, B);
* ``t3_blocked``, ``t2_blocked`` (P12, P13, ``mosaic_micro_r5h.py``):
  (N, C, B) -> (G, B, C, n_blk), G = N / n_blk;
* ``pack_blocked`` (P14): (N, C, B) -> (G, B, n_blk, C).

The block sizes do not change P7, P8, P9 or P11's result; they are checked
(they must divide the axis they cut, as the Pallas grids drop a remainder)
and otherwise ignored. P12, P13 and P14 cut N into G blocks in the output.
The kernel wrappers are ``ops/relayout_cuda.py``; these are what they
compute, what the CPU runs and what their backward differentiates.
"""

from __future__ import annotations

from typing import Optional

import torch

# P7's output axes at each step, as a permutation of (HW, C, B)
STEPS = {0: (0, 1, 2), 1: (0, 2, 1), 2: (2, 0, 1), 3: (2, 1, 0)}


def validate(name: str, x: torch.Tensor, n_blk: Optional[int] = None, steps: int = 3) -> int:
    """Raise ValueError on what relayout ``name`` does not take; return its
    block (of HW for P7, of N for the others; the whole axis if None), which
    must divide the axis it cuts."""
    if x.dim() != 3:
        raise ValueError(f"{name}: expected a 3-D tensor, got shape {tuple(x.shape)}")
    if name == "P7" and steps not in STEPS:
        raise ValueError(f"P7: steps must be 0, 1, 2 or 3, got {steps}")
    n = x.shape[2 if name == "P11" else 0]
    n_blk = n if n_blk is None else n_blk
    if n_blk < 1 or n % n_blk:
        raise ValueError(f"{name}: the block of {n_blk} rows does not divide N = {n}")
    return n_blk


def transpose_steps(x: torch.Tensor, hwt: Optional[int] = None, steps: int = 3) -> torch.Tensor:
    """P7: (HW, C, B) relaid by ``steps`` minor-pair and major swaps."""
    validate("P7", x, hwt, steps)
    return x.permute(*STEPS[steps]).contiguous()


def relayout_t3(x: torch.Tensor, n_blk: Optional[int] = None) -> torch.Tensor:
    """P8: (N, C, B) -> (B, C, N), one 3-D transpose a block."""
    validate("P8", x, n_blk)
    return x.permute(2, 1, 0).contiguous()


def relayout_t2(x: torch.Tensor, n_blk: Optional[int] = None) -> torch.Tensor:
    """P9: (N, C, B) -> (B, C, N), one 2-D transpose a channel."""
    validate("P9", x, n_blk)
    return x.permute(2, 1, 0).contiguous()


def relayout_t2_rev(x: torch.Tensor, n_blk: Optional[int] = None) -> torch.Tensor:
    """P11: (B, C, N) -> (N, C, B)."""
    validate("P11", x, n_blk)
    return x.permute(2, 1, 0).contiguous()


def _blocks(x: torch.Tensor, n_blk: int, name: str) -> torch.Tensor:
    """(N, C, B) viewed as (G, n_blk, C, B)."""
    n_blk = validate(name, x, n_blk)
    n, c, b = x.shape
    return x.reshape(n // n_blk, n_blk, c, b)


def t3_blocked(x: torch.Tensor, n_blk: int) -> torch.Tensor:
    """P12: (N, C, B) -> (G, B, C, n_blk)."""
    return _blocks(x, n_blk, "P12").permute(0, 3, 2, 1).contiguous()


def t2_blocked(x: torch.Tensor, n_blk: int) -> torch.Tensor:
    """P13: (N, C, B) -> (G, B, C, n_blk), one 2-D transpose a channel."""
    return _blocks(x, n_blk, "P13").permute(0, 3, 2, 1).contiguous()


def pack_blocked(x: torch.Tensor, n_blk: int) -> torch.Tensor:
    """P14: (N, C, B) -> (G, B, n_blk, C): the block's (n_blk * C, B) rows
    transposed."""
    return _blocks(x, n_blk, "P14").permute(0, 3, 1, 2).contiguous()
