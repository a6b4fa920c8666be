"""K7: the fused IEL-branch kernel ``tanh(dw2(dw1(y))) + dw1(y)``, its plain
twin and the dispatcher ``iel_branch``.

Counterpart of ``hvi_cidnet_tpu/ops/iel_pallas.py``. The kernel is
``csrc/iel.cu`` and takes a contiguous NCHW activation and the two
(C, 1, 3, 3) depthwise weights; the twin is ``ops/iel.py:iel_branch``. Like
the twin's ``dwconv3x3``, the wrapper takes the weights in the activation
dtype (``w.to(y.dtype)``, a no-op in the model, whose conv weights already
hold the compute dtype).

Dispatch is by device only: a CPU tensor takes the plain twin, a CUDA
tensor the kernel. Backward runs the twin's autograd.
"""

from __future__ import annotations

import ctypes

import torch

from hvi_cidnet_torch.ops import iel
from hvi_cidnet_torch.ops._build import DTYPE_CODES, CudaKernel, check_input, twin_backward

_p, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
IEL_BRANCH = CudaKernel("iel_branch", [_p, _p, _i, _p, _p, _i64, _i, _i, _i])


def iel_branch_plain(y: torch.Tensor, w_dw1: torch.Tensor, w_dw2: torch.Tensor) -> torch.Tensor:
    """Twin of K7."""
    return iel.iel_branch(y, w_dw1, w_dw2)


def _taps(wt: torch.Tensor, y: torch.Tensor, name: str) -> torch.Tensor:
    c = y.shape[1]
    if tuple(wt.shape) != (c, 1, 3, 3) or wt.device != y.device:
        raise ValueError(
            f"{name}: expected a ({c}, 1, 3, 3) depthwise weight on {y.device}, got "
            f"{tuple(wt.shape)} on {wt.device}"
        )
    wt = wt.to(y.dtype)
    if not wt.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return wt


def iel_branch_kernel(y: torch.Tensor, w_dw1: torch.Tensor, w_dw2: torch.Tensor) -> torch.Tensor:
    """Launch K7 on contiguous NCHW ``y`` on the card."""
    check_input(y, "y", 4)
    b, c, h, w = y.shape
    w1, w2 = _taps(w_dw1, y, "w_dw1"), _taps(w_dw2, y, "w_dw2")
    out = torch.empty_like(y)
    IEL_BRANCH(y.device, y.data_ptr(), out.data_ptr(), DTYPE_CODES[y.dtype], w1.data_ptr(),
               w2.data_ptr(), b * c, c, h, w)
    return out


class _IelBranch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, w_dw1, w_dw2):
        ctx.save_for_backward(y, w_dw1, w_dw2)
        return iel_branch_kernel(y, w_dw1, w_dw2)

    @staticmethod
    def backward(ctx, grad):
        return twin_backward(iel_branch_plain, ctx.saved_tensors, grad, ctx.needs_input_grad)


def iel_branch(y: torch.Tensor, w_dw1: torch.Tensor, w_dw2: torch.Tensor) -> torch.Tensor:
    """The IEL gate branch. CPU: twin; CUDA: K7."""
    if y.device.type == "cpu":
        return iel_branch_plain(y, w_dw1, w_dw2)
    return _IelBranch.apply(y, w_dw1, w_dw2)
