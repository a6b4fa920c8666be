"""LayerNorm + IEL (+ residual) in plain PyTorch: the plain version of the
fused kernel P2/P3 (``ops/ln_iel_cuda.py``, ``csrc/ln_iel.cu``).

Counterpart of the JAX experiments ``fused_iel``
(``experiments/iel_fused_pallas.py``) and ``_pallas_ln_iel``
(``experiments/iel_pallas_nhcw.py``), which compute one function on NHCW:

    t = LayerNorm(x)                                   # channel LN, eps 1e-6
    h1, h2 = dw(pi(t)) split in halves                 # 1x1 to 2 * hidden, dw 3x3
    out = po((tanh(dw1(h1)) + h1) * (tanh(dw2(h2)) + h2)) [+ x]

(reference net/LCA.py:45-67 with the LCA's pre-norm and, for I_LCA, its
residual, :71-93). Here on NCHW with the port's OIHW weights, sliced as the
port's ``IEL`` slices them (``models/layers.py``): ``w_pi[:hidden]`` and
``w_dw[:hidden]`` feed the ``dwconv1`` half.

The contract of the fused kernel: the input is upcast to fp32 and every
stage runs in fp32 with TF32 off (the weights are taken in the activation
dtype, as every conv of the port takes them, then widened); the result is
cast back to the input dtype once. In bf16 this differs on purpose from the
unfused chain, which rounds to bf16 between stages.
"""

from __future__ import annotations

import torch

from hvi_cidnet_torch.ops.conv import conv1x1, exact_fp32, layer_norm_channels
from hvi_cidnet_torch.ops.iel import iel_branch

EPS = 1e-6


def ln_iel(
    x: torch.Tensor,
    ln_w: torch.Tensor,
    ln_b: torch.Tensor,
    w_pi: torch.Tensor,
    w_dw: torch.Tensor,
    w_dw1: torch.Tensor,
    w_dw2: torch.Tensor,
    w_po: torch.Tensor,
    residual: bool,
) -> torch.Tensor:
    """``x``: NCHW (B, C, H, W). ``ln_w``, ``ln_b``: (C,). ``w_pi``: (2 *
    hidden, C, 1, 1); ``w_dw``: (2 * hidden, 1, 3, 3); ``w_dw1``, ``w_dw2``:
    (hidden, 1, 3, 3); ``w_po``: (C, hidden, 1, 1). Returns x's shape and
    dtype."""
    dt = x.dtype
    hidden = w_pi.shape[0] // 2

    def f32(w):
        return w.to(dt).float()

    with exact_fp32():
        x32 = x.float()
        t = layer_norm_channels(x32, ln_w.float(), ln_b.float(), EPS)
        w_pi32, w_dw32 = f32(w_pi), f32(w_dw)
        g1 = iel_branch(conv1x1(t, w_pi32[:hidden]), w_dw32[:hidden], f32(w_dw1))
        g2 = iel_branch(conv1x1(t, w_pi32[hidden:]), w_dw32[hidden:], f32(w_dw2))
        out = conv1x1(g1 * g2, f32(w_po))
        if residual:
            out = out + x32
    return out.to(dt)
