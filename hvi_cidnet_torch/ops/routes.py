"""The routes through the forward: which of the experiments' kernels the
forward takes in place of the default ones.

The fused block route, three switches after the JAX experiments' gates
(``experiments/iel_pallas_nhcw.py:should_use_fused_iel``,
``experiments/fused_pallas_nhcw.py:should_use_fused_down``,
``experiments/conv_pallas_nhcw.py:should_use_pallas_conv``):

* ``ln_iel`` (``HVI_TORCH_LN_IEL``): every LCA's IEL with its LayerNorm
  (and I_LCA's residual) as one kernel, P2/P3 (``ops/ln_iel_cuda.py``),
  in place of K6 + 2 x K7 and the 1x1 convs;
* ``down`` (``HVI_TORCH_FUSED_DOWN``): NormDownsample's conv, x0.5 and
  PReLU as one kernel, P5 (``ops/conv3x3_cuda.py``), in place of the conv
  and K3;
* ``conv3x3`` (``HVI_TORCH_CONV3X3``): every other dense 3x3 conv (the
  replication-padded stems and heads, NormUpsample's folded conv, and
  NormDownsample's when ``down`` is off) as P4.

The probe route, two switches:

* ``head_attn`` (``HVI_TORCH_HEAD_ATTN``): every attention site off K5.
  The normalised ones (the CABs) run P1 per head (``ops/head_attention_
  cuda.py``) and ``project_out`` as a 1x1 conv after it; TNSM's
  unnormalised ones take their scores from P10/P15 (``ops/batched_qk_
  cuda.py``), then the temperature, an fp32 softmax and the value
  product as plain ops, then ``project_out``;
* ``im2col`` (``HVI_TORCH_IM2COL``): every dense 3x3 conv that ``down``
  does not take as an im2col operand staged by ``F.unfold`` and P6's
  products (``ops/im2col_cuda.py``). ``im2col`` and ``conv3x3`` name two
  kernels for the same convs: both on raises ``ValueError``.

Every switch defaults to off: the JAX package's forward takes none of these
routes. Turning a default on is a measured decision. An override reads "1"
(on) or "0" (off); an explicit ``Routes`` passed to the forward wins over
the environment. On the CPU every route runs its kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

ENV = {"ln_iel": "HVI_TORCH_LN_IEL", "down": "HVI_TORCH_FUSED_DOWN",
       "conv3x3": "HVI_TORCH_CONV3X3", "head_attn": "HVI_TORCH_HEAD_ATTN",
       "im2col": "HVI_TORCH_IM2COL"}


@dataclasses.dataclass(frozen=True)
class Routes:
    ln_iel: bool = False
    down: bool = False
    conv3x3: bool = False
    head_attn: bool = False
    im2col: bool = False

    def __post_init__(self):
        if self.im2col and self.conv3x3:
            raise ValueError("routes: im2col and conv3x3 both take the dense 3x3 convs; "
                             "turn one of them off")


UNFUSED = Routes()
FUSED = Routes(ln_iel=True, down=True, conv3x3=True)
PROBE = Routes(head_attn=True, im2col=True)


def from_env(default: Routes = UNFUSED) -> Routes:
    """``default`` with each switch its environment variable names set."""
    flags = {}
    for field, var in ENV.items():
        value = os.environ.get(var)
        if value is None:
            continue
        if value not in ("0", "1"):
            raise ValueError(f"{var}={value!r}: expected 0 or 1")
        flags[field] = value == "1"
    return dataclasses.replace(default, **flags)


def resolve(routes: "Routes | None") -> Routes:
    """The routes a forward takes: ``routes`` if given, else the defaults
    with the environment's overrides."""
    return from_env() if routes is None else routes


def add_flags(parser: argparse.ArgumentParser) -> None:
    """The CLIs' route flags, ``--fused`` and ``--probe``, at most one."""
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--fused", action="store_true",
                       help="take the fused block route (P2/P3, P4, P5; ops/routes.py)")
    group.add_argument("--probe", action="store_true",
                       help="take the probe route (P1, P6, P10/P15; ops/routes.py)")


def from_flags(args: argparse.Namespace) -> Optional[Routes]:
    """The route the flags name, or None (the defaults with the
    environment's overrides)."""
    return FUSED if args.fused else PROBE if args.probe else None
