"""The fused block route: which of the fused kernels the forward takes.

Three switches, after the JAX experiments' gates
(``experiments/iel_pallas_nhcw.py:should_use_fused_iel``,
``experiments/fused_pallas_nhcw.py:should_use_fused_down``,
``experiments/conv_pallas_nhcw.py:should_use_pallas_conv``), each with the
port's own environment override:

* ``ln_iel`` (``HVI_TORCH_LN_IEL``): every LCA's IEL with its LayerNorm
  (and I_LCA's residual) as one kernel, P2/P3 (``ops/ln_iel_cuda.py``),
  in place of K6 + 2 x K7 and the 1x1 convs;
* ``down`` (``HVI_TORCH_FUSED_DOWN``): NormDownsample's conv, x0.5 and
  PReLU as one kernel, P5 (``ops/conv3x3_cuda.py``), in place of the conv
  and K3;
* ``conv3x3`` (``HVI_TORCH_CONV3X3``): every other dense 3x3 conv (the
  replication-padded stems and heads, NormUpsample's folded conv, and
  NormDownsample's when ``down`` is off) as P4.

All three default to off: the JAX package's forward takes none of these
routes (its HWCB layout replaced the NHCW one they were written for).
Turning a default on is a measured decision. An override reads "1" (on) or
"0" (off); an explicit ``Routes`` passed to the forward wins over the
environment. On the CPU every route runs its kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import os

ENV = {"ln_iel": "HVI_TORCH_LN_IEL", "down": "HVI_TORCH_FUSED_DOWN",
       "conv3x3": "HVI_TORCH_CONV3X3"}


@dataclasses.dataclass(frozen=True)
class Routes:
    ln_iel: bool = False
    down: bool = False
    conv3x3: bool = False


UNFUSED = Routes()
FUSED = Routes(ln_iel=True, down=True, conv3x3=True)


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
