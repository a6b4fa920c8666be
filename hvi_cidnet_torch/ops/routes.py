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
routes. Turning a default on is a measured decision. An environment
override reads "1" (on) or "0" (off); an explicit ``Routes`` passed to the
forward wins over everything. On the CPU every route runs its kernels'
plain versions.

The kernel-flag registry, after ``hvi_cidnet_tpu/ops/pallas_gate.py``
(``kernel_flag``, ``set_kernel_flag``, the scoped ``kernel_flags``): a
switch resolves to its in-process override, else its environment variable,
else its default (``FLAG_DEFAULTS``). ``resolve(None)`` reads the switches
at every forward, so a flip takes effect on the next forward; there is no
jit cache to clear, and the kernels' launch plans are cached per shape
only. Overrides are process-wide, as the JAX ones are: the threads of DP
replicas and row shards see them. The JAX flags with no seam here raise
``KeyError`` with the reason (``NOT_PORTED``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import threading
from typing import Dict, Optional

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


# name -> (environment variable, default): the port's seams
FLAG_DEFAULTS = {field: (var, False) for field, var in ENV.items()}

# the JAX package's flags (pallas_gate.py:_FLAG_DEFAULTS) with no seam here
_ALWAYS_KERNEL = ("on the card the kernel always runs; the plain versions serve the CPU "
                  "and the tests")
_TPU_LAYOUT = "a TPU layout seam, not ported (ROADMAP.md, north star)"
NOT_PORTED = {
    "hvi_pallas": _ALWAYS_KERNEL, "resize_pallas": _ALWAYS_KERNEL,
    "attn_pallas": _ALWAYS_KERNEL, "ln_pallas": _ALWAYS_KERNEL, "iel_pallas": _ALWAYS_KERNEL,
    "ln_stats_conv": _TPU_LAYOUT, "attn_ncb_feed": _TPU_LAYOUT, "hvi_hwb_order": _TPU_LAYOUT,
    "loss_blur_mxu": _TPU_LAYOUT,
    "upsample_fold": "always applied, as an exact rewrite (models/layers.py:NormUpsample)",
}

_overrides: Dict[str, bool] = {}
_overrides_lock = threading.Lock()


def _known(name: str) -> str:
    """The environment variable of flag ``name``; ``KeyError`` if unknown."""
    if name in FLAG_DEFAULTS:
        return FLAG_DEFAULTS[name][0]
    if name in NOT_PORTED:
        raise KeyError(f"kernel flag {name!r} has no seam in the port: {NOT_PORTED[name]}")
    raise KeyError(f"unknown kernel flag {name!r}; known: {sorted(FLAG_DEFAULTS)}")


def _env_flag(var: str) -> Optional[bool]:
    value = os.environ.get(var)
    if value is None:
        return None
    if value not in ("0", "1"):
        raise ValueError(f"{var}={value!r}: expected 0 or 1")
    return value == "1"


def kernel_flag(name: str) -> bool:
    """Resolve a switch: explicit override > environment > default."""
    var = _known(name)
    if name in _overrides:
        return _overrides[name]
    env = _env_flag(var)
    return FLAG_DEFAULTS[name][1] if env is None else env


def set_kernel_flag(name: str, value: Optional[bool]) -> None:
    """Set (True / False) or clear (None) the explicit override of a switch,
    for every thread of the process, from the next forward on."""
    _known(name)
    with _overrides_lock:
        if value is None:
            _overrides.pop(name, None)
        else:
            _overrides[name] = bool(value)


@contextlib.contextmanager
def kernel_flags(**flags: Optional[bool]):
    """Scoped overrides: ``with kernel_flags(ln_iel=True): ...``. The
    overrides from before come back on exit, also on an exception."""
    for name in flags:
        _known(name)
    saved = {name: _overrides.get(name) for name in flags}
    try:
        for name, value in flags.items():
            set_kernel_flag(name, value)
        yield
    finally:
        for name, value in saved.items():
            set_kernel_flag(name, value)


def from_env(default: Routes = UNFUSED) -> Routes:
    """``default`` with each switch its environment variable names set."""
    flags = {}
    for field, var in ENV.items():
        value = _env_flag(var)
        if value is not None:
            flags[field] = value
    return dataclasses.replace(default, **flags)


def resolve(routes: "Routes | None") -> Routes:
    """The routes a forward takes: ``routes`` if given, else every switch
    as ``kernel_flag`` resolves it now."""
    return Routes(**{field: kernel_flag(field) for field in ENV}) if routes is None else routes


def require_default(routes: Routes, what: str) -> None:
    """Raise ``ValueError`` naming each switch ``routes`` turns on (and
    where it was set: an in-process override or its environment
    variable): ``what`` runs the default route only."""
    on = [f"{field} ({'kernel_flags override' if field in _overrides else ENV[field]})"
          for field in ENV if getattr(routes, field)]
    if on:
        raise ValueError(f"{what} runs the default route only, but {', '.join(on)} is on: "
                         "unset the override or pass routes=None")


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
