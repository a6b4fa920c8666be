"""The operation count of a forward: one number, whichever device runs it.

``torch.utils.flop_counter.FlopCounterMode`` sees aten ops only. On the
card the kernels K1-K7 and the route kernels (P1-P6, P10/P15) run through
``ctypes`` and it sees none of them; on the CPU their plain versions run as
aten ops and it counts those instead (the resizes' band matrices as dense
products, far above the work a resize does). So each kernel's dispatcher
(``ops/*_cuda.py``) reports its kernel's own formula here, ``kernel_ops``
(the operations its bound in ``chip_smoke.py`` reckons), and hides the
aten ops inside it from the flop counter, on the CPU as on the card.
Dense convs and plain products outside the kernels are counted by
``FlopCounterMode`` as before.

    with flops.count() as c:
        cidnet_forward(model, x)
    c.total   # aten ops outside the kernels + the kernels' formulas

A count sees the ops of the thread that opened it, as ``FlopCounterMode``
does (a dispatch mode is thread-local). Outside a count the dispatchers'
hook costs one global read.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict

import torch

# nominal fp32 operations per output element of the kernels whose work is
# not a product (CUDA-core arithmetic)
OPS_PER_ELEMENT = {"K1": 40, "K2": 50, "K3": 24, "K4": 12, "K6": 8, "K7": 38}


def kernel_ops(key: str, x: torch.Tensor, *, heads: int = 1, fold: bool = True,
               c: int = 0, cout: int = 0) -> int:
    """The operations kernel ``key`` does on input ``x``:

    * K1, K2 (x: the RGB or HVI tensor), K3, K4, K6, K7 (x: the input):
      ``OPS_PER_ELEMENT`` a pixel (K1, K2) or an output element;
    * K5 (x: q, NCHW): the block-diagonal q.k^T, the norms and the apply,
      with ``project_out`` folded in or not;
    * P2/P3 (x: NCHW): the LayerNorm, both 1x1 products, both depthwise
      convs of both halves, tanh and add, the product and the residual;
      P4 and P5 (x: NCHW, ``cout`` outputs): the 3x3 products (P5: with
      K3's x0.5 + PReLU);
    * P1 and P10/P15 (x: (G, c, N) q): the per-head scores (and for P1 the
      norms and the apply); P6 (x: the (B, K, N) staged operand): the
      products.
    """
    n_el = x.numel()
    if key in ("K1", "K2"):
        return OPS_PER_ELEMENT[key] * n_el // 3
    if key == "K3":
        return OPS_PER_ELEMENT[key] * n_el // 4
    if key == "K4":
        return OPS_PER_ELEMENT[key] * 4 * n_el
    if key in ("K6", "K7"):
        return OPS_PER_ELEMENT[key] * n_el
    if key == "K5":
        b, ch = x.shape[:2]
        cp, n = ch // heads, n_el // (b * ch)
        return 2 * b * ch * cp * n + 4 * b * ch * n + 2 * b * ch * (ch if fold else cp) * n
    if key in ("P2/P3", "P4", "P5"):
        b, ch, h, w = x.shape
        px = b * h * w
        if key == "P2/P3":
            hid = int(ch * 2.66)
            return px * (8 * ch + 2 * 3 * hid * ch + 4 * 2 * hid * 9 + 4 * hid + hid + ch)
        ops = 2 * px * cout * ch * 9
        return ops + (24 * b * cout * (h // 2) * (w // 2) if key == "P5" else 0)
    if key == "P6":
        b, k, n = x.shape
        return 2 * b * cout * k * n
    g, _, n = x.shape
    if key == "P1":
        return 4 * g * c * c * n + 4 * g * c * n
    if key == "P10/P15":
        return 2 * g * c * c * n
    raise KeyError(f"no operation count for kernel {key!r}")


_local = threading.local()
_open = 0          # counts open on any thread: the dispatchers' fast path
_open_lock = threading.Lock()
_IDLE = contextlib.nullcontext()


def _counts() -> list:
    stack = getattr(_local, "counts", None)
    if stack is None:
        stack = _local.counts = []
    return stack


class count:
    """A context manager counting the operations of the ops run on this
    thread inside it: ``aten`` (``FlopCounterMode``'s, the kernels' insides
    hidden), ``kernels`` (by kernel, their formulas) and ``total``."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode

        self.kernels: Dict[str, int] = collections.Counter()
        self._mode = FlopCounterMode(display=False)

    def __enter__(self) -> "count":
        global _open
        self._mode.__enter__()
        _counts().append(self)
        with _open_lock:
            _open += 1
        return self

    def __exit__(self, *exc) -> None:
        global _open
        with _open_lock:
            _open -= 1
        _counts().remove(self)
        self._mode.__exit__(*exc)

    @property
    def aten(self) -> int:
        return int(self._mode.get_total_flops())

    @property
    def total(self) -> int:
        return self.aten + sum(self.kernels.values())


@contextlib.contextmanager
def _hidden(key: str, ops: int):
    from torch.utils._python_dispatch import _disable_current_modes

    for c in _counts():
        c.kernels[key] += ops
    _local.depth = 1
    try:
        with _disable_current_modes():
            yield
    finally:
        _local.depth = 0


def kernel(key: str, x: torch.Tensor, **shape):
    """Wrap a kernel's dispatcher body: inside a count on this thread, add
    ``kernel_ops(key, x, **shape)`` to it and hide the body's aten ops (a
    kernel inside another kernel's plain version counts nothing more).
    Elsewhere, nothing."""
    if not _open or not getattr(_local, "counts", None) or getattr(_local, "depth", 0):
        return _IDLE
    return _hidden(key, kernel_ops(key, x, **shape))
