"""Tracing and profiling helpers: the port's observability layer.

Counterpart of ``hvi_cidnet_tpu/utils/profiling.py``, with its names:

* :func:`trace`: a context manager around ``torch.profiler`` (CPU and CUDA
  activity where a card is present, CPU only elsewhere) that writes a
  Chrome trace, ``<time ns>.<pid>.pt.trace.json``, under ``log_dir``;
* :func:`op_breakdown`: the newest trace in ``log_dir`` as device time in
  us summed by kernel name (the CPU ops' time where the trace has no
  device events);
* :func:`model_card`: the operations of one call (``utils/flops.py``: the
  same number on the card and on the CPU), ``bytes_accessed`` and the
  seconds a call takes behind a completion barrier;
* :class:`StepTimer`: rolling per-step timing for training loops;
* :class:`scope`: the port's ``jax.named_scope``. The forward opens one
  around each region the JAX forward names (``models/cidnet.py``,
  ``models/layers.py``, ``models/tnsm.py``): an NVTX range on a CUDA build
  and, while a ``torch.profiler`` is recording, a ``record_function``
  (``user_annotation`` events in the trace). It launches nothing.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import re
import time
from typing import Dict, Optional

import torch

from hvi_cidnet_torch.utils import flops

try:  # CUDA builds
    from torch._C import _nvtx
except ImportError:
    _nvtx = None
_profiler_enabled = torch._C._autograd._profiler_enabled
_record_function = torch.autograd.profiler.record_function

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_SUFFIX = ".pt.trace.json"
RANGES: set = set()  # the names ``scope`` has opened under a profiler


class scope:
    """``with scope("HV_LCA1"): ...``: an NVTX range (CUDA builds) and, only
    while a profiler records, a ``record_function`` of the same name."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self) -> "scope":
        if _nvtx is not None:
            _nvtx.rangePushA(self.name)
        if _profiler_enabled():
            RANGES.add(self.name)
            self._rf = _record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if _nvtx is not None:
            _nvtx.rangePop()


def is_range(event) -> bool:
    """Whether a ``torch.profiler`` event (or a ``key_averages()`` row) is a
    range that ``scope`` opened, on the host or, with CUDA activity, as the
    profiler projects it onto the device: it is neither an op nor a kernel,
    and must not add to their counts or times."""
    return bool(getattr(event, "is_user_annotation", False)) or \
        getattr(event, "key", getattr(event, "name", None)) in RANGES


@contextlib.contextmanager
def trace(log_dir: str, *, cuda: Optional[bool] = None):
    """``with trace('/tmp/trace'): run_steps()`` -> a Chrome trace on disk.
    ``cuda``: record the card's activity (default: when a card is
    present); the card is synchronised before the trace closes."""
    cuda = torch.cuda.is_available() if cuda is None else cuda
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"{time.time_ns():020d}.{os.getpid()}"
                                                   f"{TRACE_SUFFIX}"))


def kernel_name(name: str) -> str:
    """A trace event's name without its argument list (the last balanced
    ``(...)``), its ``void`` return type and a numeric ``.N`` suffix."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip()
                break
    if name.startswith("void "):
        name = name[5:]
    return re.sub(r"\.\d+$", "", name)


def newest_trace(log_dir: str) -> str:
    paths = glob.glob(os.path.join(log_dir, f"*{TRACE_SUFFIX}"))
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    return max(paths, key=lambda p: (os.path.getmtime(p), p))


def op_breakdown(log_dir: str, top: int = 20) -> Dict[str, float]:
    """Device time (us) of the newest trace in ``log_dir``, summed by
    kernel name (``kernel_name``), largest first; with no device events (a
    CPU trace), the CPU ops' time the same way."""
    with open(newest_trace(log_dir)) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("dur")]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    chosen = device or [e for e in events if e.get("cat") == "cpu_op"]
    agg: collections.Counter = collections.Counter()
    for e in chosen:
        agg[kernel_name(e.get("name", ""))] += float(e["dur"])
    return dict(agg.most_common(top))


def _first_tensor(out) -> Optional[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def _barrier(out) -> None:
    """Wait for ``out``: the card synchronised, else one element fetched."""
    t = _first_tensor(out)
    if t is None:
        return
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    elif t.numel():
        t.reshape(-1)[0].item()


def model_card(fn, *args, iters: int = 10) -> Dict[str, float]:
    """``fn(*args)``'s operations (``flops``: its first call counted by
    ``utils/flops.py``, the kernels by their formulas, so the card and the
    CPU give one number), ``bytes_accessed`` (nan: XLA's cost analysis
    estimates it from the compiled program, and PyTorch has no such
    estimate) and ``seconds_per_call`` over ``iters`` calls after that
    warm-up, ended by a completion barrier (``torch.cuda.synchronize`` on
    the card, else a host fetch of one element of the output). Run it
    under ``torch.no_grad()`` to time inference."""
    with flops.count() as counted:
        out = fn(*args)  # warm-up
    _barrier(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _barrier(out)
    return {
        "flops": float(counted.total),
        "bytes_accessed": float("nan"),
        "seconds_per_call": (time.perf_counter() - t0) / iters,
    }


class StepTimer:
    """Rolling average step timer for training loops."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: collections.deque = collections.deque(maxlen=window)
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now
        return self.mean()

    def mean(self) -> Optional[float]:
        return sum(self._times) / len(self._times) if self._times else None
