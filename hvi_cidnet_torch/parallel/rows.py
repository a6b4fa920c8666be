"""Row groups: one image's rows split over shards, one host thread a shard.

PyTorch has no GSPMD, so where the JAX ``spatial_enhance_fn`` hands the
forward to the partitioner, the port runs the single-device forward
(``models/cidnet.py:_hvi_and_noise``) on each shard's rows and lets the few
ops that reach across rows talk to the other shards:

* a **halo** (``Shard.extend``): the neighbours' edge rows, as many as the
  op reads, taken from as many shards as hold them (a 7x7 conv at a level
  where a shard owns two rows reads two shards up); zero rows, copies of
  the edge row, or no rows at the image's top and bottom;
* a **sum** or **max** (``Shard.sum``, ``Shard.max``): every shard's
  partial, gathered in rank order onto each shard and combined in that
  fixed order, so every shard holds the same bits;
* a **gather** (``Shard.gather``): every shard's tensor in rank order.

Each shard's thread sets its ``Shard`` as a thread-local context
(``current()``); an op with no context runs as it always did, with no extra
launch or copy. A ``RowGroup`` holds the collectives' state: a
``threading.Barrier`` with a timeout and two banks of per-rank slots (a
rank writes bank k % 2 at its k-th exchange: by then every rank has passed
exchange k - 1's barrier and so has read exchange k - 2's bank). A tensor
of another device is copied with ``.to(device)``, which orders the copy
after both devices' current streams; on a repeated device a halo is a
slice. All shards of a level own the same number of rows (the pad-to-mesh
rule makes it so), so a shard's global row offset at a level is its rank
times its row count there.

``run_groups`` drives the shards: if one fails, every barrier is aborted,
the others raise at their next wait, and the first failure is raised on the
caller's thread. No wait is unbounded.

Two first-use effects made a CPU group's first call in a process differ
from its later ones, and both are settled before the shards start:

* each shard's thread takes the caller's intra-op thread count. A new
  thread does not: ``torch.set_num_threads`` sets MKL's count for the
  calling thread only (``mkl_set_num_threads_local``), and torch applies
  its count to another thread lazily, at that thread's first
  ``at::parallel_for`` over a large tensor, after a small shard's first
  MKL product (a dense conv's GEMM, K5's partial sums), which MKL then ran
  on every core;
* the CPU's math libraries take their first calls on the caller's thread
  (``cpu_libraries_ready``). When several threads made the process's first
  call of one of MKL's vector-math (VML) functions at once, one of them,
  now and then, got other bits than every later call: ``torch.sin`` on
  four new threads at once, in a fresh process, differed from the same
  call made after in 17 of 300 processes, and in none of 300 after one
  ``torch.sin`` on the starting thread. K1's plain version (the hue's sin
  and cos) met it on one shard and moved the first frame 2.2e-5.
"""

from __future__ import annotations

import contextlib
import functools
import queue
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

TIMEOUT = 300.0  # seconds a shard waits at a barrier, and the caller for a shard


class RowGroup:
    """The collectives of the shards of one image (``devices[r]`` is rank r's)."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = tuple(torch.device(d) for d in devices)
        self.size = len(self.devices)
        self.timeout = TIMEOUT
        self._barrier = threading.Barrier(self.size, timeout=self.timeout)
        self._banks = ([None] * self.size, [None] * self.size)
        self._turns = [0] * self.size

    def exchange(self, rank: int, value) -> list:
        """Every rank's ``value`` in rank order; every rank calls this the
        same number of times, in the same order."""
        bank = self._banks[self._turns[rank] & 1]
        self._turns[rank] += 1
        bank[rank] = value
        self._barrier.wait()
        return list(bank)

    def abort(self) -> None:
        self._barrier.abort()


class Shard:
    """One rank of a ``RowGroup``: the context its thread's ops consult."""

    def __init__(self, group: RowGroup, rank: int):
        self.group = group
        self.rank = rank
        self.size = group.size
        self.device = group.devices[rank]

    def gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t``, in rank order, on this rank's device."""
        return [x.to(self.device) for x in self.group.exchange(self.rank, t)]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` added in rank order (the same bits on every rank)."""
        parts = self.gather(t)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def max(self, t: torch.Tensor) -> torch.Tensor:
        parts = self.gather(t)
        top = parts[0]
        for p in parts[1:]:
            top = torch.maximum(top, p)
        return top

    def extend(self, t: torch.Tensor, above: int, below: int,
               edge: Optional[str] = None) -> Tuple[torch.Tensor, int]:
        """``t`` (rows on dim -2, this rank's block of the image) with the
        ``above`` global rows before its block and the ``below`` after it.
        Past the image's top or bottom: ``edge`` "zero" adds zero rows,
        "replicate" copies of the image's edge row, None no rows. Returns
        (the band, the rows added above)."""
        blocks = self.group.exchange(self.rank, t)
        m = t.shape[-2]
        first, height = self.rank * m, m * self.size

        def rows(lo: int, hi: int) -> List[torch.Tensor]:
            """Global rows [lo, hi) (inside the image) from their owners."""
            out = []
            for s in range(lo // m, -(-hi // m)):
                a, b = max(lo, s * m), min(hi, (s + 1) * m)
                out.append(blocks[s].narrow(-2, a - s * m, b - a).to(self.device))
            return out

        def outside(count: int, edge_row: int) -> List[torch.Tensor]:
            if count <= 0 or edge is None:
                return []
            if edge == "zero":
                shape = (*t.shape[:-2], count, t.shape[-1])
                return [torch.zeros(shape, dtype=t.dtype, device=self.device)]
            row = rows(edge_row, edge_row + 1)[0]
            return [row.expand(*t.shape[:-2], count, t.shape[-1])]

        lo, hi = max(0, first - above), min(height, first + m + below)
        top = outside(above - (first - lo), 0)
        bottom = outside(below - (hi - first - m), height - 1)
        parts = top + rows(lo, first) + [t] + rows(first + m, hi) + bottom
        added = sum(p.shape[-2] for p in top) + first - lo
        return (torch.cat(parts, dim=-2) if len(parts) > 1 else t), added


_local = threading.local()


def current() -> Optional[Shard]:
    """The calling thread's shard, or None outside a row group."""
    return getattr(_local, "shard", None)


@contextlib.contextmanager
def shard_context(shard: Optional[Shard]):
    """Run the body as ``shard`` (None: as no shard), then restore."""
    saved = current()
    _local.shard = shard
    try:
        yield
    finally:
        _local.shard = saved


def suspended():
    """The body's ops run on the tensors they are given, as no shard (a
    kernel's plain version computing on a band another op assembled)."""
    return shard_context(None)


# the unary ops torch computes with MKL's VML on the CPU (ATen/cpu/vml.h)
VML_OPS = (torch.acos, torch.asin, torch.atan, torch.cos, torch.erf, torch.erfc, torch.erfinv,
           torch.exp, torch.log, torch.log10, torch.log2, torch.sin, torch.sqrt, torch.tan,
           torch.tanh, torch.trunc)


@functools.lru_cache(maxsize=None)
def cpu_libraries_ready() -> None:
    """Give MKL and oneDNN their first calls in this process on this
    thread, once a process: each VML function, and one of each product the
    shards' ops reach on the CPU (a GEMM, a batched GEMM, a dense and a
    depthwise conv)."""
    with torch.no_grad():
        v = torch.full((64,), 0.5)
        for op in VML_OPS:
            op(v)
        a = torch.ones(16, 16)
        torch.mm(a, a)
        torch.bmm(a[None], a[None])
        x = torch.ones(1, 4, 8, 8)
        F.conv2d(x, torch.ones(4, 4, 3, 3), padding=1)
        F.conv2d(x, torch.ones(4, 1, 3, 3), padding=1, groups=4)


def run_groups(groups: Sequence[RowGroup], fn: Callable[[Shard], object]) -> List[list]:
    """``fn(shard)`` for every rank of every group, one thread a rank, under
    ``torch.cuda.device`` for a card's shard. Returns each group's results
    in rank order. If a rank raises, every group's barrier is aborted and
    the first failure (by group and rank; a rank's own error before the
    broken barriers it caused) is raised here; a rank that does not finish
    within the timeout after the last one did raises ``TimeoutError``."""
    shards = [Shard(g, r) for g in groups for r in range(g.size)]
    threads_per_op = torch.get_num_threads()
    if any(s.device.type == "cpu" for s in shards):
        cpu_libraries_ready()
    results: list = [None] * len(shards)
    errors: list = [None] * len(shards)
    finished: queue.Queue = queue.Queue()

    def abort_all() -> None:
        for g in groups:
            g.abort()

    def body(i: int) -> None:
        shard = shards[i]
        try:
            torch.set_num_threads(threads_per_op)  # the caller's, for MKL too (module note)
            card = shard.device.type == "cuda"
            with torch.cuda.device(shard.device) if card else contextlib.nullcontext(), \
                    shard_context(shard):
                results[i] = fn(shard)
        except BaseException as e:  # noqa: BLE001 (re-raised on the caller's thread)
            errors[i] = e
            abort_all()
        finally:
            finished.put(i)

    threads = [threading.Thread(target=body, args=(i,), daemon=True,
                                name=f"row-shard-{i}") for i in range(len(shards))]
    for th in threads:
        th.start()
    wait = max(g.timeout for g in groups)
    for _ in threads:
        try:
            finished.get(timeout=wait)
        except queue.Empty:
            abort_all()
            late = [th.name for th in threads if th.is_alive()]
            raise TimeoutError(f"row group: {', '.join(late)} did not finish within {wait} s")
    own = [e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    broken = [e for e in errors if e is not None]
    if own:
        raise own[0]
    if broken:
        raise TimeoutError(f"row group: a shard waited more than {wait} s at a barrier") \
            from broken[0]
    out, i = [], 0
    for g in groups:
        out.append(results[i:i + g.size])
        i += g.size
    return out
