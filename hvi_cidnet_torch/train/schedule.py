"""Learning-rate schedules: gradual warmup + cosine annealing with restarts.

This package's own copy of ``hvi_cidnet_tpu/train/schedule.py`` (that
package is not importable without jax), line for line: pure-python
epoch -> lr functions replacing the reference's torch scheduler chain
(data/scheduler.py:5-172, wired in train.py:165-181). The reference steps
its scheduler once per epoch; ``lr_for_epoch(completed_epochs)`` gives the
lr used during the following epoch, matching ``_LRScheduler.last_epoch``
semantics (lr during epoch 1 corresponds to last_epoch=0).
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Callable, Sequence


def cosine_restart(
    base_lr: float,
    periods: Sequence[int],
    restart_weights: Sequence[int] = (1,),
    eta_mins: Sequence[float] = (0.0,),
) -> Callable[[int], float]:
    """CosineAnnealingRestart(Cyclic)LR (scheduler.py:85-172).

    ``eta_mins`` of length 1 replicates CosineAnnealingRestartLR; longer
    sequences give the per-period eta_min of the Cyclic variant.
    """
    assert len(periods) == len(restart_weights)
    cumulative = [sum(periods[: i + 1]) for i in range(len(periods))]
    if len(eta_mins) == 1:
        eta_mins = list(eta_mins) * len(periods)

    def lr(epoch: int) -> float:
        # right-closest index (scheduler.py:66-82); clamp into final period
        idx = min(bisect_left(cumulative, epoch), len(periods) - 1)
        nearest_restart = 0 if idx == 0 else cumulative[idx - 1]
        period = periods[idx]
        w = restart_weights[idx]
        eta = eta_mins[idx]
        return eta + w * 0.5 * (base_lr - eta) * (
            1 + math.cos(math.pi * (epoch - nearest_restart) / period)
        )

    return lr


def gradual_warmup(
    base_lr: float,
    total_epoch: int,
    after: Callable[[int], float],
    multiplier: float = 1.0,
) -> Callable[[int], float]:
    """GradualWarmupScheduler with multiplier=1 (scheduler.py:5-63):
    lr ramps 0 -> base over ``total_epoch`` then chains into ``after``.

    The torch chain's first post-warmup epoch re-emits the chained
    scheduler's epoch-0 lr (its ``last_epoch`` only starts advancing on the
    following ``step()``), so the cosine lags warmup-end by one epoch —
    reproduced with the ``- 1`` below (parity-tested vs the reference).
    """

    def lr(epoch: int) -> float:
        if epoch > total_epoch:
            return after(epoch - total_epoch - 1)
        if multiplier == 1.0:
            return base_lr * epoch / total_epoch
        return base_lr * ((multiplier - 1.0) * epoch / total_epoch + 1.0)

    return lr


def build_reference_schedule(
    lr: float,
    n_epochs: int,
    *,
    start_epoch: int = 0,
    warmup_epochs: int = 3,
    start_warmup: bool = True,
    cos_restart: bool = True,
    cos_restart_cyclic: bool = False,
) -> Callable[[int], float]:
    """The trainer's scheduler menu (train.py:165-181), same arithmetic."""
    if cos_restart_cyclic:
        if start_warmup:
            after = cosine_restart(
                lr,
                [n_epochs // 4 - warmup_epochs, (n_epochs * 3) // 4],
                [1, 1],
                [0.0002, 0.0000001],
            )
            return gradual_warmup(lr, warmup_epochs, after)
        return cosine_restart(lr, [n_epochs // 4, (n_epochs * 3) // 4], [1, 1], [0.0002, 0.0000001])
    if cos_restart:
        if start_warmup:
            after = cosine_restart(lr, [n_epochs - warmup_epochs - start_epoch], [1], [1e-7])
            return gradual_warmup(lr, warmup_epochs, after)
        return cosine_restart(lr, [n_epochs - start_epoch], [1], [1e-7])
    raise ValueError("choose a scheduler (cos_restart or cos_restart_cyclic)")
