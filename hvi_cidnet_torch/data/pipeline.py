"""Host-side training data pipeline: threaded decode/augment, bounded
prefetch, copy to the card.

Counterpart of ``TrainLoader`` in ``hvi_cidnet_tpu/data/pipeline.py``
(replacing the reference's ``DataLoader(num_workers=16)``, train.py:108),
with the same seed stream, so one seed gives the same batches in either
package: a permutation per epoch (when shuffling) and, per batch, one seed
``integers(0, 2**31)`` per sample, each sample augmented by its own
``default_rng(seed)``; with ``batch_rows`` only that slice of each batch
is decoded, after the full batch's seeds are drawn. Decode
(``data/png.py``: zlib releases the GIL) runs on a thread pool; a
producer thread keeps up to ``prefetch`` batches ready. Batches come out
as NHWC fp32: host numpy when ``device`` is None, else tensors pinned by
the producer and copied to ``device`` with ``non_blocking=True`` on the
consumer thread, so the copy overlaps the step still running. ``eval_batches`` yields an eval set one image at a
time, as the JAX ``eval_batches`` does.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch


class TrainLoader:
    """Shuffled batch iterator over a dataset with ``sample(index, rng)``."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        seed: int = 0,
        num_threads: int = 8,
        shuffle: bool = True,
        prefetch: int = 4,
        device: Optional[Union[str, torch.device]] = None,
        batch_rows: Optional[slice] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.device = None if device is None else torch.device(device)
        # decode only this row range of every batch while still drawing the
        # augmentation seeds of the full batch: a multi-process rank's slice
        # (parallel/multihost.py), with one seed stream in every rank
        self.batch_rows = batch_rows
        self._rng = np.random.default_rng(seed)
        self.steps_per_epoch = max(1, len(dataset) // batch_size)
        self._pool = ThreadPoolExecutor(max_workers=num_threads)

    def close(self):
        self._pool.shutdown(wait=False)

    def _make_batch(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        seeds = self._rng.integers(0, 2**31, size=len(indices))
        if self.batch_rows is not None:
            indices = indices[self.batch_rows]
            seeds = seeds[self.batch_rows]

        def one(args):
            idx, s = args
            return self.dataset.sample(int(idx), np.random.default_rng(int(s)))

        pairs = list(self._pool.map(one, zip(indices, seeds)))
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    def _host(self, batch):
        """On the producer thread: numpy, or pinned tensors for the card."""
        if self.device is None or self.device.type != "cuda":
            return batch
        return tuple(torch.from_numpy(a).pin_memory() for a in batch)

    def epoch(self) -> Iterator[Tuple]:
        """One epoch of batches, prefetched."""
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        if n < self.batch_size:
            # a dataset smaller than one batch resamples (with wraparound)
            # to a full batch, as the JAX loader does (its jitted step needs
            # static shapes); a torch DataLoader would emit a short batch
            order = np.tile(order, -(-self.batch_size // n))[: self.batch_size]
        steps = self.steps_per_epoch
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failed = []

        def producer():
            try:
                for s in range(steps):
                    if stop.is_set():
                        return
                    idx = order[s * self.batch_size : (s + 1) * self.batch_size]
                    q.put(self._host(self._make_batch(idx)))
            except Exception as e:  # handed to the consumer, which raises it
                failed.append(e)
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if failed:
                        raise failed[0]
                    return
                lows, highs = item
                if self.device is None:
                    yield lows, highs
                elif self.device.type == "cuda":
                    yield (lows.to(self.device, non_blocking=True),
                           highs.to(self.device, non_blocking=True))
                else:
                    yield torch.from_numpy(lows), torch.from_numpy(highs)
        finally:
            stop.set()
            while t.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.01)


def eval_batches(dataset, device=None):
    """Yield ``(image[1, H, W, 3], name, orig_h, orig_w)`` per eval file:
    host numpy when ``device`` is None, else a tensor on ``device``."""
    for i in range(len(dataset)):
        item = dataset[i]
        if len(item) == 4:
            img, name, h, w = item
        else:
            img, name = item
            h, w = img.shape[:2]
        x = img[None]
        if device is not None:
            x = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        yield x, name, h, w
