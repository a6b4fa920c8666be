"""Dataset evaluation: run a weight file over an eval folder, write PNGs.

Counterpart of ``hvi_cidnet_tpu/eval/evaluator.py`` (reference eval.py:40-83):
the HVI gates per dataset family (LOL -> ``gated``; v2 / unpaired ->
``gated2`` + alpha), ``model(input ** gamma)``, clamp, crop away the eval
padding, PNGs into ``output_folder``. ``Evaluator`` is ``serve.Enhancer``
(pad, forward, clip, crop on one device) with the JAX evaluator's bucket
quantum and ``run_dataset``: images grouped by padded shape and run in
batches, decoded and written by host threads while the card computes.
With a ``mesh`` of several devices each batch is split over the replicas
(``parallel/inference.py``, as ``dp_enhance_fn``), its rows padded to a multiple
of the mesh size by repeating the last, as the JAX evaluator pads them.
``_bucket`` and ``_pad_to`` live in ``serve.py``, the base class's module
(which this one imports, so it cannot import them from here).
"""

from __future__ import annotations

import copy
import os
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from hvi_cidnet_torch.data.datasets import save_image
from hvi_cidnet_torch.models.cidnet import HVIGates
from hvi_cidnet_torch.parallel.inference import over_replicas
from hvi_cidnet_torch.parallel.mesh import Mesh
from hvi_cidnet_torch.serve import Enhancer, _bucket, _pad_to


def plan_bucket_quantum(
    shapes, factor: int = 8, max_programs: Optional[int] = None
) -> int:
    """Pick the padding quantum that bounds the number of padded shapes.

    ``max_programs=None`` (the default everywhere) keeps the reference's
    exact pad-to-x``factor`` contract (eval_sets.py:23-29). With a bound
    set, the quantum doubles until the distinct padded-shape count fits.

    NUMERIC CAVEAT: escalation preserves the pad-then-crop *shapes* but not
    the *values*: channel attention reduces over all spatial positions,
    padded pixels included (K5, ``ops/attention.py``), so a larger pad
    perturbs every output pixel inside the crop. That is why the bound is
    strictly opt-in (``cli/eval.py --max_programs``).
    """
    q = factor
    if max_programs is None:
        return q
    shapes = list(shapes)
    while q < 1 << 14:
        n = len({_bucket(h, w, q) for h, w in shapes})
        if n <= max_programs:
            break
        q *= 2
    return q


class Evaluator(Enhancer):
    """``Enhancer`` with the JAX ``Evaluator``'s positional order
    (``weights, config, gates``), its ``max_programs`` (``run_dataset``'s
    opt-in bound on the number of padded shapes), its ``mesh`` and
    ``run_dataset``. The other keywords (``bucket_factor``, ``gamma``,
    ``compute_dtype``, ``routes``, ...) are ``Enhancer``'s; with a mesh of
    several devices, ``device`` is its first (where the rows come back)."""

    def __init__(self, weights, config=None, gates: HVIGates = HVIGates(), *,
                 max_programs: Optional[int] = None, mesh: Optional[Mesh] = None, **kw):
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None:
            kw["device"] = self.mesh.devices[0]
        super().__init__(weights, gates, config=config, **kw)
        self.max_programs = max_programs
        if self.mesh is not None:
            # this evaluator is the first device's replica; the others
            # are copies of its (cast) model
            self._dp = over_replicas(self.mesh, [self] + [
                Enhancer(copy.deepcopy(self.model), gates, gamma=self.gamma,
                         compute_dtype=self.compute_dtype, device=d, routes=self.routes)
                for d in self.mesh.devices[1:]])

    def enhance_batch(self, imgs: np.ndarray) -> np.ndarray:
        """Enhance a stacked NHWC batch whose H, W are multiples of 8 (over
        the mesh when there is one)."""
        if self.mesh is None:
            return super().enhance_batch(imgs)
        n = imgs.shape[0]
        pad = (-n) % self.mesh.size
        if pad:  # repeat rows to a multiple of the mesh; their outputs are dropped
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, axis=0)])
        return self._dp(imgs)[:n].cpu().numpy()

    def run_dataset(
        self, dataset, output_folder: str, *, verbose: bool = True, batch_size: int = 8
    ) -> int:
        """Evaluate an ``EvalDataset``, writing PNGs, streaming.

        Images are grouped by padded bucket shape and run as batches (the
        reference evaluates one image at a time, eval.py:56-75). Bucket
        planning reads only image headers (``dataset.sizes()``) and decoding
        happens per chunk, so resident host memory is bounded by two
        decoded chunks and two output batches, whatever the dataset's size.
        One thread decodes chunk j+1 and two write chunk j-1's PNGs while
        chunk j runs on the device. Returns the number of images written.
        """
        os.makedirs(output_folder, exist_ok=True)
        if hasattr(dataset, "sizes"):
            sizes = dataset.sizes()  # headers only, no pixel decode
        else:
            # a generic dataset: each item decoded once here to learn its
            # shape (and dropped), and again when its chunk runs
            sizes = [dataset[i][0].shape[:2] for i in range(len(dataset))]
        # exact x8 unless the caller opted in to a bound (escalation changes
        # padded values inside the crop: see plan_bucket_quantum)
        quantum = plan_bucket_quantum(sizes, self.bucket_factor, self.max_programs)
        buckets = defaultdict(list)  # (bh, bw) -> [item index]
        for i, (h, w) in enumerate(sizes):
            buckets[_bucket(h, w, quantum)].append(i)
        if verbose:
            print(f"eval buckets: {len(buckets)} padded shape(s), pad quantum {quantum}")
        work = []  # (bh, bw, [item indices]) chunk jobs, bucket order
        for (bh, bw), idxs in buckets.items():
            for start in range(0, len(idxs), batch_size):
                work.append((bh, bw, idxs[start: start + batch_size]))

        def decode_chunk(job):
            bh, bw, ids = job
            chunk = []
            for i in ids:
                item = dataset[i]
                if len(item) == 4:
                    img, name, h, w = item
                else:
                    img, name = item
                    h, w = img.shape[:2]
                if img.shape[0] > bh or img.shape[1] > bw:
                    raise ValueError(
                        f"{name}: decoded shape {img.shape[:2]} exceeds its "
                        f"planned bucket {(bh, bw)} — the header-based size "
                        "probe disagreed with the decoder (rotating EXIF "
                        "orientation? custom dataset whose sizes() ignores "
                        "its own transforms?)"
                    )
                chunk.append((img, name, h, w))
            stacked = np.stack([_pad_to(im, bh, bw) for im, _, _, _ in chunk])
            if self.max_programs is not None and len(chunk) < batch_size:
                # a short tail chunk would run a new batch shape; repeat the
                # last row (its outputs are dropped), as the JAX evaluator does
                reps = np.repeat(stacked[-1:], batch_size - len(chunk), axis=0)
                stacked = np.concatenate([stacked, reps], axis=0)
            return chunk, stacked

        def save_png(out, h, w, name):
            # quantise as torchvision ToPILImage's ``mul(255).byte()``
            # truncation (eval.py:74), so metrics match the reference's
            save_image(os.path.join(output_folder, name), (out[:h, :w] * 255.0).astype(np.uint8))

        n = 0
        with ThreadPoolExecutor(max_workers=1) as dec, ThreadPoolExecutor(max_workers=2) as wr:
            pending = []
            nxt = dec.submit(decode_chunk, work[0]) if work else None
            for j in range(len(work)):
                chunk, stacked = nxt.result()
                nxt = dec.submit(decode_chunk, work[j + 1]) if j + 1 < len(work) else None
                outs = self.enhance_batch(stacked)
                for f in pending:  # the previous chunk's writes (overlapped)
                    f.result()
                pending = [
                    wr.submit(save_png, out, h, w, name)
                    for (_, name, h, w), out in zip(chunk, outs)
                ]
                n += len(chunk)
                if verbose and (n % 50 < len(chunk) and n >= 50 or n == len(dataset)):
                    print(f"  {n}/{len(dataset)}")
            for f in pending:
                f.result()
        return n


def gates_for_dataset(
    *,
    lol: bool = False,
    v2: bool = False,
    unpaired: bool = False,
    lmot: bool = False,
    alpha: float = 1.0,
) -> HVIGates:
    """Per-dataset gate table (eval.py:46-55,109-117)."""
    if lol or lmot:
        return HVIGates(gated=True)
    if v2 or unpaired:
        return HVIGates(gated2=True, alpha=alpha)
    return HVIGates()
