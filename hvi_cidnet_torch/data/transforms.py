"""Host-side image transforms (numpy).

This package's own copy of ``to_float01`` and ``pad_to_multiple``
(``hvi_cidnet_tpu/data/transforms.py:43-64``; that package is not
importable without jax). ``paired_random_crop_flip`` comes with the
training data pipeline.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def to_float01(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 [0,1] (torchvision ToTensor without the CHW move)."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def pad_to_multiple(img: np.ndarray, factor: int = 8) -> Tuple[np.ndarray, int, int]:
    """Reflect-pad H,W up to the next multiple of ``factor``.

    Matches the eval-time padding rule (data/eval_sets.py:23-28, demo.py:46-52):
    dimensions already divisible by ``factor`` are left unchanged.
    Returns (padded, orig_h, orig_w).
    """
    h, w = img.shape[:2]
    ph = 0 if h % factor == 0 else (h + factor) // factor * factor - h
    pw = 0 if w % factor == 0 else (w + factor) // factor * factor - w
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="reflect")
    return img, h, w
