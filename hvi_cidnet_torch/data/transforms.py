"""Host-side image transforms (numpy).

This package's own copy of ``paired_random_crop_flip``, ``to_float01``
and ``pad_to_multiple`` (``hvi_cidnet_tpu/data/transforms.py:17-64``; that
package is not importable without jax).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def paired_random_crop_flip(
    im1: np.ndarray,
    im2: np.ndarray,
    size: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Identical random crop + H/V flips on an aligned (low, high) pair.

    The reference re-seeds its global RNG before each of the two
    ``transform()`` calls so the crops align (data/data.py:6-12,
    data/LOLdataset.py:31-39); here the pair is augmented in one call with
    one RNG, drawing top, left, then the two flips, as the JAX copy draws.
    Inputs are HWC uint8/float arrays with identical H,W.
    """
    h, w = im1.shape[:2]
    if h < size or w < size:
        raise ValueError(f"image {h}x{w} smaller than crop {size}")
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    im1 = im1[top : top + size, left : left + size]
    im2 = im2[top : top + size, left : left + size]
    if rng.random() < 0.5:  # horizontal flip
        im1 = im1[:, ::-1]
        im2 = im2[:, ::-1]
    if rng.random() < 0.5:  # vertical flip
        im1 = im1[::-1]
        im2 = im2[::-1]
    return np.ascontiguousarray(im1), np.ascontiguousarray(im2)


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
