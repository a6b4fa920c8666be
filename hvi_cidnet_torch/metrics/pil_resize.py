"""Pillow's ``Image.resize(size)`` of an 8-bit RGB image, in numpy.

The JAX measure harness resizes each output to its ground truth's size
with PIL (``eval/measure.py:87``, ``cli/measure_SID_blur.py:72``); the
port's scoring path must run where PIL is absent, so it resizes here, bit
for bit as Pillow does. For an RGB image ``resize`` takes BICUBIC (``resample=None``)
and returns a copy when the size is unchanged. Otherwise Pillow's
``ImagingResample`` (``libImaging/Resample.c``) runs two separable passes,
horizontal first, each skipped when its axis keeps its size:

* per output pixel, the filter's centre ``(x + 0.5) * scale`` with
  ``scale = in / out``; the support is 2 (bicubic, a = -0.5), times
  ``scale`` when downscaling, and the taps run from
  ``int(centre - support + 0.5)`` to ``int(centre + support + 0.5)``,
  clamped to the image;
* the tap weights ``filter((x - centre + 0.5) / max(scale, 1))`` are
  normalised to sum 1 in float64, then made fixed point with
  ``PRECISION_BITS = 32 - 8 - 2`` fractional bits, rounded half away from
  zero;
* each pass sums ``uint8 * weight`` in integers from ``2^(PRECISION_BITS
  - 1)`` (rounding), shifts right by ``PRECISION_BITS`` and clips to
  [0, 255] (``clip8``); the horizontal pass's uint8 result is the
  vertical pass's input.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2
BICUBIC_SUPPORT = 2.0


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's ``bicubic_filter`` (a = -0.5), op for op in float64."""
    a = -0.5
    x = np.abs(x)
    inner = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    outer = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


def coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(taps, weights): ``taps`` (out_size, ksize) source indices and
    ``weights`` (out_size, ksize) fixed-point int64 weights, 0 past each
    pixel's last tap (``precompute_coeffs`` + ``normalize_coeffs_8bpc``)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = BICUBIC_SUPPORT * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    centre = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; a negative start clamps to 0 anyway
    xmin = np.maximum(np.trunc(centre - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(centre + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)[None, :]
    live = x < xmax[:, None]
    raw = np.where(live, _bicubic((x + xmin[:, None] - centre[:, None] + 0.5)
                                  * (1.0 / filterscale)), 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # summed tap by tap, in C's order
        ww = ww + raw[:, j]
    # a zero sum leaves the weights as they are, as C does
    w = raw / np.where(ww != 0.0, ww, 1.0)[:, None]
    scaled = w * float(1 << PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    taps = np.minimum(x + xmin[:, None], in_size - 1)
    return taps, np.where(live, fixed, 0)


def _pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One resampling pass of an (H, W, C) uint8 image along ``axis``."""
    taps, weights = coefficients(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # (N, M, C)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    for j in range(taps.shape[1]):
        acc += src[taps[:, j]] * weights[:, j, None, None]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``np.asarray(Image.fromarray(img).resize(size))`` of an (H, W, 3)
    uint8 ``img``; ``size`` is PIL's (width, height)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"pil_resize takes (H, W, C) uint8, got {img.dtype} {img.shape}")
    out_w, out_h = int(size[0]), int(size[1])
    if out_w <= 0 or out_h <= 0:
        raise ValueError(f"pil_resize: size {size} must be positive")
    h, w = img.shape[:2]
    out = img
    if out_w != w:
        out = _pass(out, 1, out_w)
    if out_h != h:
        out = _pass(out, 0, out_h)
    return out.copy() if out is img else out
