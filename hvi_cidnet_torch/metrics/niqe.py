"""NIQE — Natural Image Quality Evaluator, MATLAB-faithful.

This package's copy of ``hvi_cidnet_tpu/metrics/niqe.py`` (numpy and scipy
only; that package is not importable without jax), with its own copy of
the pristine parameters (``data/niqe_pris_params.npz``, byte for byte the
JAX package's). It matches the reference harness
(``loss/niqe_utils.py:380-558``) and MATLAB R2021a (baboon.png -> 5.7296,
niqe_utils.py:516-517). Differences in *implementation* (not math): the
MATLAB-style bicubic resize is a pair of dense interpolation matrices applied
as matmuls instead of per-output-row loops; boundary handling uses MATLAB's
symmetric index mapping directly.

Quirk preserved for score parity: the reference converts RGB arrays to the Y
channel with its *BGR* coefficient order (niqe_utils ``to_y_channel`` calls
``bgr2ycbcr``; measure_niqe_bris.py feeds RGB PIL arrays), i.e.
``y = 24.966 R + 128.553 G + 65.481 B + 16``.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Tuple

import numpy as np
from scipy.ndimage import convolve
from scipy.special import gamma as _gamma_fn

_DATA = os.path.join(os.path.dirname(__file__), "data", "niqe_pris_params.npz")

# Precomputed AGGD shape-parameter lookup (niqe_utils.py:398-401 grid).
_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = np.square(_gamma_fn(2.0 / _GAM)) / (_gamma_fn(1.0 / _GAM) * _gamma_fn(3.0 / _GAM))


def _cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB bicubic kernel (a = -0.5)."""
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    k = (1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1)
    k += (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0) * ((ax > 1) & (ax <= 2))
    return k


@functools.lru_cache(maxsize=None)
def _resize_matrix(in_len: int, scale: float, antialiasing: bool) -> np.ndarray:
    """(out_len, in_len) MATLAB-imresize weight matrix with symmetric bounds."""
    out_len = int(math.ceil(in_len * scale))
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width /= scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(math.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :]  # 1-indexed source positions
    if scale < 1 and antialiasing:
        weights = scale * _cubic(scale * (u[:, None] - indices))
    else:
        weights = _cubic(u[:, None] - indices)
    weights /= weights.sum(axis=1, keepdims=True)
    # MATLAB symmetric boundary: aux = [1..n, n..1], idx -> aux[mod(idx-1, 2n)]
    aux = np.concatenate([np.arange(1, in_len + 1), np.arange(in_len, 0, -1)])
    mapped = aux[np.mod(indices.astype(np.int64) - 1, 2 * in_len)] - 1  # 0-indexed
    m = np.zeros((out_len, in_len), np.float64)
    rows = np.repeat(np.arange(out_len), p)
    np.add.at(m, (rows, mapped.reshape(-1)), weights.reshape(-1))
    return m


def imresize_matlab(img: np.ndarray, scale: float, antialiasing: bool = True) -> np.ndarray:
    """MATLAB-equivalent bicubic resize of an HW or HWC [0,1] array."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, _ = img.shape
    mh = _resize_matrix(h, scale, antialiasing).astype(np.float32)
    mw = _resize_matrix(w, scale, antialiasing).astype(np.float32)
    out = np.einsum("oh,hwc->owc", mh, img.astype(np.float32))
    out = np.einsum("pw,hwc->hpc", mw, out)
    return out[:, :, 0] if squeeze else out


def rgb_as_bgr_to_y(img: np.ndarray) -> np.ndarray:
    """[0,255] HWC -> Y channel [0,255] via the reference's BGR-order dot
    (niqe_utils to_y_channel + bgr2ycbcr y_only)."""
    x = img.astype(np.float32) / 255.0
    y = x @ np.array([24.966, 128.553, 65.481], np.float32) + 16.0
    return y  # already on the [0,255] Y scale


def estimate_aggd(block: np.ndarray) -> Tuple[float, float, float]:
    """Fit AGGD parameters (alpha, beta_l, beta_r) via the moment-matching
    table method (Eq. 7 of the NIQE paper; grid as niqe_utils.py:396-412)."""
    v = block.reshape(-1).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        left_std = np.sqrt(np.mean(v[v < 0] ** 2)) if np.any(v < 0) else np.nan
        right_std = np.sqrt(np.mean(v[v > 0] ** 2)) if np.any(v > 0) else np.nan
        gammahat = left_std / right_std
        rhat = np.mean(np.abs(v)) ** 2 / np.mean(v**2)
        rhatnorm = (rhat * (gammahat**3 + 1) * (gammahat + 1)) / ((gammahat**2 + 1) ** 2)
        pos = int(np.nanargmin((_R_GAM - rhatnorm) ** 2)) if np.isfinite(rhatnorm) else 0
        alpha = _GAM[pos]
        ratio = np.sqrt(_gamma_fn(1 / alpha) / _gamma_fn(3 / alpha))
        return float(alpha), float(left_std * ratio), float(right_std * ratio)


def block_features(block: np.ndarray) -> list:
    """18-dim per-block feature vector: AGGD on the MSCN field plus on its
    four adjacent-coefficient products (H, V, D1, D2) — Eq. 8."""
    alpha, bl, br = estimate_aggd(block)
    feat = [alpha, (bl + br) / 2]
    for shift in ([0, 1], [1, 0], [1, 1], [1, -1]):
        prod = block * np.roll(block, shift, axis=(0, 1))
        alpha, bl, br = estimate_aggd(prod)
        mean = (br - bl) * (_gamma_fn(2 / alpha) / _gamma_fn(1 / alpha))
        feat.extend([alpha, mean, bl, br])
    return feat


def niqe_score(
    y: np.ndarray,
    mu_pris: np.ndarray,
    cov_pris: np.ndarray,
    window: np.ndarray,
    block: int = 96,
) -> float:
    """NIQE over a [0,255] Y image: 96x96 blocks at 2 scales, MVG distance."""
    h, w = y.shape
    nbh, nbw = h // block, w // block
    y = y[: nbh * block, : nbw * block].astype(np.float64)

    per_scale = []
    for scale in (1, 2):
        mu = convolve(y, window, mode="nearest")
        sigma = np.sqrt(np.abs(convolve(y * y, window, mode="nearest") - mu * mu))
        mscn = (y - mu) / (sigma + 1)
        bs = block // scale
        feats = [
            block_features(mscn[ih * bs : (ih + 1) * bs, iw * bs : (iw + 1) * bs])
            for iw in range(nbw)
            for ih in range(nbh)
        ]
        per_scale.append(np.asarray(feats))
        if scale == 1:
            y = imresize_matlab(y / 255.0, 0.5, antialiasing=True) * 255.0

    feats = np.concatenate(per_scale, axis=1)
    mu_dist = np.nanmean(feats, axis=0)
    clean = feats[~np.isnan(feats).any(axis=1)]
    cov_dist = np.cov(clean, rowvar=False)
    inv = np.linalg.pinv((cov_pris + cov_dist) / 2)
    d = mu_pris - mu_dist
    return float(np.sqrt(d @ inv @ d.T).squeeze())


def calculate_niqe(img: np.ndarray, crop_border: int = 0) -> float:
    """NIQE of an HWC [0,255] image (the harness entry,
    niqe_utils.py:511-558 semantics incl. the MATLAB-consistency round)."""
    data = np.load(_DATA)
    mu_pris = data["mu_pris_param"]
    cov_pris = data["cov_pris_param"]
    window = data["gaussian_window"]

    x = np.asarray(img, np.float32)
    if x.ndim == 3:
        x = rgb_as_bgr_to_y(x)
    if crop_border:
        x = x[crop_border:-crop_border, crop_border:-crop_border]
    x = x.round()
    return niqe_score(x, mu_pris, cov_pris, window)
