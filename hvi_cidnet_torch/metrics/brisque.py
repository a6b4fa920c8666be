"""BRISQUE — Blind/Referenceless Image Spatial Quality Evaluator.

This package's copy of ``hvi_cidnet_tpu/metrics/brisque.py`` without cv2.
The reference scores BRISQUE through the ``imquality`` package
(measure_niqe_bris.py:4,26), which bundles the LIVE-trained libsvm SVR
model. This module implements the metric natively:

* feature extraction (36-dim: GGD fit of the MSCN field + AGGD fits of the 4
  adjacent-coefficient products, at 2 scales) in numpy. The JAX package's
  two cv2 calls are numpy here. ``cv2.GaussianBlur(y, (7, 7), 7/6,
  BORDER_REPLICATE)`` is a separable correlation with the same kernel and
  scipy's "nearest" border on the first scale's float64 image (within
  ~1e-13), and OpenCV's own float32 arithmetic on the second scale's
  float32 image. ``cv2.cvtColor(float32, COLOR_RGB2GRAY)`` is OpenCV's
  vector form, ``fma(B, 0.114, fma(R, 0.299, G * 0.587))`` in float32
  (bitwise but for the last few pixels of an image, which OpenCV computes
  in a scalar loop);
* a libsvm epsilon-SVR *reader + predictor* (RBF kernel) so the official
  trained model file — e.g. imquality's ``brisque_svm.txt`` or the LIVE
  release's ``allmodel`` — can be dropped in via ``model_path`` or the
  ``BRISQUE_MODEL`` env var for score parity with the reference.

Without a model file, ``score`` falls back to the native OpenCV backend
(``brisque_cv``) and raises ``FileNotFoundError`` when that is absent too;
the eval harness then reports BRISQUE as n/a and says why.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.special import gamma as _gamma_fn

from hvi_cidnet_torch.metrics.niqe import estimate_aggd, imresize_matlab
from hvi_cidnet_torch.metrics.psnr_ssim import gaussian_kernel, separable_filter


def _ggd_fit(v: np.ndarray) -> Tuple[float, float]:
    """Fit a (symmetric) GGD via the moment-ratio table method."""
    gam = np.arange(0.2, 10.001, 0.001)
    r_gam = (_gamma_fn(1.0 / gam) * _gamma_fn(3.0 / gam)) / np.square(_gamma_fn(2.0 / gam))
    sigma_sq = np.mean(v**2)
    e = np.mean(np.abs(v))
    rho = sigma_sq / (e**2 + 1e-12)
    pos = int(np.argmin(np.abs(r_gam - rho)))
    return float(gam[pos]), float(sigma_sq)


_MSCN_KERNEL = gaussian_kernel(7, 7 / 6.0)
_MSCN_KERNEL_F32 = _MSCN_KERNEL.astype(np.float32)


def _fma32(a: np.ndarray, b: np.float32, c: np.ndarray) -> np.ndarray:
    """float32 ``a * b + c`` rounded once: the product of two float32s is
    exact in extended precision, and so is its sum with ``c`` at image
    values."""
    return (a.astype(np.longdouble) * np.longdouble(b) + c.astype(np.longdouble)).astype(
        np.float32)


def _blur_f32(y: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(y, (7, 7), 7/6, borderType=BORDER_REPLICATE)`` of
    a float32 image as OpenCV's loops compute it, with the float32 kernel.
    The row pass is a chain of fused multiply-adds over the taps in order
    (vector loops 8 and 4 wide), but for the last ``width % 4`` columns,
    which sum rounded products (the scalar tail). The column pass takes the
    centre tap's product, then adds each pair of rows at equal distance
    times its tap: fused in the 8-wide vector loop, rounded product by
    product in the last ``width % 8`` columns."""
    k = _MSCN_KERNEL_F32
    r = len(k) // 2
    h, w = y.shape
    p = np.pad(y, ((0, 0), (r, r)), mode="edge")
    taps = [p[:, t: t + w] for t in range(len(k))]
    rows = np.zeros_like(y)
    for t, x in enumerate(taps):
        rows = _fma32(x, k[t], rows)
    tail = w // 4 * 4
    if tail < w:
        s = taps[0][:, tail:] * k[0]
        for t in range(1, len(k)):
            s = s + taps[t][:, tail:] * k[t]
        rows[:, tail:] = s
    p = np.pad(rows, ((r, r), (0, 0)), mode="edge")
    centre = p[r: r + h] * k[r]
    pairs = [p[r + j: r + j + h] + p[r - j: r - j + h] for j in range(1, r + 1)]
    out = centre.copy()
    for j, x in enumerate(pairs, 1):
        out = _fma32(x, k[r + j], out)
    tail = w // 8 * 8
    if tail < w:
        s = centre[:, tail:]
        for j, x in enumerate(pairs, 1):
            s = s + x[:, tail:] * k[r + j]
        out[:, tail:] = s
    return out


def _blur(y: np.ndarray) -> np.ndarray:
    """The 7x7, sigma 7/6 Gaussian blur with replicated borders: float32
    as OpenCV computes it, float64 as a separable correlation (within
    ~1e-13 of OpenCV's)."""
    if y.dtype == np.float32:
        return _blur_f32(y)
    return separable_filter(y, _MSCN_KERNEL, "nearest")


def _mscn(y: np.ndarray) -> np.ndarray:
    mu = _blur(y)
    sigma = _blur(y * y) - mu * mu
    sigma = np.sqrt(np.abs(sigma))
    return (y - mu) / (sigma + 1.0)


def rgb_to_gray_f32(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img.astype(np.float32), COLOR_RGB2GRAY)`` as OpenCV's
    vector loop computes it."""
    x = np.asarray(img, np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return _fma32(b, np.float32(0.114), _fma32(r, np.float32(0.299), g * np.float32(0.587)))


def brisque_features(img: np.ndarray) -> np.ndarray:
    """36-dim BRISQUE feature vector of an HWC/HW [0,255] image."""
    x = np.asarray(img, np.float64)
    if x.ndim == 3:
        x = rgb_to_gray_f32(x).astype(np.float64)
    feats: List[float] = []
    for scale in range(2):
        mscn = _mscn(x)
        alpha, sigma_sq = _ggd_fit(mscn.reshape(-1))
        feats.extend([alpha, sigma_sq])
        for shift in ([0, 1], [1, 0], [1, 1], [1, -1]):
            prod = mscn * np.roll(mscn, shift, axis=(0, 1))
            a, bl, br = estimate_aggd(prod)
            mean = (br - bl) * (_gamma_fn(2 / a) / _gamma_fn(1 / a))
            feats.extend([a, mean, bl, br])
        if scale == 0:
            x = imresize_matlab(x / 255.0, 0.5) * 255.0
    return np.asarray(feats)


class LibSVMModel:
    """Minimal libsvm epsilon-SVR model reader + RBF predictor."""

    def __init__(self, path: str, scale_path: Optional[str] = None):
        self.gamma = 0.05
        self.rho = 0.0
        self.sv_coef: List[float] = []
        self.svs: List[Dict[int, float]] = []
        # libsvm feature scaling to [lower, upper] (LIVE ships ``allrange``;
        # svm-scale's restore file has the same per-feature min/max layout)
        self.scale_lo: Optional[np.ndarray] = None
        self.scale_hi: Optional[np.ndarray] = None
        self.lower = -1.0
        self.upper = 1.0
        self._parse(path)
        if scale_path is None:
            scale_path = _find_scale_file(path)
        if scale_path is not None:
            self._parse_scale(scale_path)

    def _parse(self, path: str) -> None:
        in_sv = False
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if in_sv:
                    parts = line.split()
                    self.sv_coef.append(float(parts[0]))
                    self.svs.append(
                        {int(k): float(v) for k, v in (p.split(":") for p in parts[1:])}
                    )
                elif line.startswith("gamma"):
                    self.gamma = float(line.split()[1])
                elif line.startswith("rho"):
                    self.rho = float(line.split()[1])
                elif line == "SV":
                    in_sv = True

    def _parse_scale(self, path: str) -> None:
        """Parse a per-feature range file.

        Accepts both svm-scale restore files::

            x
            -1 1
            1 min1 max1
            ...

        and the LIVE release's ``allrange`` (``idx min max`` lines only).
        """
        lo: Dict[int, float] = {}
        hi: Dict[int, float] = {}
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        for ln in lines:
            parts = ln.split()
            if parts[0] in ("x", "y"):
                continue
            if len(parts) == 2:  # svm-scale "lower upper" header line
                self.lower, self.upper = float(parts[0]), float(parts[1])
                continue
            if len(parts) == 3:
                idx = int(parts[0])
                lo[idx], hi[idx] = float(parts[1]), float(parts[2])
        if lo:
            n = max(lo)
            self.scale_lo = np.zeros(n)
            self.scale_hi = np.ones(n)
            for i in range(1, n + 1):
                self.scale_lo[i - 1] = lo.get(i, 0.0)
                self.scale_hi[i - 1] = hi.get(i, 1.0)

    def scale(self, x: np.ndarray) -> np.ndarray:
        """libsvm svm-scale mapping of features to [lower, upper]."""
        if self.scale_lo is None:
            return x
        n = min(x.shape[0], self.scale_lo.shape[0])
        out = x.astype(np.float64).copy()
        rng = self.scale_hi[:n] - self.scale_lo[:n]
        rng = np.where(rng == 0, 1.0, rng)
        out[:n] = self.lower + (self.upper - self.lower) * (x[:n] - self.scale_lo[:n]) / rng
        return out

    def predict(self, x: np.ndarray) -> float:
        n = x.shape[0]
        total = -self.rho
        for coef, sv in zip(self.sv_coef, self.svs):
            v = np.zeros(n)
            for k, val in sv.items():
                if k - 1 < n:
                    v[k - 1] = val
            d = x - v
            total += coef * np.exp(-self.gamma * np.dot(d, d))
        return float(total)


def _find_scale_file(model_path: str) -> Optional[str]:
    env = os.environ.get("BRISQUE_RANGE")
    if env and os.path.exists(env):
        return env
    d = os.path.dirname(model_path)
    base = os.path.splitext(os.path.basename(model_path))[0]
    for cand in (base + "_scale.txt", base + ".range", "allrange", "brisque_range.txt"):
        p = os.path.join(d, cand)
        if os.path.exists(p):
            return p
    return None


def _default_model_path() -> Optional[str]:
    p = os.environ.get("BRISQUE_MODEL")
    if p and os.path.exists(p):
        return p
    local = os.path.join(os.path.dirname(__file__), "data", "brisque_svm.txt")
    return local if os.path.exists(local) else None


def score(img: np.ndarray, model_path: Optional[str] = None) -> float:
    """BRISQUE score (lower is better), from a trained model.

    Resolution order:

    1. an explicit/env/bundled **libsvm** SVR model file (imquality's
       ``brisque_svm.txt`` or the LIVE release's ``allmodel``) — scored by
       the pure-Python reader above.  Feature scaling: libsvm BRISQUE models
       are trained on svm-scaled features ([-1,1] per feature over the LIVE
       corpus); the companion range file is auto-discovered next to the
       model (or via BRISQUE_RANGE).
    2. otherwise, the **native OpenCV backend** (metrics/brisque_cv.py) when
       its C++ shim builds and the system ships the LIVE-R2-trained
       ``brisque_model_live.yml`` — the same algorithm trained on the same
       corpus as the reference's imquality scorer (measure_niqe_bris.py:4,26).

    Raises FileNotFoundError when neither trained model is available.
    """
    path = model_path or _default_model_path()
    if path is None:
        from hvi_cidnet_torch.metrics import brisque_cv

        if brisque_cv.available():
            return brisque_cv.score(img)
        raise FileNotFoundError(
            "BRISQUE needs a trained model: either the LIVE libsvm SVR "
            "(imquality's brisque_svm.txt; set BRISQUE_MODEL or pass "
            "model_path) or the system OpenCV quality module with its "
            "bundled brisque_model_live.yml. Neither is available, and this "
            "environment has no network to fetch one."
        )
    feats = brisque_features(img)
    model = LibSVMModel(path)
    return model.predict(model.scale(feats))
