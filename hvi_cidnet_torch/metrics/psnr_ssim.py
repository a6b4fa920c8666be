"""Paired image metrics: PSNR, MATLAB-faithful SSIM and the GT-mean
rectification, host-side numpy.

The counterpart of ``hvi_cidnet_tpu/metrics/psnr_ssim.py`` (reference
measure.py:23-71,138-141) without cv2:

* ``cv2.getGaussianKernel(11, 1.5)`` is the normalised ``exp(-i^2 / 2
  sigma^2)``, i = -5..5, computed as OpenCV does;
* ``cv2.filter2D(z, -1, window)`` (BORDER_REFLECT_101) with the outer
  product window is two ``scipy.ndimage.correlate1d(..., mode="mirror")``
  passes (scipy's "mirror" is OpenCV's reflect-101), one an axis, before
  the same 5-pixel crop;
* ``cv2.cvtColor(u8, COLOR_RGB2GRAY)`` is OpenCV's integer rule,
  ``(9798 R + 19235 G + 3735 B + 2^14) >> 15`` (15-bit coefficients).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import correlate1d


def psnr(img: np.ndarray, ref: np.ndarray, *, eps_guard: bool = True) -> float:
    """PSNR on [0,255] floats.

    ``eps_guard`` adds the reference's 1e-8 stabilizer (measure.py:66-71);
    ``eps_guard=False`` matches measure_SID_blur.py:65-70 which omits it
    (and divides by zero on identical images, as the reference does).
    """
    a = np.asarray(img, np.float32)
    b = np.asarray(ref, np.float32)
    mse = np.mean(np.square(a - b))
    if eps_guard:
        mse = mse + 1e-8
    return float(10.0 * np.log10(255.0 * 255.0 / mse))


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)`` (sigma > 0) as a 1-D float64
    array: ``exp(-x^2 / (2 sigma^2))`` over x = -(ksize-1)/2 .. (ksize-1)/2,
    scaled by the reciprocal of its sum."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    t = np.exp((-0.5 / (sigma * sigma)) * x * x)
    return t * (1.0 / t.sum())


_SSIM_KERNEL = gaussian_kernel(11, 1.5)


def separable_filter(z: np.ndarray, kernel: np.ndarray, mode: str) -> np.ndarray:
    """Correlate ``z`` with ``outer(kernel, kernel)`` as a row pass and a
    column pass (``mode``: scipy's border rule)."""
    return correlate1d(correlate1d(z, kernel, axis=0, mode=mode), kernel, axis=1, mode=mode)


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    """Single-channel MATLAB SSIM: 11x11 sigma-1.5 Gaussian filtering with
    a 5px border crop, C constants on the [0,255] scale (measure.py:23-43)."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    x = img1.astype(np.float64)
    y = img2.astype(np.float64)

    def filt(z):
        return separable_filter(z, _SSIM_KERNEL, "mirror")[5:-5, 5:-5]

    mu1, mu2 = filt(x), filt(y)
    mu1_sq, mu2_sq, mu12 = mu1**2, mu2**2, mu1 * mu2
    s1 = filt(x * x) - mu1_sq
    s2 = filt(y * y) - mu2_sq
    s12 = filt(x * y) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(ssim_map.mean())


def ssim_matlab(img: np.ndarray, ref: np.ndarray) -> float:
    """Channel-averaged MATLAB SSIM on [0,255] images (measure.py:45-64)."""
    a = np.asarray(img, np.float64)
    b = np.asarray(ref, np.float64)
    if a.shape != b.shape:
        raise ValueError("Input images must have the same dimensions.")
    if a.ndim == 2:
        return _ssim_single(a, b)
    if a.ndim == 3 and a.shape[2] == 3:
        return float(np.mean([_ssim_single(a[:, :, i], b[:, :, i]) for i in range(3)]))
    if a.ndim == 3 and a.shape[2] == 1:
        return _ssim_single(a[..., 0], b[..., 0])
    raise ValueError("Wrong input image dimensions.")


def rgb_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2GRAY)`` of an RGB uint8 HWC image:
    fixed point with 15-bit coefficients and rounding."""
    x = np.asarray(img, np.uint8).astype(np.int32)
    y = 9798 * x[..., 0] + 19235 * x[..., 1] + 3735 * x[..., 2] + (1 << 14)
    return (y >> 15).astype(np.uint8)


def gt_mean_rectify(img: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Scale output brightness to the GT gray mean (measure.py:138-141).
    Both images are truncated to uint8 for the means, as the reference's
    ``astype(np.uint8)`` does."""
    mean_restored = rgb_to_gray_u8(img.astype(np.uint8)).mean()
    mean_target = rgb_to_gray_u8(ref.astype(np.uint8)).mean()
    return np.clip(img * (mean_target / mean_restored), 0, 255)
