"""Paired metric harness: PSNR / MATLAB-SSIM / LPIPS over saved images, and
the unpaired NIQE / BRISQUE one.

The counterpart of ``hvi_cidnet_tpu/eval/measure.py`` (reference
``measure.py:73-163`` and ``measure_niqe_bris.py:17-38``): walks the eval
output glob, pairs each image with its ground truth (extension fallback
chain), resizes the output to the GT's size, optionally rectifies brightness
to the GT gray mean, and averages the metrics, with the same glob order,
warnings, NaN rules and per-image truncations. The disk round trip is kept
by design: it scores exactly what ``eval`` wrote.

Images are read as the JAX harness's ``Image.open(path).convert("RGB")``
reads them: a PNG through ``data/png.py`` (no PIL: the path must run
where PIL is absent), any other extension through PIL, imported in the call (an
``ImportError`` naming the file when PIL is absent). The resize is
``metrics/pil_resize.py``, Pillow's BICUBIC bit for bit. PSNR, SSIM, NIQE
and BRISQUE run on the host in float64; LPIPS runs on ``device``.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np

from hvi_cidnet_torch.data.datasets import read_rgb
from hvi_cidnet_torch.metrics import pil_resize
from hvi_cidnet_torch.metrics.psnr_ssim import gt_mean_rectify, psnr, ssim_matlab

_GT_EXTS = ["", ".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG"]


def fmt_metric(value: float, fmt: str = "{:.4f}") -> str:
    """Render a metric for reports: NaN (metric unavailable — e.g. LPIPS
    without AlexNet weights, BRISQUE without an SVR model) prints as "n/a",
    never as a fake 0.0000."""
    if value != value:  # NaN
        return "n/a"
    return fmt.format(value)


def _find_gt(label_dir: str, name: str) -> Optional[str]:
    """Extension fallback chain (measure.py:115-131)."""
    stem = os.path.splitext(name)[0]
    cand = os.path.join(label_dir, name)
    if os.path.exists(cand):
        return cand
    for ext in _GT_EXTS[1:]:
        cand = os.path.join(label_dir, stem + ext)
        if os.path.exists(cand):
            return cand
    return None


def lpips_fn(lpips, device):
    """``(a_u8, b_u8) -> float`` LPIPS of one HWC uint8 pair on ``device``
    (``lpips``: a ``metrics.lpips.LPIPS``, moved there), or None."""
    if lpips is None:
        return None
    from hvi_cidnet_torch.metrics.lpips import im2tensor_range, lpips_distance

    model = lpips.to(device).eval()

    def fn(a_u8, b_u8):
        return float(lpips_distance(model, im2tensor_range(a_u8), im2tensor_range(b_u8))[0])

    return fn


def metrics(
    im_dir: str,
    label_dir: str,
    use_gt_mean: bool = False,
    *,
    lpips=None,
    device="cuda",
    verbose: bool = True,
) -> Tuple[float, float, float]:
    """Average (psnr, ssim, lpips) over ``glob(im_dir)`` vs ``label_dir``.

    LPIPS runs on ``device`` when ``lpips`` (a ``metrics.lpips.LPIPS``; load
    one with ``load_lpips_torch``) is given; otherwise it is reported as
    **NaN** — pretrained AlexNet weights are not part of the repository, and
    a fabricated 0.0 would read as a perfect score. Callers should print
    ``fmt_metric(lpips)`` so absent metrics render as "n/a".
    """
    lp_fn = lpips_fn(lpips, device)
    total_psnr = total_ssim = total_lpips = 0.0
    n = 0
    files = sorted(glob.glob(im_dir))
    for item in files:
        name = os.path.basename(item)
        gt_path = _find_gt(label_dir, name)
        if gt_path is None:
            if verbose:
                print(f"warning: no ground truth for {name} in {label_dir}")
            continue
        b = read_rgb(gt_path)
        # resize output to GT size (measure.py:133-134; PIL size is (w,h))
        a = pil_resize.resize(read_rgb(item), (b.shape[1], b.shape[0]))
        if use_gt_mean:
            a = gt_mean_rectify(a.astype(np.float64), b)
        total_psnr += psnr(a, b)
        total_ssim += ssim_matlab(a, b)
        if lp_fn is not None:
            total_lpips += lp_fn(np.asarray(a, np.float64).clip(0, 255).astype(np.uint8),
                                 b.astype(np.uint8))
        n += 1

    if n == 0:
        if verbose:
            print("error: no images evaluated")
        return float("nan"), float("nan"), float("nan")
    return (
        total_psnr / n,
        total_ssim / n,
        total_lpips / n if lp_fn is not None else float("nan"),
    )


def unpaired_metrics(im_dir: str, *, brisque_model: Optional[str] = None, verbose: bool = True):
    """Average (niqe, brisque) over ``glob(im_dir)`` — measure_niqe_bris.py:17-38.

    BRISQUE is skipped (returned as nan, the reason printed) when no trained
    model is available; see metrics/brisque.py.
    """
    from hvi_cidnet_torch.metrics.brisque import score as brisque_score
    from hvi_cidnet_torch.metrics.niqe import calculate_niqe

    total_niqe = total_bris = 0.0
    n = 0
    bris_ok = True
    for item in sorted(glob.glob(im_dir)):
        img = read_rgb(item)
        total_niqe += calculate_niqe(img)
        if bris_ok:
            try:
                total_bris += brisque_score(img, brisque_model)
            except FileNotFoundError as e:
                if verbose:
                    print(f"BRISQUE skipped: {e}")
                bris_ok = False
        n += 1
    if n == 0:
        return float("nan"), float("nan")
    return total_niqe / n, (total_bris / n if bris_ok else float("nan"))
