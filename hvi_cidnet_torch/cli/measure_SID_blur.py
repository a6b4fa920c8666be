"""Scene-folder paired metrics — the counterpart of ``cli/measure_SID_blur.py``.

    python -m hvi_cidnet_torch.cli.measure_SID_blur --SID | --Blur
        [--out_root DIR] [--gt_root DIR] [--use_GT_mean]
        [--lpips_weights FILE] [--cpu]

Walks per-scene output folders and their GT folders (a GT of the same
name, else the first of the same stem), scoring PSNR (without the 1e-8
guard, measure_SID_blur.py:65-70), MATLAB-SSIM, and LPIPS on the card
(``--cpu``: on the CPU) when weights are supplied. An output whose shape
differs from its GT's is resized to it (``metrics/pil_resize.py``, PIL's
BICUBIC).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from hvi_cidnet_torch.cli.measure import load_lpips
from hvi_cidnet_torch.data.datasets import is_image_file, read_rgb
from hvi_cidnet_torch.eval.measure import fmt_metric, lpips_fn
from hvi_cidnet_torch.metrics import pil_resize
from hvi_cidnet_torch.metrics.psnr_ssim import gt_mean_rectify, psnr, ssim_matlab


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Measure")
    p.add_argument("--use_GT_mean", action="store_true")
    p.add_argument("--SID", action="store_true")
    p.add_argument("--Blur", action="store_true")
    p.add_argument("--out_root", type=str, default=None)
    p.add_argument("--gt_root", type=str, default=None)
    p.add_argument("--lpips_weights", type=str, default=None)
    p.add_argument("--cpu", action="store_true", help="run LPIPS on the CPU instead of the GPU")
    return p


def main(argv=None):
    mea = parser().parse_args(argv)
    if mea.Blur:
        out_root = mea.out_root or "./output/LOL_Blur/"
        gt_root = mea.gt_root or "./datasets/LOL_blur/test/high_sharp_scaled/"
    elif mea.SID:
        out_root = mea.out_root or "./output/SID/"
        gt_root = mea.gt_root or "./datasets/Sony_total_dark/test/long/"
    else:
        raise SystemExit("pass --SID or --Blur")

    lp_fn = None
    if mea.lpips_weights:
        lp_fn = lpips_fn(load_lpips(mea.lpips_weights), "cpu" if mea.cpu else "cuda")

    tp = ts = tl = 0.0
    n = 0
    for scene in sorted(os.listdir(out_root)):
        scene_out = os.path.join(out_root, scene)
        scene_gt = os.path.join(gt_root, scene)
        if not os.path.isdir(scene_out) or not os.path.isdir(scene_gt):
            continue
        for f in sorted(os.listdir(scene_out)):
            if not is_image_file(f):
                continue
            gt_path = os.path.join(scene_gt, f)
            if not os.path.exists(gt_path):
                stem = os.path.splitext(f)[0]
                cands = [x for x in os.listdir(scene_gt) if os.path.splitext(x)[0] == stem]
                if not cands:
                    continue
                gt_path = os.path.join(scene_gt, cands[0])
            a = read_rgb(os.path.join(scene_out, f))
            b = read_rgb(gt_path)
            if a.shape != b.shape:
                a = pil_resize.resize(a, (b.shape[1], b.shape[0]))
            if mea.use_GT_mean:
                a = gt_mean_rectify(a.astype(np.float64), b)
            tp += psnr(a, b, eps_guard=False)
            ts += ssim_matlab(a, b)
            if lp_fn:
                tl += lp_fn(np.clip(a, 0, 255).astype(np.uint8), b)
            n += 1

    if n == 0:
        raise SystemExit("no image pairs found")
    avg = (tp / n, ts / n, tl / n if lp_fn else float("nan"))
    print(f"===> Avg.PSNR: {avg[0]:.4f} dB")
    print(f"===> Avg.SSIM: {avg[1]:.4f}")
    print(f"===> Avg.LPIPS: {fmt_metric(avg[2])}")
    return avg


if __name__ == "__main__":
    main()
