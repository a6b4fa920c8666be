"""Paired metric CLI — the counterpart of ``cli/measure.py`` (reference
measure.py:166-190).

    python -m hvi_cidnet_torch.cli.measure --lol | --lol_v2_real |
        --lol_v2_syn | --SICE_grad | --SICE_mix | --lmot
        [--im_dir GLOB] [--label_dir DIR] [--use_GT_mean]
        [--lpips_weights FILE] [--cpu]

Scores the eval CLI's output folder against its ground truth (the
``ROUTES`` table, or ``--im_dir`` / ``--label_dir``): PSNR and SSIM on the
host, LPIPS on the card (``--cpu``: on the CPU) when ``--lpips_weights``
names a combined AlexNet + lin state dict, else reported as n/a.
"""

from __future__ import annotations

import argparse

from hvi_cidnet_torch.eval.measure import fmt_metric, metrics

ROUTES = {
    "lol": ("./output/LOLv1/*.png", "./datasets/LOLdataset/eval15/high/"),
    "lol_v2_real": ("./output/LOLv2_real/*.png", "./datasets/LOLv2/Real_captured/Test/Normal/"),
    "lol_v2_syn": ("./output/LOLv2_syn/*.png", "./datasets/LOLv2/Synthetic/Test/Normal/"),
    "SICE_grad": ("./output/SICE_grad/*.png", "./datasets/SICE/SICE_Reshape/"),
    "SICE_mix": ("./output/SICE_mix/*.png", "./datasets/SICE/SICE_Reshape/"),
    "lmot": ("./output/LMOT/*.png", "./datasets/lmot_lol_val/img_light_rgb"),
}
LPIPS_NOTE = ("note: LPIPS reported as n/a — no pretrained AlexNet weights "
              "available offline; pass --lpips_weights for real scores")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Measure")
    p.add_argument("--use_GT_mean", action="store_true")
    for name in ROUTES:
        p.add_argument(f"--{name}", action="store_true")
    p.add_argument("--im_dir", type=str, default=None, help="override output glob")
    p.add_argument("--label_dir", type=str, default=None, help="override GT dir")
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="combined alexnet+lin torch state_dict for LPIPS scoring")
    p.add_argument("--cpu", action="store_true", help="run LPIPS on the CPU instead of the GPU")
    return p


def load_lpips(path):
    """The LPIPS module of ``--lpips_weights``, or None with the n/a note."""
    if not path:
        print(LPIPS_NOTE)
        return None
    from hvi_cidnet_torch.metrics.lpips import load_lpips_torch

    return load_lpips_torch(path)


def main(argv=None):
    mea = parser().parse_args(argv)
    im_dir = label_dir = None
    for name, (im, lab) in ROUTES.items():
        if getattr(mea, name):
            im_dir, label_dir = im, lab
    if mea.im_dir:
        im_dir = mea.im_dir
    if mea.label_dir:
        label_dir = mea.label_dir
    if im_dir is None or label_dir is None:
        raise SystemExit("choose a dataset flag or pass --im_dir/--label_dir")

    lpips = load_lpips(mea.lpips_weights)
    avg_psnr, avg_ssim, avg_lpips = metrics(im_dir, label_dir, mea.use_GT_mean, lpips=lpips,
                                            device="cpu" if mea.cpu else "cuda")
    print(f"===> Avg.PSNR: {avg_psnr:.4f} dB")
    print(f"===> Avg.SSIM: {avg_ssim:.4f}")
    print(f"===> Avg.LPIPS: {fmt_metric(avg_lpips)}")
    return avg_psnr, avg_ssim, avg_lpips


if __name__ == "__main__":
    main()
