"""SID / LOL-Blur full-resolution scene evaluator — the counterpart of
``cli/eval_SID_blur.py`` (reference eval_SID_blur.py:45-76).

    python -m hvi_cidnet_torch.cli.eval_SID_blur --SID | --Blur
        [--weights FILE] [--variant base|mssa|tnsm] [--dtype float32|bfloat16] [--cpu]

Iterates the numbered scene directories (Blur 0001-0256, SID 10001-10229)
that exist, running each frame at full resolution with no gates, and
writes one output folder per scene. Runs on the card unless ``--cpu`` is
given; ``--dp`` and ``--compile_cache`` as in ``cli/eval.py``.
"""

from __future__ import annotations

import argparse
import os

from hvi_cidnet_torch.cli.eval import DTYPES, device_of, placement
from hvi_cidnet_torch.data.datasets import EvalDataset
from hvi_cidnet_torch.eval.evaluator import Evaluator
from hvi_cidnet_torch.models.cidnet import VARIANTS, CIDNetConfig, HVIGates


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Eval")
    p.add_argument("--SID", action="store_true")
    p.add_argument("--Blur", action="store_true")
    p.add_argument("--weights", type=str, default=None)
    p.add_argument("--variant", type=str, default="base", choices=list(VARIANTS))
    p.add_argument("--dtype", type=str, default="float32", choices=list(DTYPES))
    p.add_argument("--dp", action="store_true",
                   help="data-parallel eval: each batch split over every CUDA device "
                        "(a no-op on one)")
    p.add_argument("--compile_cache", type=str, default=None, metavar="DIR",
                   help="accepted for the JAX CLI's flag surface; does nothing here")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    return p


def main(argv=None) -> None:
    ep = parser().parse_args(argv)
    where = device_of(ep)
    if ep.Blur:
        test_dir, weights, out_root = "./datasets/LOL_blur/test/low_blur/", "./weights/LOL-Blur.pth", "./output/LOL_Blur/"
        scenes = [str(i).zfill(4) for i in range(1, 257)]
    elif ep.SID:
        test_dir, weights, out_root = "./datasets/Sony_total_dark/test/short/", "./weights/SID.pth", "./output/SID/"
        scenes = ["1" + str(i).zfill(4) for i in range(1, 230)]
    else:
        raise SystemExit("pass --SID or --Blur")
    if ep.weights:
        weights = ep.weights
    ev = Evaluator(weights, CIDNetConfig(variant=ep.variant), HVIGates(),
                   compute_dtype=DTYPES[ep.dtype], **placement(where))
    os.makedirs(out_root, exist_ok=True)
    for scene in scenes:
        now_dir = os.path.join(test_dir, scene)
        if not os.path.isdir(now_dir):
            continue
        print("Evaluation:", now_dir)
        ev.run_dataset(EvalDataset(now_dir), os.path.join(out_root, scene), verbose=False)
    print("done")


if __name__ == "__main__":
    main()
