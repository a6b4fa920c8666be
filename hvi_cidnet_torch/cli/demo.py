"""Single-image enhancement — the counterpart of ``cli/demo.py`` (reference
demo.py:11-73): reflect-pad to x8, run with both HVI gates on, crop, save
``enhanced_<name>``.

    python -m hvi_cidnet_torch.cli.demo --input IMG [--output_dir output]
        [--weight weights/SICE.pth | --random_init] [--gamma 1.0]
        [--alpha_s 1.0] [--alpha_i 1.0] [--variant base|mssa|tnsm] [--cpu]
        [--fused | --probe]

Weights are a reference-layout ``.pth``, ``.npz`` or ``.safetensors``
state dict, the JAX trainer's ``.npz`` checkpoint (``param::`` keys) or an
HF folder, whose ``config.json`` gives the model's config in place of
``--variant``; TNSM loads them shape-filtered and non-strict, as the TNSM
evaluator does. With ``--random_init`` the model is drawn from a generator
seeded 0. Runs on the card unless ``--cpu`` is given; ``--fused`` takes
the fused block route, ``--probe`` the probe route (``ops/routes.py``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from hvi_cidnet_torch.models.cidnet import VARIANTS, CIDNet, CIDNetConfig, HVIGates
from hvi_cidnet_torch.ops import routes
from hvi_cidnet_torch.serve import Enhancer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="HVI-CIDNet inference (PyTorch)")
    p.add_argument("--input", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--weight", type=str, default="weights/SICE.pth")
    p.add_argument("--gamma", type=float, default=1.0, help="lower = brighter")
    p.add_argument("--alpha_s", type=float, default=1.0, help="saturation")
    p.add_argument("--alpha_i", type=float, default=1.0, help="intensity")
    p.add_argument("--variant", type=str, default="base", choices=list(VARIANTS))
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    p.add_argument("--random_init", action="store_true",
                   help="run with fresh random weights (no weight file needed)")
    routes.add_flags(p)
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    config = CIDNetConfig(variant=args.variant)
    if args.random_init:
        weights = CIDNet(config, generator=torch.Generator().manual_seed(0))
    else:
        print(f"loading weights: {args.weight}")
        weights = args.weight
    # the reference demo enables both gates (demo.py:32-33, 41-42)
    gates = HVIGates(gated=True, gated2=True, alpha=args.alpha_i, alpha_s=args.alpha_s)
    if not args.random_init and os.path.isdir(args.weight):
        config = None  # the folder's config.json
    enhancer = Enhancer(weights, gates, config=config, gamma=args.gamma,
                        device="cpu" if args.cpu else "cuda", routes=routes.from_flags(args))

    print(f"processing: {args.input}")
    img = np.asarray(Image.open(args.input).convert("RGB"), np.float32) / 255.0
    out = enhancer.enhance(img)
    out_path = os.path.join(args.output_dir, f"enhanced_{os.path.basename(args.input)}")
    Image.fromarray((np.clip(out, 0, 1) * 255.0).astype(np.uint8)).save(out_path)
    print(f"saved: {out_path}")
    return out_path


if __name__ == "__main__":
    main()
