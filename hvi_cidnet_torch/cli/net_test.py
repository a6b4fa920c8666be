"""Model smoke test: parameter count, FLOPs and a timed forward — the
counterpart of ``cli/net_test.py`` (reference net_test.py:1-21).

    python -m hvi_cidnet_torch.cli.net_test [--size 256] [--batch 1]
        [--dtype float32|bfloat16] [--iters 10] [--variant base|mssa|tnsm] [--cpu]
        [--fused | --probe]

Runs on the card unless ``--cpu`` is given; ``--fused`` takes the fused
block route, ``--probe`` the probe route (``ops/routes.py``), else the
defaults with the environment's overrides. The time is host wall clock
around forwards that end in a device synchronise. FLOPs: the dense convs
and plain products by torch's flop counter, and each kernel (K1-K7, the
route kernels) by the operation count of its bound (``utils/flops.py``),
so the card and the CPU print one number for the same forward.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from hvi_cidnet_torch.models.cidnet import (
    VARIANTS,
    CIDNet,
    CIDNetConfig,
    cast_conv_weights,
    cidnet_forward,
)
from hvi_cidnet_torch.ops import routes
from hvi_cidnet_torch.utils import flops


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="HVI-CIDNet (PyTorch) model smoke test")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--variant", type=str, default="base", choices=list(VARIANTS))
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    routes.add_flags(p)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    dt = getattr(torch, args.dtype)
    model = CIDNet(CIDNetConfig(variant=args.variant), generator=torch.Generator().manual_seed(0))
    model = cast_conv_weights(model.to(device), dt).eval()
    x = np.random.default_rng(0).random((args.batch, args.size, args.size, 3))
    x = torch.from_numpy(x).to(device, dt)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def forward():
        out = cidnet_forward(model, x, compute_dtype=dt, routes=routes.from_flags(args))
        return out[0] if args.variant == "tnsm" else out  # TNSM: (rgb, None)

    with torch.no_grad():
        with flops.count() as counter:
            out = forward()  # also the warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = forward()
        sync()
        seconds = (time.perf_counter() - t0) / args.iters

    n_param = model.count_params()
    n_flops = counter.total
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"Time: {seconds:.6f} s/forward ({args.batch}x3x{args.size}x{args.size}, "
          f"{args.dtype}, {name})")
    print(f"n_paras: {n_param / 2**20:.3f}M ({n_param:,})")
    print(f"FLOPs: {n_flops / 2**30:.4f}G ({n_flops:,}; convs and products by torch's flop "
          "counter, kernels K1-K7 and the route kernels by their bound's operation count, "
          "per forward)")
    print(f"throughput: {args.batch / seconds:.1f} img/s")
    return {"seconds": seconds, "n_params": n_param, "flops": n_flops,
            "out_shape": tuple(out.shape), "device": name}


if __name__ == "__main__":
    main()
