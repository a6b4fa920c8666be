"""Model smoke test: parameter count, FLOPs and a timed forward — the
counterpart of ``cli/net_test.py`` (reference net_test.py:1-21).

    python -m hvi_cidnet_torch.cli.net_test [--size 256] [--batch 1]
        [--dtype float32|bfloat16] [--iters 10] [--cpu]

Runs on the card unless ``--cpu`` is given. The time is host wall clock
around forwards that end in a device synchronise.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, cast_conv_weights, cidnet_forward


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="HVI-CIDNet (PyTorch) model smoke test")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    dt = getattr(torch, args.dtype)
    model = CIDNet(CIDNetConfig(), generator=torch.Generator().manual_seed(0))
    model = cast_conv_weights(model.to(device), dt).eval()
    x = np.random.default_rng(0).random((args.batch, args.size, args.size, 3))
    x = torch.from_numpy(x).to(device, dt)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.no_grad():
        with FlopCounterMode(display=False) as counter:
            out = cidnet_forward(model, x, compute_dtype=dt)  # also the warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = cidnet_forward(model, x, compute_dtype=dt)
        sync()
        seconds = (time.perf_counter() - t0) / args.iters

    n_param = model.count_params()
    flops = counter.get_total_flops()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"Time: {seconds:.6f} s/forward ({args.batch}x3x{args.size}x{args.size}, "
          f"{args.dtype}, {name})")
    print(f"n_paras: {n_param / 2**20:.3f}M ({n_param:,})")
    print(f"FLOPs: {flops / 2**30:.4f}G (conv + matmul, torch flop counter, per forward)")
    print(f"throughput: {args.batch / seconds:.1f} img/s")
    return {"seconds": seconds, "n_params": n_param, "flops": flops,
            "out_shape": tuple(out.shape), "device": name}


if __name__ == "__main__":
    main()
