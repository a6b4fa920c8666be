"""Where the forward's device time goes: one ``torch.profiler`` run.

    python -m hvi_cidnet_torch.cli.profile_forward [--variant base|mssa|tnsm]
        [--batch 1 8] [--fused | --probe] [--input-layout nhwc|hwcb] [--out FILE.json]

Runs on the card (600 x 400, bf16, random weights from seed 0). For each
batch it prints the forward's time from CUDA events (unprofiled), then,
over ITERS profiled forwards: the device-busy share of the wall time (the
kernels' summed device time over the host wall clock; one stream, so
kernels do not overlap), the kernel launches per forward, and the kernels
by summed device time (the TOP longest) with their share and launches per
forward. ``--fused`` takes the fused block route, ``--probe`` the probe
route (``ops/routes.py``). ``--input-layout hwcb`` feeds the forward
(H, W, 3, B) batches through the HWCB serving contract (the JAX bench's
``BENCH_INPUT_LAYOUT=hwcb``): one relayout in (P14) and one out (P11).
``--out`` writes the same as JSON.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from hvi_cidnet_torch.models.cidnet import (
    LAYOUTS,
    VARIANTS,
    CIDNet,
    CIDNetConfig,
    cast_conv_weights,
    cidnet_forward,
)
from hvi_cidnet_torch.ops import routes

H, W = 400, 600
ITERS = 3
TOP = 25


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="profile the CIDNet forward on the card")
    p.add_argument("--variant", type=str, default="base", choices=list(VARIANTS))
    p.add_argument("--batch", type=int, nargs="+", default=[1, 8])
    p.add_argument("--out", type=str, default="")
    p.add_argument("--input-layout", type=str, default="nhwc", choices=list(LAYOUTS))
    routes.add_flags(p)
    return p.parse_args(argv)


def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def profile_batch(model, x, routes=None, input_layout="nhwc") -> dict:
    fwd = lambda: cidnet_forward(model, x, compute_dtype=torch.bfloat16, routes=routes,
                                 input_layout=input_layout)
    with torch.no_grad():
        for _ in range(2):
            fwd()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(ITERS):
            fwd()
        end.record()
        torch.cuda.synchronize()
        forward_ms = start.elapsed_time(end) / ITERS
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                fwd()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(_device_us(e) for e in kernels)
    rows = sorted(kernels, key=_device_us, reverse=True)
    return {
        "batch": int(x.shape[-1 if input_layout == "hwcb" else 0]),
        "forward_ms": forward_ms,
        "profiled_wall_ms_per_forward": wall_us / ITERS / 1e3,
        "device_ms_per_forward": total / ITERS / 1e3,
        "device_busy_share": total / wall_us if wall_us else None,
        "launches_per_forward": sum(e.count for e in kernels) / ITERS,
        "kernels": [{"name": e.key, "ms_per_forward": _device_us(e) / ITERS / 1e3,
                     "share": _device_us(e) / total if total else None,
                     "launches_per_forward": e.count / ITERS} for e in rows[:TOP]],
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: needs a CUDA card")
    dev = torch.device("cuda", 0)
    model = CIDNet(CIDNetConfig(variant=args.variant), generator=torch.Generator().manual_seed(0))
    model = cast_conv_weights(model.to(dev), torch.bfloat16).eval()
    route = routes.from_flags(args)
    name = "fused" if args.fused else "probe" if args.probe else "default"
    result = {"device": torch.cuda.get_device_name(0), "variant": args.variant, "size": [H, W],
              "route": name, "input_layout": args.input_layout, "batches": []}
    print(f"{result['device']}: {args.variant} forward {W}x{H} bf16 ({name} route, "
          f"{args.input_layout})")
    for b in args.batch:
        x = torch.from_numpy(np.random.default_rng(b).uniform(0, 1, (b, H, W, 3)))
        if args.input_layout == "hwcb":
            x = x.permute(1, 2, 3, 0).contiguous()
        r = profile_batch(model, x.to(dev, torch.bfloat16), route, args.input_layout)
        result["batches"].append(r)
        print(f"batch {b}: {r['forward_ms']:.2f} ms/forward unprofiled; profiled "
              f"{r['profiled_wall_ms_per_forward']:.2f} ms wall, device busy "
              f"{r['device_ms_per_forward']:.2f} ms ({100 * r['device_busy_share']:.1f}%), "
              f"{r['launches_per_forward']:.0f} launches per forward")
        for k in r["kernels"]:
            print(f"  {100 * k['share']:5.1f}%  {k['ms_per_forward']:8.3f} ms  "
                  f"{k['launches_per_forward']:6.0f}x  {k['name'][:110]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
