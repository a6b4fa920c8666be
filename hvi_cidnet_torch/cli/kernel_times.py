"""Device time per call of K3 (bilinear x0.5 + PReLU), K1 (RGB -> HVI) and
K2 (HVI -> RGB) at the 600 x 400 base forward's shapes.

    python -m hvi_cidnet_torch.cli.kernel_times [--batch 8 1] [--out FILE.json]

Runs on the card. For K3 at NormDownsample's three sites (36 x 400 x 600,
72 x 200 x 300, 144 x 100 x 150 per image), K1 at 400 x 600 x 3 and K2 at
3 x 400 x 600, per batch, in bf16 and fp32 (K1 from and to the same type,
as the forward calls it), it prints the kernel's device time per call from
a CUDA graph of GRAPH_CALLS launches (no host work between them: at batch 1
the wrapper's host work otherwise sets the pace), its time through the
wrapper from CUDA events, its bytes bound (each input read once, each
output written once, over 3.35 TB/s), and its agreement with the plain twin
(bitwise equal, else the max error).

It uses only the kernels' wrappers and twins, so another checkout (a
parent commit unpacked with ``git archive``) is timed by running this file
with that checkout first on the path, in turns with this one on one card:

    PYTHONPATH=build/parent python hvi_cidnet_torch/cli/kernel_times.py
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

import hvi_cidnet_torch
from hvi_cidnet_torch.ops import hvi_cuda, resize_cuda

H, W = 400, 600
K3_SITES = (("block1", 36, H, W), ("block2", 72, H // 2, W // 2), ("block3", 144, H // 4, W // 4))
HBM_BYTES_PER_S = 3.35e12
GRAPH_CALLS = 20
REPLAYS = 5
K = 0.2        # density_k at init
ALPHA = 0.25   # a PReLU slope


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="time K3, K1 and K2 per call on the card")
    p.add_argument("--batch", type=int, nargs="+", default=[8, 1])
    p.add_argument("--out", type=str, default="")
    return p.parse_args(argv)


def graph_ms(fn) -> float:
    """Device time per call of ``fn`` from a CUDA graph of GRAPH_CALLS calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture: builds, caches
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (REPLAYS * GRAPH_CALLS)


def wrapper_ms(fn, iters: int = 50) -> float:
    """Time per call through the wrapper, host work included (CUDA events)."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(name: str, kernel, plain, x: torch.Tensor, bytes_moved: int, **info) -> dict:
    got, ref = kernel(), plain()
    row = {"kernel": name, **info, "dtype": str(x.dtype).removeprefix("torch."),
           "shape": list(x.shape), "bitwise": bool(torch.equal(got, ref)),
           "max_abs_err": (got.float() - ref.float()).abs().max().item(),
           "graph_ms": graph_ms(kernel), "wrapper_ms": wrapper_ms(kernel),
           "bound_ms": 1e3 * bytes_moved / HBM_BYTES_PER_S}
    print(f"{name} {info} {row['dtype']} {tuple(x.shape)}: {1e3 * row['graph_ms']:.2f} us a call "
          f"(graph), {1e3 * row['wrapper_ms']:.2f} us through the wrapper, bound "
          f"{1e3 * row['bound_ms']:.2f} us; bitwise {row['bitwise']}, max err "
          f"{row['max_abs_err']:.3e}", flush=True)
    return row


def main(argv=None) -> dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    alpha = torch.full((1,), ALPHA, device=dev)
    k = torch.full((1,), K, device=dev)
    result = {"device": torch.cuda.get_device_name(0), "package": hvi_cidnet_torch.__file__,
              "rows": []}
    print(f"{result['device']}: K3, K1 and K2 of {result['package']}")
    for dt in (torch.bfloat16, torch.float32):
        for b in args.batch:
            for site, c, h, w in K3_SITES:
                x = (torch.rand((b, c, h, w), generator=gen) * 2 - 1).to(dev, dt)
                result["rows"].append(measure(
                    "K3", lambda: resize_cuda.half_prelu_kernel(x, alpha),
                    lambda: resize_cuda.half_prelu_plain(x, alpha), x,
                    x.numel() * x.element_size() * 5 // 4, site=site, batch=b))
            img = torch.rand((b, H, W, 3), generator=gen).to(dev)
            rgb = img.to(dt)
            result["rows"].append(measure(
                "K1", lambda: hvi_cuda.rgb_to_hvi_kernel(rgb, k, dt),
                lambda: hvi_cuda.rgb_to_hvi_plain(rgb, k, dt), rgb,
                2 * rgb.numel() * rgb.element_size(), batch=b))
            hvi = hvi_cuda.rgb_to_hvi_plain(img, k, torch.float32)
            hvi = (hvi + 0.05 * torch.randn(hvi.shape, generator=gen).to(dev)).to(dt).contiguous()
            result["rows"].append(measure(
                "K2", lambda: hvi_cuda.hvi_to_rgb_kernel(hvi, k),
                lambda: hvi_cuda.hvi_to_rgb_plain(hvi, k), hvi,
                2 * hvi.numel() * hvi.element_size(), batch=b))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
