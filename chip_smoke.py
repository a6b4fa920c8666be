#!/usr/bin/env python3
"""Drive the PyTorch port of HVI-CIDNet once on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (the CUDA kernels build from
``hvi_cidnet_torch/csrc`` at first use). Imports nothing of JAX. In order:

1. fails unless ``torch.cuda.is_available()``;
2. prints the card's name and power limit (``nvidia-smi``);
3. builds the kernels and prints the build time;
4. holds each kernel against its plain PyTorch twin on the card, in fp32
   and bf16, at the shapes the 600 x 400 forward gives it (batch 8), and
   prints the maximum error and both times;
5. runs the full-width base forward on the card in fp32 (TF32 off) against
   the same weights' plain forward on the CPU at 1 x 400 x 600, and bf16
   against that fp32 result;
6. checks the launches of one forward: K1 1, K2 1, K3 6, K4 6;
7. serves requests through ``serve.Enhancer`` (gates on, gamma != 1) at
   sizes that are not multiples of 8, counting every kernel's launches;
8. prints the forward's images per second at 600 x 400 bf16 (information);
9. prints ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.

Any failure raises, and the script exits nonzero without the last line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 400, 600          # the serving image (600 x 400 landscape), NHWC (B, H, W, 3)
BATCH = 8                # batch of the kernel comparisons
K = 0.2                  # density_k at init

# tolerances, kernel vs its plain twin on the same card and inputs
TOL_FP32 = {"K1": 1e-6, "K2": 1e-5, "K3": 1e-6, "K4": 1e-6}
TOL_BF16 = 2.0**-7       # one bf16 ulp at magnitudes in [1, 2): both round once from fp32
# the full forward, card fp32 vs CPU fp32: conv/attention sums in other
# orders through ~50 layers; outputs are in [0, 1]
TOL_FORWARD_MAX = 1e-4
TOL_FORWARD_MEAN = 1e-6
TOL_BF16_FORWARD_MEAN = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def hue_edge(hvi_nchw: torch.Tensor, k: float) -> torch.Tensor:
    """Pixels whose inverse hue lies within 1e-6 of the mod-1 wrap (computed
    in float64): one ulp there flips hi == 6 (black) against hi == 5."""
    x = hvi_nchw.double()
    hc, vc, ic = x[:, 0].clamp(-1, 1), x[:, 1].clamp(-1, 1), x[:, 2].clamp(0, 1)
    cs = (torch.sin(ic * (0.5 * np.pi)) + 1e-8) ** k
    hc, vc = (hc / (cs + 1e-8)).clamp(-1, 1), (vc / (cs + 1e-8)).clamp(-1, 1)
    h = torch.remainder(torch.atan2(vc + 1e-8, hc + 1e-8) / (2 * np.pi), 1.0)
    return torch.minimum(h, 1 - h) < 1e-6  # (B, H, W)


def check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: max abs err {err:.3e} > tolerance {tol:.1e}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def special_rgb(n: int, device) -> torch.Tensor:
    """Pixels that hit the select chain's ties, gray, zero and one."""
    px = torch.tensor([
        [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.5, 0.5], [0.7, 0.7, 0.2], [0.7, 0.2, 0.7],
        [0.2, 0.7, 0.7], [0.2, 0.2, 0.7], [0.2, 0.7, 0.2], [0.7, 0.2, 0.2], [0.3, 0.2, 0.25],
    ], device=device)
    return px.repeat((n + len(px) - 1) // len(px), 1)[:n]


def hi6_hvi(n: int, device) -> torch.Tensor:
    """HVI pixels whose inverse hue is a tiny negative angle -> hi == 6."""
    i = torch.full((n,), 0.5, device=device)
    h = torch.linspace(0.2, 0.6, n, device=device)
    cs = (np.sin(0.25 * np.pi) + 1e-8) ** K
    v = -torch.linspace(1.2e-8, 2.0e-8, n, device=device) * cs
    return torch.stack([h, v, i])  # (3, n)


def compare_hvi(results: dict, dev) -> None:
    from hvi_cidnet_torch.ops import hvi_cuda as hc

    gen = torch.Generator(device="cpu").manual_seed(0)
    img32 = torch.rand((BATCH, H, W, 3), generator=gen).to(dev)
    img32[0, 0, :64] = special_rgb(64, dev)
    k = torch.full((1,), K, device=dev)
    gate_arms = [
        {}, {"gated": True, "alpha_s": 1.3}, {"gated2": True, "alpha": 0.84},
        {"gated": True, "gated2": True, "alpha": 1.0, "alpha_s": 1.0},
    ]
    for dt in (torch.float32, torch.bfloat16):
        tol1 = TOL_FP32["K1"] if dt == torch.float32 else TOL_BF16
        tol2 = TOL_FP32["K2"] if dt == torch.float32 else TOL_BF16
        img = img32.to(dt)
        got = hc.rgb_to_hvi_kernel(img, k, dt)
        ref = hc.rgb_to_hvi_plain(img, k, dt)
        e1 = max_err(got, ref)
        check(f"K1 {dt}", e1, tol1)
        t_k = time_ms(lambda: hc.rgb_to_hvi_kernel(img, k, dt))
        t_p = time_ms(lambda: hc.rgb_to_hvi_plain(img, k, dt))
        log(f"K1 rgb_to_hvi {tuple(img.shape)} {dt}: max_abs_err {e1:.3e}  "
            f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms")
        results["K1"].append({"dtype": str(dt), "err": e1, "ms": t_k, "plain_ms": t_p})

        # K2 on the HVI map, perturbed, with hi == 6 edge pixels planted
        hvi = ref.float() + 0.05 * torch.randn(ref.shape, generator=gen).to(dev)
        hvi[1, :, 0, :32] = hi6_hvi(32, dev)
        hvi = hvi.to(dt).contiguous()
        edge = hue_edge(hvi, K)
        for gates in gate_arms:
            got = hc.hvi_to_rgb_kernel(hvi, k, **gates)
            ref_rgb = hc.hvi_to_rgb_plain(hvi, k, **gates)
            diff = (got.float() - ref_rgb.float()).abs().amax(-1)
            e2 = diff[~edge].max().item()
            flips = int(((diff > tol2) & edge).sum())
            check(f"K2 {dt} {gates}", e2, tol2)
            if dt == torch.float32 and not gates:
                black = (ref_rgb[1, 0, :32] == 0).all(-1).sum().item()
                if black < 16:
                    raise AssertionError(f"K2: hi == 6 probe hit the edge {black}/32 times")
                if not torch.equal(got[1, 0, :32], ref_rgb[1, 0, :32]):
                    raise AssertionError("K2: hi == 6 pixels differ from the twin")
            t_k = time_ms(lambda: hc.hvi_to_rgb_kernel(hvi, k, **gates))
            t_p = time_ms(lambda: hc.hvi_to_rgb_plain(hvi, k, **gates))
            log(f"K2 hvi_to_rgb {tuple(hvi.shape)} {dt} {gates or 'no gates'}: max_abs_err "
                f"{e2:.3e} (edge pixels {int(edge.sum())}, flipped {flips})  "
                f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms")
            results["K2"].append({"dtype": str(dt), "err": e2, "ms": t_k, "plain_ms": t_p,
                                  "gates": gates})


# (site, input shape (B, C, H, W)) at 600 x 400: NormDownsample's x0.5 input
# is its 3x3 conv output; NormUpsample's x2 input is its folded 3x3 output
def resize_sites(ch=(36, 36, 72, 144)):
    c1, c2, c3, c4 = ch
    down = [("HVE_block1", c2, H, W), ("HVE_block2", c3, H // 2, W // 2),
            ("HVE_block3", c4, H // 4, W // 4)]
    up = [("HVD_block3", c3, H // 8, W // 8), ("HVD_block2", c2, H // 4, W // 4),
          ("HVD_block1", c1, H // 2, W // 2)]
    mirror = {"HVE": "IE", "HVD": "ID"}
    both = lambda sites: sites + [(mirror[s[:3]] + s[3:], c, h, w) for s, c, h, w in sites]
    return both(down), both(up)


def compare_resize(results: dict, dev) -> None:
    from hvi_cidnet_torch.ops import resize_cuda as rc

    gen = torch.Generator(device="cpu").manual_seed(1)
    alpha = torch.full((1,), 0.25, device=dev)
    down, up = resize_sites()
    for dt in (torch.float32, torch.bfloat16):
        for key, sites, kern, plain in (
            ("K3", down, lambda x: rc.half_prelu_kernel(x, alpha), lambda x: rc.half_prelu_plain(x, alpha)),
            ("K4", up, rc.double_bilinear_kernel, rc.double_bilinear_plain),
        ):
            tol = TOL_FP32[key] if dt == torch.float32 else TOL_BF16
            measured = {}
            for site, c, h, w in sites:
                if (c, h, w) not in measured:  # HV and I branches share shapes
                    x = (torch.rand((BATCH, c, h, w), generator=gen) * 2 - 1).to(dev, dt)
                    err = max_err(kern(x), plain(x))
                    check(f"{key} {site} {dt}", err, tol)
                    measured[(c, h, w)] = (err, time_ms(lambda: kern(x)), time_ms(lambda: plain(x)))
                err, t_k, t_p = measured[(c, h, w)]
                log(f"{key} {site} ({BATCH}, {c}, {h}, {w}) {dt}: max_abs_err {err:.3e}  "
                    f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms")
                results[key].append({"dtype": str(dt), "err": err, "ms": t_k, "plain_ms": t_p,
                                     "site": site})


def compare_forward(dev):
    """Card fp32 vs CPU fp32 with the same weights; bf16 card vs fp32 card."""
    from hvi_cidnet_torch.models.cidnet import (
        CIDNet, CIDNetConfig, cast_conv_weights, cidnet_forward, cidnet_hvi,
    )

    cpu_model = CIDNet(CIDNetConfig(), generator=torch.Generator().manual_seed(0)).eval()
    gpu_model = CIDNet(CIDNetConfig(), generator=torch.Generator().manual_seed(0)).to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, H, W, 3)).astype(np.float32))
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = cidnet_forward(cpu_model, x)
        ref_hvi = cidnet_hvi(cpu_model, x)
        cpu_s = time.perf_counter() - t0
        got = cidnet_forward(gpu_model, x.to(dev)).cpu()
        got_hvi = cidnet_hvi(gpu_model, x.to(dev)).cpu()
    for t in (got, ref):
        if t.shape != (1, H, W, 3) or not torch.isfinite(t).all():
            raise AssertionError(f"forward output bad: {tuple(t.shape)}")
    hvi_err = max_err(got_hvi, ref_hvi)
    edge = hue_edge(ref_hvi, K)
    diff = (got - ref).abs().amax(-1)
    err = diff[~edge].max().item()
    mean = (got - ref).abs().mean().item()
    log(f"forward fp32 (1, {H}, {W}, 3): card vs CPU max_abs_err {err:.3e} (hue-edge pixels "
        f"{int(edge.sum())} excluded), mean_abs_err {mean:.3e}, output-HVI max_abs_err "
        f"{hvi_err:.3e}  [CPU fp32 forward x2: {cpu_s:.1f} s]")
    check("forward fp32 card vs CPU", err, TOL_FORWARD_MAX)
    check("forward fp32 card vs CPU (mean)", mean, TOL_FORWARD_MEAN)
    check("forward output HVI card vs CPU", hvi_err, TOL_FORWARD_MAX)

    bf_model = cast_conv_weights(
        CIDNet(CIDNetConfig(), generator=torch.Generator().manual_seed(0)).to(dev), torch.bfloat16
    ).eval()
    with torch.no_grad():
        bf = cidnet_forward(bf_model, x.to(dev, torch.bfloat16), compute_dtype=torch.bfloat16)
    if not torch.isfinite(bf.float()).all():
        raise AssertionError("bf16 forward is not finite")
    bf_mean = (bf.float().cpu() - got).abs().mean().item()
    bf_max = (bf.float().cpu() - got).abs().max().item()
    log(f"forward bf16 vs fp32 on the card: mean_abs_err {bf_mean:.3e}, max_abs_err {bf_max:.3e}")
    check("forward bf16 vs fp32 (mean)", bf_mean, TOL_BF16_FORWARD_MEAN)
    return bf_model


def counts(kernels) -> dict:
    return {k: v.launches for k, v in kernels.items()}


def reset(kernels) -> None:
    for v in kernels.values():
        v.launches = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from hvi_cidnet_torch.models.cidnet import HVIGates, cidnet_forward
    from hvi_cidnet_torch.ops import _build
    from hvi_cidnet_torch.ops import hvi_cuda, resize_cuda
    from hvi_cidnet_torch.serve import Enhancer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    path, nvcc_s = _build.build(verbose=True)
    _build.library()
    log(f"built {os.path.relpath(path, ROOT)}: nvcc {nvcc_s:.1f} s, "
        f"build+load {time.perf_counter() - t0:.1f} s")

    kernels = {"K1": hvi_cuda.RGB_TO_HVI, "K2": hvi_cuda.HVI_TO_RGB,
               "K3": resize_cuda.HALF_PRELU, "K4": resize_cuda.DOUBLE}
    results = {k: [] for k in kernels}
    compare_hvi(results, dev)
    compare_resize(results, dev)
    bf_model = compare_forward(dev)

    # launches of one forward (the bf16 serving model, 1 x 400 x 600)
    x = torch.rand((1, H, W, 3), generator=torch.Generator().manual_seed(2)).to(dev, torch.bfloat16)
    reset(kernels)
    with torch.no_grad():
        cidnet_forward(bf_model, x, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    per_forward = counts(kernels)
    log(f"launches per forward: {per_forward}")
    if per_forward != {"K1": 1, "K2": 1, "K3": 6, "K4": 6}:
        raise AssertionError(f"launches per forward {per_forward} != 1/1/6/6")

    # the main path: requests through the serving entry point
    gates = HVIGates(gated=True, gated2=True, alpha=0.95, alpha_s=1.1)
    enhancer = Enhancer(bf_model, gates, gamma=0.8, compute_dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(3)
    requests = [rng.uniform(0, 0.4, (h, w, 3)).astype(np.float32)
                for h, w in [(400, 600), (389, 517), (600, 400), (389, 517)]]
    reset(kernels)
    t0 = time.perf_counter()
    outs = [enhancer.enhance(img) for img in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    served = counts(kernels)
    for img, out in zip(requests, outs):
        if out.shape != img.shape or not np.isfinite(out).all() or out.min() < 0 or out.max() > 1:
            raise AssertionError(f"served {img.shape} -> {out.shape}: bad output")
    n = len(requests)
    log(f"served {n} requests {[r.shape[:2] for r in requests]} in {serve_s:.3f} s "
        f"(first includes warm-up); launches {served}")
    if served != {"K1": n, "K2": n, "K3": 6 * n, "K4": 6 * n}:
        raise AssertionError(f"serving launches {served} != {n} forwards of 1/1/6/6")

    # throughput at 600 x 400 bf16 (information)
    for b in (1, 8, 32):
        xb = torch.rand((b, H, W, 3), generator=torch.Generator().manual_seed(b)).to(dev, torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms = time_ms(lambda: cidnet_forward(bf_model, xb, compute_dtype=torch.bfloat16).clamp_(0, 1),
                         iters=5, warmup=2)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"forward 600x400 bf16 batch {b}: {ms:.2f} ms, {1000 * b / ms:.1f} img/s, "
            f"peak {peak:.2f} GiB")

    sources = {"K1": ("hvi.cu", "hvi_pallas.py:57"), "K2": ("hvi.cu", "hvi_pallas.py:102"),
               "K3": ("resize.cu", "resize_pallas.py:76"), "K4": ("resize.cu", "resize_pallas.py:143")}
    names = {"K1": "rgb_to_hvi", "K2": "hvi_to_rgb", "K3": "half_prelu", "K4": "double_bilinear"}
    summary = []
    for key in kernels:
        rows = results[key]
        bf = [r for r in rows if r["dtype"] == "torch.bfloat16"]
        if key == "K2":
            bf = bf[:1]  # the no-gates arm, as the forward runs by default
        summary.append({
            "name": names[key],
            "route": "cuda",
            "source": f"hvi_cidnet_torch/csrc/{sources[key][0]}",
            "replaces": f"hvi_cidnet_tpu/ops/{sources[key][1]}",
            "launches": served[key],
            "max_abs_err": max(r["err"] for r in rows if r["dtype"] == "torch.float32"),
            "max_abs_err_bf16": max(r["err"] for r in rows if r["dtype"] == "torch.bfloat16"),
            # per forward at 600 x 400 batch 8 bf16: all of the kernel's sites
            "ms": sum(r["ms"] for r in bf),
            "plain_ms": sum(r["plain_ms"] for r in bf),
        })
    log(smi)  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
