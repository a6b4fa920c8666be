#!/usr/bin/env python3
"""Drive the PyTorch port of HVI-CIDNet once on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (the CUDA kernels build from
``hvi_cidnet_torch/csrc`` at first use). Imports nothing of JAX. In order:

1. fails unless ``torch.cuda.is_available()``;
2. prints the card's name and power limit (``nvidia-smi``);
3. builds the kernels K1-K7, the fused block route's P2/P3, P4 and P5,
   the probe route's P1, P6 and P10/P15 and the relayout of P7, P8/P9/P11,
   P12/P13 and P14 (one ``nvcc`` a source, all started together) and
   prints the build time;
4. holds each kernel against its plain PyTorch twin on the card, in fp32
   and bf16, at every site shape the 600 x 400 forward gives it (batch 8),
   and prints the error, the kernel's and the twin's times (and, for K4,
   the one PyTorch call that computes the same function; for K1 and K2 the
   launch plan and the time the card takes to issue the SASS instructions
   of the kernel's fast path); K5 also in its
   unnormalised and unfolded arms, and twice for identical bits, on q and
   k with shared structure; K5 must also be rejected on planted faults
   (k rows met in the wrong place, a k tile dropped). K1, K3, K4 and K7
   must be bitwise equal to their twins; K4 and K7 are also timed at
   batch 1 at level 1, K5 and K6 at levels 1 and 3, K3 at block1 and
   block3, K1 at 1 x 400 x 600 x 3 and K2 at 1 x 3 x 400 x 600;
4b. holds the fused block route's kernels against their plain versions at
   every site shape of the 600 x 400 batch-8 forward, fp32 and bf16: P2/P3
   (LayerNorm + IEL, residual on and off) at the three LCA levels, P4 at
   the stems, heads and NormUpsample convs (replication and zero pad), P5
   at the three NormDownsamples; fp32 within 1e-5 relative, bf16 within one
   bf16 ulp of the plain version's rounding (or the fp32 bar); with each
   kernel's time, its plain version's, its bound and what the unfused route
   runs in its place (P4: ``F.conv2d``, cuDNN; P5: cuDNN + K3; P2/P3: K6,
   the 1x1 convs, 2 x K7 and the product);
4c. holds the probe route's kernels against their plain versions at every
   site shape of the 600 x 400 batch-8 forward and at batch 1 (N tails),
   fp32 and bf16: P1 at the three LCA levels (q and k of shared structure,
   fp32 against its plain version on the CPU within 1e-5 relative, bf16
   within two ulps at the apply's scale), P10/P15 at TNSM's three (within
   1e-5 |q_r| |k_c| of its plain version on the CPU), P6 at the 16 dense
   3x3 convs (1e-5 relative, bf16 one ulp); each also twice for the same
   bits (P1, P10/P15) and against a planted fault (k rows permuted) that
   the bar must reject; with each kernel's time, its plain version's, its
   bound and the comparators: K5 at the same sites (P1, P10/P15), and for
   P6 ``torch.matmul`` on the same staged operand and ``F.conv2d``
   (cuDNN) for the whole conv;
4d. holds the relayout against its plain versions, bitwise (``torch.equal``),
   fp32 and bf16: P7 (steps 1, 2, 3), P8, P9, P11, P12, P13 and P14 at the
   three LCA levels ((N, C, B), batch 8 and 1), the HWCB entry (P14) and
   exit (P11) at batch 1, 8 and 32; with the device time a call of the
   kernel, its plain version and one ``permute(...).contiguous()`` (CUDA
   graphs), and the bound;
5. runs the full-width base, MSSA and TNSM forwards on the card in fp32
   (TF32 off) against the same weights' plain forward on the CPU at
   1 x 400 x 600, and bf16 against that fp32 result; TNSM also with
   ``training=True`` (the fused noise map, card vs CPU, and its launches:
   K5 24, K6 84), and K5's unnormalised arm on the q, k, v and temperature
   captured from the full-width TNSM forward at each of its three site
   shapes, against its twin run on the CPU in fp32;
5b. the same three forwards on the fused block route (card fp32 vs CPU
   fp32 at each variant's bars, bf16 vs fp32; TNSM's training forward and
   its launches);
5c. the same on the probe route;
5d. the three forwards with ``input_layout="hwcb"`` (the JAX package's
   serving contract, (H, W, 3, B) in and out) on the default route: fp32
   card vs CPU at each variant's bars, bitwise the card's NHWC forward
   permuted at batch 1 and 2, TNSM's training noise map (H, W, 3, B);
6. checks the launches of one forward: base K1 1, K2 1, K3 6, K4 6, K5 11,
   K6 33, K7 22; MSSA the same with K5 12, K6 36, K7 24; TNSM K5 23, K6
   80, K7 24; on the fused route base P2/P3 11, P4 10, P5 6, K3 0, K4 6,
   K5 11, K6 22, K7 0, MSSA and TNSM P2/P3 12 and K6 24 and 68; on the
   probe route base P1 11, P6 16, P10/P15 0, K5 0, K3 6, K4 6, K6 33, K7
   22, MSSA P1 12, K6 36, K7 24, TNSM P1 12, P10/P15 11, K5 0; an HWCB
   forward the default route's counts and P14 1, P8/P9/P11 1 (TNSM with
   training=True 2);
7. serves requests through ``serve.Enhancer`` (gates on, gamma != 1) at
   sizes that are not multiples of 8, for each variant, counting every
   kernel's launches (the main path), then again on the fused route and on
   the probe route; then batches packed as (H, W, 3, B) through the HWCB
   contract for each variant (this slice's path); each run's counts are set
   to 0 before it and read after;
8. prints each variant's images per second at 600 x 400 bf16, batch 1, 8
   and 32, on the default, the fused and the probe route, and HWCB against
   NHWC on the default route in turns (information);
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

# tolerances, kernel vs its plain twin on the same inputs (on the card, but
# for K5 in fp32 on the CPU: k5_twin_cpu). K1, K3, K4 and K7 run the twin's
# fp32 ops in the same order (K1 with exact rewrites) and must be bitwise
# equal (torch.equal) in fp32 and bf16. K2 runs the twin's ops but not all
# of its library calls' bits (one fp32 ulp at most); K5
# and K6 sum over space or channels in another order than the twin's GEMM
# or reduction, so fp32 gets a few ulps of the sum.
BITWISE = ("K1", "K3", "K4", "K7")
TOL_FP32 = {"K2": 1e-5, "K5": 2e-5, "K6": 1e-5}
TOL_BF16 = 2.0**-7       # one bf16 ulp at magnitudes in [1, 2): both round once from fp32
# the fused route's kernels P2/P3, P4 and P5 compute in fp32 inside as their
# plain versions do and round once: fp32 within TOL_FUSED of max(1, |ref|)
# (sums over C, the hidden width or the taps in another order), bf16 within
# one bf16 ulp at max(|got|, |ref|), or the fp32 bar where that is larger
# (a last-bit fp32 difference may flip the one rounding)
FUSED = ("P2/P3", "P4", "P5")
TOL_FUSED = 1e-5
# K5-K7 in bf16: a last-bit fp32 difference can flip the bf16 rounding of
# one intermediate (A, the LN scale/shift, t1), which moves the output by an
# ulp: two ulps relative, |err| <= TOL_BF16_REL * max(1, |ref|)
TOL_BF16_REL = 2.0**-6
# the full forward, card fp32 vs CPU fp32: conv/attention sums in other
# orders through ~50 layers; outputs are in [0, 1]
TOL_FORWARD_MAX = 1e-4
TOL_FORWARD_MEAN = 1e-6
TOL_BF16_FORWARD_MEAN = 2e-2
# TNSM: its attention is unnormalised, so its softmax rows take raw sums
# over up to 60,000 pixels (|score| up to ~1.6e4 at 288 x 432, more at 400 x
# 600) and are nearly one-hot; a last-bit change moves more of the output
# than in base. Set from the reference's own sensitivity at full width,
# 1 x 96 x 144 / 192 x 288 / 288 x 432 on the CPU (tests/tnsm_sensitivity.py,
# PERF.md): the JAX package's fp32 forward vs the port's fp32 forward max
# 1.1e-5 / 2.7e-6 / 1.1e-5, mean 8.6e-7 / 4.0e-7 / 6.9e-7 (base: 8.6e-7 max,
# 3.2e-8 mean, so base's mean bar would not hold); the port's forward on an
# input moved by one ulp max 1.1e-5, mean 6.8e-7; the fused noise map 1.2e-7
# max; the JAX package's own bf16 forward vs its fp32 mean 3.5e-3 / 1.74e-2
# / 1.65e-2 (a bf16 q or k moves a raw score by units, which flips a near-
# tied row's winner; base 1.1e-3). The fp32 bars are 9-12x the largest of
# those (the noise map's 80x), the bf16 mean 3x; base and MSSA keep theirs.
TOL_TNSM = {"max": 1e-4, "mean": 1e-5, "bf16_mean": 5e-2, "noise_max": 1e-5}

# the card's peaks for bound_ms (NVIDIA's H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "fp32": 67e12}
# instruction issue of the math-bound K1 and K2: SASS instructions a pixel on
# the fast path under the batch-8 plan (cuobjdump -sass of the bf16 kernels,
# PERF.md), one a clock on each of the 528 schedulers (132 SMs x 4) at
# ~1.98 GHz
SASS_PER_PIXEL = {"K1": 267, "K2": 264}
WARP_INSTRUCTIONS_PER_S = 528 * 1.98e9
VARIANTS = ("base", "mssa", "tnsm")
# launches of one forward per kernel; MSSA also runs I_LCA5 (one more LCA);
# TNSM runs 12 LCAs (3 K6, 1 K5, 2 K7 each) and 11 TNSM blocks (4 K6, 1 K5
# each: I_TNSM5 reaches nothing when serving), and with training=True all 12
NONE_FUSED = {"P2/P3": 0, "P4": 0, "P5": 0}
NONE_PROBE = {"P1": 0, "P6": 0, "P10/P15": 0}
RELAYOUTS = ("P7", "P8/P9/P11", "P12/P13", "P14")
NONE_RELAYOUT = {k: 0 for k in RELAYOUTS}
PER_FORWARD = {
    "base": {"K1": 1, "K2": 1, "K3": 6, "K4": 6, "K5": 11, "K6": 33, "K7": 22, **NONE_FUSED,
             **NONE_PROBE, **NONE_RELAYOUT},
    "mssa": {"K1": 1, "K2": 1, "K3": 6, "K4": 6, "K5": 12, "K6": 36, "K7": 24, **NONE_FUSED,
             **NONE_PROBE, **NONE_RELAYOUT},
    "tnsm": {"K1": 1, "K2": 1, "K3": 6, "K4": 6, "K5": 23, "K6": 80, "K7": 24, **NONE_FUSED,
             **NONE_PROBE, **NONE_RELAYOUT},
}
TNSM_TRAINING = dict(PER_FORWARD["tnsm"], K5=24, K6=84)
# on the fused block route: one P2/P3 an LCA in place of its IEL's K6 and
# two K7; P5 in place of each NormDownsample's conv and K3; P4 at the 4
# stems and heads and the 6 NormUpsamples
PER_FORWARD_FUSED = {
    "base": {"K1": 1, "K2": 1, "K3": 0, "K4": 6, "K5": 11, "K6": 22, "K7": 0,
             "P2/P3": 11, "P4": 10, "P5": 6, **NONE_PROBE, **NONE_RELAYOUT},
    "mssa": {"K1": 1, "K2": 1, "K3": 0, "K4": 6, "K5": 12, "K6": 24, "K7": 0,
             "P2/P3": 12, "P4": 10, "P5": 6, **NONE_PROBE, **NONE_RELAYOUT},
    "tnsm": {"K1": 1, "K2": 1, "K3": 0, "K4": 6, "K5": 23, "K6": 68, "K7": 0,
             "P2/P3": 12, "P4": 10, "P5": 6, **NONE_PROBE, **NONE_RELAYOUT},
}
TNSM_TRAINING_FUSED = dict(PER_FORWARD_FUSED["tnsm"], K5=24, K6=72)
# on the probe route: one P1 an LCA and one P10/P15 a TNSM block in place of
# K5; P6 at the 16 dense 3x3 convs (each NormDownsample's still followed by
# K3)
PER_FORWARD_PROBE = {v: dict(PER_FORWARD[v], K5=0, P1=12 if v != "base" else 11, P6=16,
                             **{"P10/P15": 11 if v == "tnsm" else 0}) for v in VARIANTS}
TNSM_TRAINING_PROBE = dict(PER_FORWARD_PROBE["tnsm"], K6=84, **{"P10/P15": 12})
# the HWCB serving contract (input_layout="hwcb", default route): P14 packs
# the (H W, 3, B) input into NHWC, P11 turns K2's NHWC output (and, with
# training=True, TNSM's fused noise map) into (H, W, 3, B)
PER_FORWARD_HWCB = {v: dict(PER_FORWARD[v], P14=1, **{"P8/P9/P11": 1}) for v in VARIANTS}
TNSM_TRAINING_HWCB = dict(TNSM_TRAINING, P14=1, **{"P8/P9/P11": 2})
# the probe route's kernels: fp32 within TOL_PROBE * max(1, |ref|) (P1, P6),
# P10/P15 within TOL_PROBE * |q_r| |k_c|; P1 and P10/P15 in fp32 against
# their plain versions run on the CPU (the card's fp32 bmm drifts on q and k
# of shared structure, as K5's twin does). bf16: P6 within one ulp of the
# plain version's rounding (fused_excess); P1 within two ulps at the
# apply's scale, max(|got|, |ref|, sum_j A_ij |v_j|): A is rounded once to
# bf16 before the apply, and a last-bit difference in the fp32 softmax that
# flips one entry's rounding moves the output by at most two ulps there
PROBE = ("P1", "P6", "P10/P15")
TOL_PROBE = 1e-5


# route name -> (Routes or None, launches per forward by variant, TNSM's
# training launches); filled by main once the package is imported
ROUTES: dict = {}


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


def check_equal(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """Bitwise equality; returns the max abs error (0.0) for the record."""
    if not torch.equal(got, ref):
        raise AssertionError(f"{name}: not bitwise equal to the twin, max abs err "
                             f"{max_err(got, ref):.3e}")
    return max_err(got, ref)


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
        tol2 = TOL_FP32["K2"] if dt == torch.float32 else TOL_BF16
        img = img32.to(dt)
        ref = hc.rgb_to_hvi_plain(img, k, dt)
        e1 = check_equal(f"K1 {dt}", hc.rgb_to_hvi_kernel(img, k, dt), ref)
        t_k = time_ms(lambda: hc.rgb_to_hvi_kernel(img, k, dt))
        t_p = time_ms(lambda: hc.rgb_to_hvi_plain(img, k, dt))
        bound = bound_ms("K1", img)
        plan = hc.rgb_to_hvi_plan(BATCH, H * W, img.element_size(), img.element_size())
        log(f"K1 rgb_to_hvi {tuple(img.shape)} {dt}: bitwise equal to the twin  kernel "
            f"{t_k:.4f} ms  plain {t_p:.4f} ms  bound {bound[0]:.4f} ms ({bound[1]}), issue "
            f"~{issue_ms('K1', img):.4f} ms  plan {plan}")
        results["K1"].append({"dtype": str(dt), "err": e1, "ms": t_k, "plain_ms": t_p,
                              "library_ms": None, "bound_ms": bound[0], "bound_by": bound[1]})

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
                f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  issue ~{issue_ms('K2', hvi):.4f} ms")
            bound = bound_ms("K2", hvi)
            results["K2"].append({"dtype": str(dt), "err": e2, "ms": t_k, "plain_ms": t_p,
                                  "library_ms": None, "bound_ms": bound[0],
                                  "bound_by": bound[1], "gates": gates})


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
            measured = {}
            for site, c, h, w in sites:
                if (c, h, w) not in measured:  # HV and I branches share shapes
                    x = (torch.rand((BATCH, c, h, w), generator=gen) * 2 - 1).to(dev, dt)
                    if key in BITWISE:
                        err = check_equal(f"{key} {site} {dt}", kern(x), plain(x))
                    else:
                        err = max_err(kern(x), plain(x))
                        check(f"{key} {site} {dt}", err,
                              TOL_FP32[key] if dt == torch.float32 else TOL_BF16)
                    lib = None
                    if key == "K4":  # the one PyTorch call of the same function
                        lib = time_ms(lambda: torch.nn.functional.interpolate(
                            x, scale_factor=2, mode="bilinear", align_corners=True))
                    measured[(c, h, w)] = (err, time_ms(lambda: kern(x)), time_ms(lambda: plain(x)),
                                           lib, bound_ms(key, x))
                err, t_k, t_p, lib, bound = measured[(c, h, w)]
                log(f"{key} {site} ({BATCH}, {c}, {h}, {w}) {dt}: max_abs_err {err:.3e}  "
                    f"kernel {t_k:.4f} ms  plain {t_p:.4f} ms  "
                    + (f"F.interpolate {lib:.4f} ms  " if lib is not None else "")
                    + f"bound {bound[0]:.4f} ms ({bound[1]})")
                results[key].append({"dtype": str(dt), "err": err, "ms": t_k, "plain_ms": t_p,
                                     "library_ms": lib, "bound_ms": bound[0],
                                     "bound_by": bound[1], "site": site})


# nominal fp32 operations per output element of the kernels whose work is
# not a product (CUDA-core arithmetic): they show that bytes bound them
OPS_PER_ELEMENT = {"K1": 40, "K2": 50, "K3": 24, "K4": 12, "K6": 8, "K7": 38}


def bound_ms(key: str, x: torch.Tensor, *, heads: int = 1, fold: bool = True,
             peak: str = "") -> tuple:
    """(least time in ms, "bytes" or "operations") for kernel ``key`` on
    input ``x`` (K5: q): each input read once and each output written once
    over 3.35 TB/s, against the operations over the peak of their type."""
    it, n_el = x.element_size(), x.numel()
    if key in ("K1", "K2"):
        nbytes, ops = 2 * n_el * it, OPS_PER_ELEMENT[key] * n_el // 3
    elif key == "K3":
        nbytes, ops = n_el * it + n_el // 4 * it, OPS_PER_ELEMENT[key] * n_el // 4
    elif key == "K4":
        nbytes, ops = 5 * n_el * it, OPS_PER_ELEMENT[key] * 4 * n_el
    elif key == "K6":
        nbytes, ops = 2 * n_el * it + 8 * x.shape[1], OPS_PER_ELEMENT[key] * n_el
    elif key == "K7":
        nbytes, ops = 2 * n_el * it + 18 * x.shape[1] * it, OPS_PER_ELEMENT[key] * n_el
    else:  # K5: q, k, v read, out written; block-diagonal scores, norms, the apply
        b, c = x.shape[:2]
        cp, n = c // heads, n_el // (x.shape[0] * x.shape[1])
        nbytes = 4 * n_el * it + (c * c * it if fold else 0)
        ops = 2 * b * c * cp * n + 4 * b * c * n + 2 * b * c * (c if fold else cp) * n
    peak = peak or ("bf16_tensor" if key == "K5" and x.dtype == torch.bfloat16 else "fp32")
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[peak]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def issue_ms(key: str, x: torch.Tensor) -> float:
    """The time the card takes to issue K1's or K2's fast-path instructions
    for the pixels of ``x`` (a warp's 32 pixels a warp instruction)."""
    return 1e3 * x.numel() // 3 * SASS_PER_PIXEL[key] / 32 / WARP_INSTRUCTIONS_PER_S


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max(1, |ref|)."""
    return ((got.float() - ref.float()).abs() / ref.float().abs().clamp_min(1.0)).max().item()


# (level, C, heads, H, W, LCA blocks per path) at 600 x 400: LCA1/6 at H/2,
# LCA2/5 at H/4 (base skips I_LCA5), LCA3/4 at H/8. Per LCA block: one K5,
# three K6 (norm of x, y and x + CAB), two K7.
def lca_sites(ch=(36, 36, 72, 144), heads=(1, 2, 4, 8)):
    _, c2, c3, c4 = ch
    _, h2, h3, h4 = heads
    return [(1, c2, h2, H // 2, W // 2, {"base": 4, "mssa": 4, "tnsm": 4}),
            (2, c3, h3, H // 4, W // 4, {"base": 3, "mssa": 4, "tnsm": 4}),
            (3, c4, h4, H // 8, W // 8, {"base": 4, "mssa": 4, "tnsm": 4})]


# TNSM blocks of a serving forward per level: TNSM1/6, TNSM2 and HV_TNSM5,
# TNSM3/4. Per block: one K5 (unnormalised) and four K6 (norm1 of x and y,
# norm2, the filter's norm).
TNSM_BLOCKS = {1: 4, 2: 3, 3: 4}


def site_launches(key: str, level: int, lcas: dict, arm: str = "forward") -> dict:
    """Launches per forward of each path at one LCA-level site shape: K5's
    normalised arm in the LCAs, its unnormalised arm in the TNSM blocks."""
    tnsm = {v: TNSM_BLOCKS[level] if v == "tnsm" else 0 for v in VARIANTS}
    if key == "K5":
        return tnsm if arm == "unnormalised" else dict(lcas)
    if key == "K6":
        return {v: 3 * lcas[v] + 4 * tnsm[v] for v in VARIANTS}
    return {v: 2 * lcas[v] for v in VARIANTS}  # K7


def k5_inputs(gen, shape, heads, dev, dt, normalised: bool):
    """q, k and the temperature of a K5 check whose result depends on which
    q row meets which k row. q = U z + e over space (a rank-4 part common to
    all rows: row pairs meet at cosines spread over (-1, 1)); k = q + e' (each
    q row meets its own k row at a cosine near 0.9); temperatures 3-8 (2-4
    unnormalised, rows of norm 1.5) make the softmax rows peaked, so a k row
    met in the wrong place moves the output by a large share of |v|."""
    b, c = shape[:2]
    n = int(np.prod(shape[2:]))
    z = torch.randn((b, 4, n), generator=gen)
    q = torch.randn((c, 4), generator=gen) @ z + 0.5 * torch.randn((b, c, n), generator=gen)
    k = q + 0.5 * torch.randn((b, c, n), generator=gen)
    rms = q.square().mean().sqrt()
    scale = 1.0 / rms if normalised else 1.5 / (rms * n**0.5)
    lo, hi = (3.0, 8.0) if normalised else (2.0, 4.0)
    temp = torch.rand((heads, 1, 1), generator=gen) * (hi - lo) + lo
    return ((q * scale).reshape(shape).to(dev, dt), (k * scale).reshape(shape).to(dev, dt),
            temp.to(dev))


def k5_twin_cpu(q, k, v, temp, heads, normalize_qk, w_proj):
    """K5's twin run on the CPU on copies of the same inputs: the fp32
    reference. The card's twin takes its scores from one cuBLAS fp32 GEMM
    over N; on q and k of shared structure the diagonal sums grow steadily,
    and a long fp32 accumulation over N = 60000 loses a few 1e-6 relative
    against float64, which temperatures up to 8 carry into the output
    (compare_lca logs that gap beside the kernel's error)."""
    from hvi_cidnet_torch.ops import attention_cuda as ac

    cpu = [t.cpu() for t in (q, k, v, temp)]
    ref = ac.channel_attention_plain(*cpu, heads, normalize_qk=normalize_qk,
                                     w_proj=None if w_proj is None else w_proj.cpu())
    return ref.to(q.device)


def k5_planted_faults(k: torch.Tensor, heads: int) -> dict:
    """Inputs under which a right K5 computes what a wrong one would on the
    true inputs: k rows permuted within each head, q rows met by another
    head's k rows, one 8-row k tile of one image dropped, all scores zero.
    The check must reject the kernel's output on each against the twin's on
    the true inputs."""
    b, c = k.shape[:2]
    cp = c // heads
    by_head = k.reshape(b, heads, cp, *k.shape[2:])
    faults = {"k rows permuted within heads": by_head.flip(2).reshape(k.shape).contiguous()}
    if heads > 1:
        faults["q met by another head's k"] = by_head.roll(1, 1).reshape(k.shape).contiguous()
    dropped = k.clone()
    dropped[0, 8:16] = 0
    faults["one 8-row k tile dropped"] = dropped
    faults["scores all zero"] = torch.zeros_like(k)
    return faults


def compare_lca(results: dict, dev) -> None:
    """K5-K7 against their twins at every LCA site shape, fp32 and bf16."""
    from hvi_cidnet_torch.ops import attention_cuda as ac
    from hvi_cidnet_torch.ops import iel_cuda as ic
    from hvi_cidnet_torch.ops import norm_cuda as nc

    gen = torch.Generator(device="cpu").manual_seed(4)

    def rnd(shape, lo, hi, dt):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dev, dt)

    def judge(name, got, ref, dt):
        if name[:2] in BITWISE:
            return check_equal(name, got, ref), 0.0
        err, rel = max_err(got, ref), rel_err(got, ref)
        if dt == torch.float32:
            check(name, err, TOL_FP32[name[:2]])
        elif not rel <= TOL_BF16_REL:
            raise AssertionError(f"{name}: max err relative to max(1, |ref|) {rel:.3e} > "
                                 f"tolerance {TOL_BF16_REL:.1e}")
        return err, rel

    def record(key, dt, site, err, rel, kern, plain, x, arm="forward", **bound_kw):
        t_k, t_p = time_ms(kern), time_ms(plain)
        bound = bound_ms(key, x, **bound_kw)
        row = {"dtype": str(dt), "err": err, "rel": rel, "ms": t_k, "plain_ms": t_p,
               "library_ms": None, "bound_ms": bound[0], "bound_by": bound[1], "site": site,
               "arm": arm, "per_forward": site_launches(key, site["level"], site["lcas"], arm)}
        if key == "K5":
            row["bound_cuda_core_ms"] = bound_ms(key, x, peak="fp32", **bound_kw)[0]
        results[key].append(row)
        log(f"{key} {arm if key == 'K5' else ''} {site} {tuple(x.shape)} {dt}: max_abs_err "
            f"{err:.3e} (rel {rel:.3e})  kernel {t_k:.4f} ms  plain {t_p:.4f} ms  bound "
            f"{bound[0]:.4f} ms ({bound[1]})"
            + (f", CUDA-core bound {row['bound_cuda_core_ms']:.4f} ms" if key == "K5" else ""))

    for dt in (torch.float32, torch.bfloat16):
        for level, c, heads, h, w, lcas in lca_sites():
            site = {"level": level, "lcas": lcas}
            # K5: the forward's arm (q/k normalised, project_out folded), then
            # the unfolded arm and TNSM's unnormalised arm; q and k share
            # structure (k5_inputs), and each planted fault must be rejected
            shape = (BATCH, c, h, w)
            q, k, temp = k5_inputs(gen, shape, heads, dev, dt, True)
            qs, ks, temps = k5_inputs(gen, shape, heads, dev, dt, False)
            v = rnd(shape, -1.0, 1.0, dt)
            wp = rnd((c, c, 1, 1), -c**-0.5, c**-0.5, dt)
            for arm, qq, kk, tt, norm, fold in (
                    ("forward", q, k, temp, True, wp), ("unfolded", q, k, temp, True, None),
                    ("unnormalised", qs, ks, temps, False, wp)):
                run = lambda: ac.channel_attention_kernel(qq, kk, v, tt, heads, normalize_qk=norm,
                                                          w_proj=fold)
                plain = lambda: ac.channel_attention_plain(qq, kk, v, tt, heads, normalize_qk=norm,
                                                           w_proj=fold)
                got, ref = run(), plain()
                if dt == torch.float32:  # the CPU's twin: see k5_twin_cpu
                    ref_cpu = k5_twin_cpu(qq, kk, v, tt, heads, norm, fold)
                    log(f"K5 {arm} level {level} {dt}: kernel vs the card's twin "
                        f"{max_err(got, ref):.3e}, the card's twin vs the CPU's "
                        f"{max_err(ref, ref_cpu):.3e}")
                    ref = ref_cpu
                err, rel = judge(f"K5 level {level} {arm} {dt}", got, ref, dt)
                if not torch.equal(got, run()):
                    raise AssertionError(f"K5 level {level} {arm} {dt}: two calls differ in bits")
                caught = []
                for fault, bad in k5_planted_faults(kk, heads).items():
                    wrong = ac.channel_attention_kernel(qq, bad, v, tt, heads, normalize_qk=norm,
                                                        w_proj=fold)
                    f_err, f_rel = max_err(wrong, ref), rel_err(wrong, ref)
                    if (f_err if dt == torch.float32 else f_rel) <= (
                            TOL_FP32["K5"] if dt == torch.float32 else TOL_BF16_REL):
                        raise AssertionError(f"K5 level {level} {arm} {dt}: the check passes a "
                                             f"planted fault ({fault}: rel err {f_rel:.3e})")
                    caught.append(f"{fault} {f_rel:.3f}")
                log(f"K5 {arm} level {level} {dt}: planted faults rejected, rel err "
                    + ", ".join(caught))
                if arm in ("forward", "unnormalised"):  # the arms of the LCA and TNSM sites
                    record("K5", dt, site, err, rel, run, plain, qq, arm, heads=heads, fold=True)
                else:
                    log(f"K5 {arm} level {level} {dt}: max_abs_err {err:.3e} (rel {rel:.3e}), "
                        f"bitwise repeatable")
            del q, k, v, qs, ks, got, ref

            x = rnd((BATCH, c, h, w), -2.0, 3.0, dt)
            wgt, bias = rnd((c,), 0.5, 1.5, torch.float32), rnd((c,), -0.5, 0.5, torch.float32)
            run = lambda: nc.layer_norm_kernel(x, wgt, bias)
            plain = lambda: nc.layer_norm_plain(x, wgt, bias)
            err, rel = judge(f"K6 level {level} {dt}", run(), plain(), dt)
            record("K6", dt, site, err, rel, run, plain, x)
            del x

            hid = int(c * 2.66)
            y = rnd((BATCH, hid, h, w), -1.5, 1.5, dt)
            w1, w2 = (rnd((hid, 1, 3, 3), -1 / 3, 1 / 3, dt) for _ in range(2))
            run = lambda: ic.iel_branch_kernel(y, w1, w2)
            plain = lambda: ic.iel_branch_plain(y, w1, w2)
            err, rel = judge(f"K7 level {level} {dt}", run(), plain(), dt)
            record("K7", dt, site, err, rel, run, plain, y)
            del y


def batch1_info(dev) -> None:
    """K4 and K7 at the batch-1 level-1 shapes, K5 and K6 at the batch-1
    level-1 and level-3 shapes, K3 at block1 and block3, K1 at 1 x 400 x 600
    x 3 and K2 at 1 x 3 x 400 x 600, in bf16 (information, beside the
    batch-8 lines; K1/K3/K4/K7 bitwise equal to their twins here too, K5/K6
    within two ulps relative, K2 within one bf16 ulp)."""
    from hvi_cidnet_torch.ops import attention_cuda as ac
    from hvi_cidnet_torch.ops import hvi_cuda as hc
    from hvi_cidnet_torch.ops import iel_cuda as ic
    from hvi_cidnet_torch.ops import norm_cuda as nc
    from hvi_cidnet_torch.ops import resize_cuda as rc

    gen = torch.Generator(device="cpu").manual_seed(5)
    dt = torch.bfloat16
    alpha = torch.full((1,), 0.25, device=dev)
    down, _ = resize_sites()
    for site, c, h, w in down:
        if site not in ("HVE_block1", "HVE_block3"):
            continue
        x = (torch.rand((1, c, h, w), generator=gen) * 2 - 1).to(dev, dt)
        check_equal(f"K3 batch 1 {site}", rc.half_prelu_kernel(x, alpha), rc.half_prelu_plain(x, alpha))
        log(f"K3 batch-1 {site} {tuple(x.shape)} {dt}: kernel "
            f"{time_ms(lambda: rc.half_prelu_kernel(x, alpha)):.4f} ms  plain "
            f"{time_ms(lambda: rc.half_prelu_plain(x, alpha)):.4f} ms  "
            f"bound {bound_ms('K3', x)[0]:.4f} ms")
    k = torch.full((1,), K, device=dev)
    img = torch.rand((1, H, W, 3), generator=gen).to(dev)
    img_bf = img.to(dt)
    check_equal("K1 batch 1", hc.rgb_to_hvi_kernel(img_bf, k, dt),
                hc.rgb_to_hvi_plain(img_bf, k, dt))
    log(f"K1 batch-1 {tuple(img_bf.shape)} {dt}: bitwise equal  kernel "
        f"{time_ms(lambda: hc.rgb_to_hvi_kernel(img_bf, k, dt)):.4f} ms  plain "
        f"{time_ms(lambda: hc.rgb_to_hvi_plain(img_bf, k, dt)):.4f} ms  "
        f"bound {bound_ms('K1', img_bf)[0]:.4f} ms")
    hvi = hc.rgb_to_hvi_plain(img, k, torch.float32)
    hvi = (hvi + 0.05 * torch.randn(hvi.shape, generator=gen).to(dev)).to(dt).contiguous()
    edge = hue_edge(hvi, K)
    diff = (hc.hvi_to_rgb_kernel(hvi, k).float() - hc.hvi_to_rgb_plain(hvi, k).float()).abs()
    err = diff.amax(-1)[~edge].max().item()
    check("K2 batch 1", err, TOL_BF16)
    log(f"K2 batch-1 {tuple(hvi.shape)} {dt}: max_abs_err {err:.3e}  kernel "
        f"{time_ms(lambda: hc.hvi_to_rgb_kernel(hvi, k)):.4f} ms  plain "
        f"{time_ms(lambda: hc.hvi_to_rgb_plain(hvi, k)):.4f} ms  "
        f"bound {bound_ms('K2', hvi)[0]:.4f} ms")
    c1, hid = 36, int(36 * 2.66)
    x = (torch.rand((1, c1, H // 2, W // 2), generator=gen) * 2 - 1).to(dev, dt)
    check_equal("K4 batch 1 level 1", rc.double_bilinear_kernel(x), rc.double_bilinear_plain(x))
    lib = time_ms(lambda: torch.nn.functional.interpolate(
        x, scale_factor=2, mode="bilinear", align_corners=True))
    log(f"K4 batch-1 level 1 {tuple(x.shape)} {dt}: kernel "
        f"{time_ms(lambda: rc.double_bilinear_kernel(x)):.4f} ms  F.interpolate {lib:.4f} ms  "
        f"bound {bound_ms('K4', x)[0]:.4f} ms")
    y = (torch.rand((1, hid, H // 2, W // 2), generator=gen) * 3 - 1.5).to(dev, dt)
    w1, w2 = ((torch.rand((hid, 1, 3, 3), generator=gen) * 2 / 3 - 1 / 3).to(dev, dt)
              for _ in range(2))
    check_equal("K7 batch 1 level 1", ic.iel_branch_kernel(y, w1, w2), ic.iel_branch_plain(y, w1, w2))
    log(f"K7 batch-1 level 1 {tuple(y.shape)} {dt}: kernel "
        f"{time_ms(lambda: ic.iel_branch_kernel(y, w1, w2)):.4f} ms  plain "
        f"{time_ms(lambda: ic.iel_branch_plain(y, w1, w2)):.4f} ms  "
        f"bound {bound_ms('K7', y)[0]:.4f} ms")
    rnd = lambda shape, lo, hi, t: (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dev, t)
    for level, c, heads, h, w, _ in lca_sites():
        if level == 2:
            continue
        q, k, temp = k5_inputs(gen, (1, c, h, w), heads, dev, dt, True)
        v = rnd((1, c, h, w), -1.0, 1.0, dt)
        wp = rnd((c, c, 1, 1), -c**-0.5, c**-0.5, dt)
        run = lambda: ac.channel_attention_kernel(q, k, v, temp, heads, w_proj=wp)
        plain = lambda: ac.channel_attention_plain(q, k, v, temp, heads, w_proj=wp)
        rel = rel_err(run(), plain())
        if not rel <= TOL_BF16_REL:
            raise AssertionError(f"K5 batch 1 level {level}: rel err {rel:.3e} > {TOL_BF16_REL:.1e}")
        log(f"K5 batch-1 level {level} {tuple(q.shape)} {dt}: rel err {rel:.3e}  kernel "
            f"{time_ms(run):.4f} ms  plain {time_ms(plain):.4f} ms  "
            f"bound {bound_ms('K5', q, heads=heads)[0]:.4f} ms")
        x = rnd((1, c, h, w), -2.0, 3.0, dt)
        wgt, bias = rnd((c,), 0.5, 1.5, torch.float32), rnd((c,), -0.5, 0.5, torch.float32)
        run = lambda: nc.layer_norm_kernel(x, wgt, bias)
        plain = lambda: nc.layer_norm_plain(x, wgt, bias)
        rel = rel_err(run(), plain())
        if not rel <= TOL_BF16_REL:
            raise AssertionError(f"K6 batch 1 level {level}: rel err {rel:.3e} > {TOL_BF16_REL:.1e}")
        log(f"K6 batch-1 level {level} {tuple(x.shape)} {dt}: rel err {rel:.3e}  kernel "
            f"{time_ms(run):.4f} ms  plain {time_ms(plain):.4f} ms  "
            f"bound {bound_ms('K6', x)[0]:.4f} ms")


# (site, C_in, C_out, h, w, pad, uses per forward) of P4 and (site, C_in,
# C_out, h, w, uses) of P5 at 600 x 400: the replication-padded stems and
# heads, NormUpsample's folded 3x3 (HV and I), NormDownsample (HV and I)
def fused_conv_sites(ch=(36, 36, 72, 144)):
    c1, c2, c3, c4 = ch
    p4 = [("stem_hv", 3, c1, H, W, "edge", 1), ("stem_i", 1, c1, H, W, "edge", 1),
          ("head_hv", c1, 2, H, W, "edge", 1), ("head_i", c1, 1, H, W, "edge", 1),
          ("up3", c4, c3, H // 8, W // 8, "zero", 2), ("up2", c3, c2, H // 4, W // 4, "zero", 2),
          ("up1", c2, c1, H // 2, W // 2, "zero", 2)]
    p5 = [("down1", c1, c2, H, W, 2), ("down2", c2, c3, H // 2, W // 2, 2),
          ("down3", c3, c4, H // 4, W // 4, 2)]
    return p4, p5


def fused_bound_ms(key: str, x: torch.Tensor, cout: int = 0) -> tuple:
    """(least time in ms, "bytes" or "operations") of P2/P3, P4 or P5 on
    input ``x``: x read once, the output and the weights once, over 3.35
    TB/s, against the operations over the fp32 CUDA-core peak (the kernels'
    arithmetic; at these widths their operations bound them)."""
    it = x.element_size()
    b, c, h, w = x.shape
    px = b * h * w
    if key == "P2/P3":
        hid = int(c * 2.66)
        nbytes = 2 * x.numel() * it + (3 * hid * c + 36 * hid) * it + 8 * c
        # LN, the two 1x1 products, both depthwise convs of both halves,
        # tanh + add, the product, the residual
        ops = px * (8 * c + 2 * 3 * hid * c + 4 * 2 * hid * 9 + 4 * hid + hid + c)
    else:
        oh, ow = (h, w) if key == "P4" else (h // 2, w // 2)
        nbytes = (x.numel() + b * cout * oh * ow + 9 * c * cout) * it
        ops = 2 * px * cout * c * 9 + (24 * b * cout * oh * ow if key == "P5" else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["fp32"]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fused_excess(got: torch.Tensor, ref: torch.Tensor, dt) -> float:
    """max(|got - ref| - allowed): TOL_FUSED * max(1, |ref|), and for bf16 at
    least one bf16 ulp at max(|got|, |ref|). The check passes at <= 0."""
    got, ref = got.float(), ref.float()
    allowed = TOL_FUSED * ref.abs().clamp_min(1.0)
    if dt == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(got.abs(), ref.abs()))
        allowed = torch.maximum(allowed, torch.ldexp(torch.ones_like(got), e - 8))
    return ((got - ref).abs() - allowed).max().item()


def compare_fused(results: dict, dev) -> None:
    """P2/P3, P4 and P5 against their plain versions at every site shape of
    the 600 x 400 batch-8 forward, fp32 and bf16, each with its time, its
    plain version's, its bound and the unfused route's ops in its place."""
    from hvi_cidnet_torch.models.layers import IEL, LayerNorm
    from hvi_cidnet_torch.ops import conv3x3_cuda as cc
    from hvi_cidnet_torch.ops import ln_iel_cuda as lc
    from hvi_cidnet_torch.ops import resize_cuda as rc
    from hvi_cidnet_torch.ops.conv import conv3x3_same

    gen = torch.Generator(device="cpu").manual_seed(6)
    alpha = torch.full((1,), 0.25, device=dev)

    def rnd(shape, lo, hi, dt):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dev, dt)

    def judge(name, got, ref, dt):
        excess = fused_excess(got, ref, dt)
        err = max_err(got, ref)
        if not excess <= 0:
            raise AssertionError(f"{name}: max abs err {err:.3e}, over the bar by {excess:.3e}")
        return err

    def record(key, dt, site, err, kern, plain, x, per_forward, unfused=None, library=None,
               cout=0, info=""):
        t_k, t_p = time_ms(kern), time_ms(plain)
        t_u = time_ms(unfused) if unfused is not None else None
        t_l = time_ms(library) if library is not None else None
        bound = fused_bound_ms(key, x, cout)
        results[key].append({"dtype": str(dt), "err": err, "ms": t_k, "plain_ms": t_p,
                             "unfused_ms": t_u, "library_ms": t_l, "bound_ms": bound[0],
                             "bound_by": bound[1], "site": site, "per_forward": per_forward})
        log(f"{key} {site}{info} {tuple(x.shape)} {dt}: max_abs_err {err:.3e}  kernel "
            f"{t_k:.4f} ms  plain {t_p:.4f} ms  "
            + (f"unfused {t_u:.4f} ms  " if t_u is not None else "")
            + (f"F.conv2d {t_l:.4f} ms  " if t_l is not None else "")
            + f"bound {bound[0]:.4f} ms ({bound[1]})")

    p4_sites, p5_sites = fused_conv_sites()
    for dt in (torch.float32, torch.bfloat16):
        for level, c, _, h, w, lcas in lca_sites():
            iel, norm = IEL(c), LayerNorm(c)
            with torch.no_grad():
                for prm in iel.parameters():
                    bound = prm[0].numel() ** -0.5
                    prm.copy_(torch.rand(prm.shape, generator=gen) * 2 * bound - bound)
                norm.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                norm.bias.copy_(torch.rand(c, generator=gen) * 0.6 - 0.3)
            iel, norm = iel.to(dev, dt), norm.to(dev)
            wts = (norm.weight, norm.bias, iel.project_in.weight, iel.dwconv.weight,
                   iel.dwconv1.weight, iel.dwconv2.weight, iel.project_out.weight)
            x = rnd((BATCH, c, h, w), -2.0, 2.5, dt)
            with torch.no_grad():
                for residual in (True, False):
                    run = lambda: lc.ln_iel_kernel(x, *wts, residual)
                    plain = lambda: lc.ln_iel_plain(x, *wts, residual)
                    err = judge(f"P2/P3 level {level} residual {residual} {dt}", run(), plain(),
                                dt)
                    if residual:  # I_LCA's arm; HV_LCA's runs the same work
                        record("P2/P3", dt, {"level": level}, err, run, plain, x, lcas,
                               unfused=lambda: x + iel(norm(x)))
                    else:
                        log(f"P2/P3 level {level} no residual {tuple(x.shape)} {dt}: max_abs_err "
                            f"{err:.3e}")
            del x
        for site, cin, cout, h, w, pad, uses in p4_sites:
            x = rnd((BATCH, cin, h, w), -1.0, 1.0, dt)
            wt = rnd((cout, cin, 3, 3), -cin**-0.5, cin**-0.5, dt)
            run = lambda: cc.conv3x3_kernel(x, wt, pad)
            plain = lambda: cc.conv3x3_plain(x, wt, pad)
            err = judge(f"P4 {site} {dt}", run(), plain(), dt)
            # the library yardstick: cuDNN's zero-padded conv, the same work
            # (the replication pad of the edge sites would be a second call)
            record("P4", dt, site, err, run, plain, x, {v: uses for v in VARIANTS},
                   library=lambda: torch.nn.functional.conv2d(x, wt, padding=1), cout=cout,
                   info=f" ({pad} pad)")
            del x
        for site, cin, cout, h, w, uses in p5_sites:
            x = rnd((BATCH, cin, h, w), -1.0, 1.0, dt)
            wt = rnd((cout, cin, 3, 3), -cin**-0.5, cin**-0.5, dt)
            run = lambda: cc.conv3x3_half_prelu_kernel(x, wt, alpha)
            plain = lambda: cc.conv3x3_half_prelu_plain(x, wt, alpha)
            err = judge(f"P5 {site} {dt}", run(), plain(), dt)
            record("P5", dt, site, err, run, plain, x, {v: uses for v in VARIANTS},
                   unfused=lambda: rc.half_prelu(conv3x3_same(x, wt), alpha), cout=cout)
            del x


def probe_bound_ms(key: str, x: torch.Tensor, c: int = 0, cout: int = 0) -> tuple:
    """(least time in ms, "bytes" or "operations") of P1 or P10/P15 on
    (G, c, N) q, or of P6 on a (B, K, N) operand: each input read once and
    each output written once over 3.35 TB/s, against the operations over the
    peak of the inputs' type (bf16: the tensor cores; fp32: the CUDA
    cores)."""
    it = x.element_size()
    peak = PEAK_FLOPS["bf16_tensor" if x.dtype == torch.bfloat16 else "fp32"]
    if key == "P6":
        b, k, n = x.shape
        nbytes = (x.numel() + cout * k + b * cout * n) * it
        ops = 2 * b * cout * k * n
    else:
        g, _, n = x.shape
        if key == "P1":  # q, k, v read, out written; scores, norms, apply
            nbytes = 4 * x.numel() * it
            ops = 4 * g * c * c * n + 4 * g * c * n
        else:  # q, k read, the fp32 scores written
            nbytes = 2 * x.numel() * it + 4 * g * c * c
            ops = 2 * g * c * c * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def p1_excess(got, ref, q, k, v, temps) -> float:
    """max(|got - ref| - allowed) of P1 (module note at TOL_PROBE); passes
    at <= 0."""
    from hvi_cidnet_torch.ops import head_attention_cuda as ha

    got, ref = got.float(), ref.float()
    if q.dtype == torch.float32:
        allowed = TOL_PROBE * ref.abs().clamp_min(1.0)
    else:
        a = ha.attention_matrix(q, k, temps).to(v.dtype).float()
        scale = torch.bmm(a, v.float().abs())
        _, e = torch.frexp(torch.maximum(torch.maximum(got.abs(), ref.abs()), scale))
        allowed = torch.ldexp(torch.full_like(got, 2.0), e - 8)
    return ((got - ref).abs() - allowed).max().item()


def qk_excess(got, ref, q, k) -> float:
    """max(|got - ref| - TOL_PROBE |q_r| |k_c|) of P10/P15's scores."""
    nq, nk = (t.float().square().sum(-1).sqrt() for t in (q, k))
    return ((got - ref).abs() - TOL_PROBE * nq[:, :, None] * nk[:, None, :]).max().item()


def compare_probe(results: dict, dev) -> None:
    """P1, P10/P15 and P6 against their plain versions at every site shape
    of the 600 x 400 batch-8 forward and at batch 1 (levels 1 and 3; the
    level-3 N = 3750 leaves a tail of each kernel's tile), fp32 and bf16,
    each with its time, its plain version's, its bound and its comparators
    (K5 at the attention sites; ``torch.matmul`` on the staged operand and
    cuDNN's conv at the convs)."""
    from hvi_cidnet_torch.models.layers import heads_view
    from hvi_cidnet_torch.ops import attention_cuda as ac
    from hvi_cidnet_torch.ops import batched_qk_cuda as bq
    from hvi_cidnet_torch.ops import conv3x3_cuda as cc
    from hvi_cidnet_torch.ops import head_attention_cuda as ha
    from hvi_cidnet_torch.ops import im2col_cuda as icol

    gen = torch.Generator(device="cpu").manual_seed(9)
    bmm_fp32_out = "dtype" in torch.ops.aten.bmm.overloads()  # bmm(..., out_dtype=)

    def rnd(shape, lo, hi, dt):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dev, dt)

    def record(key, dt, site, err, kern, plain, x, per_forward, bound, comparators=None,
               library=None, info=""):
        row = {"dtype": str(dt), "err": err, "ms": time_ms(kern), "plain_ms": time_ms(plain),
               "library_ms": time_ms(library) if library is not None else None,
               "bound_ms": bound[0], "bound_by": bound[1], "site": site,
               "per_forward": per_forward}
        for name, fn in (comparators or {}).items():
            row[f"{name}_ms"] = time_ms(fn)
        results[key].append(row)
        extra = "".join(f"  {name} {row[f'{name}_ms']:.4f} ms" for name in (comparators or {}))
        log(f"{key} {site}{info} {tuple(x.shape)} {dt}: max_abs_err {err:.3e}  kernel "
            f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms"
            + (f"  library {row['library_ms']:.4f} ms" if library is not None else "")
            + f"{extra}  bound {bound[0]:.4f} ms ({bound[1]})")

    for dt in (torch.float32, torch.bfloat16):
        for level, c, heads, h, w, lcas in lca_sites():
            tnsm_blocks = {v: TNSM_BLOCKS[level] if v == "tnsm" else 0 for v in VARIANTS}
            for b in (BATCH, 1) if level != 2 else (BATCH,):
                shape, cp = (b, c, h, w), c // heads
                site = {"level": level, "batch": b}
                per_lca = dict(lcas) if b == BATCH else {v: 0 for v in VARIANTS}
                per_tnsm = tnsm_blocks if b == BATCH else {v: 0 for v in VARIANTS}
                v_ = rnd(shape, -1.0, 1.0, dt)
                wp = rnd((c, c, 1, 1), -c**-0.5, c**-0.5, dt)
                vh = heads_view(v_, heads)
                # P1: the CAB's attention per head, q and k of shared structure
                q, k, temp = k5_inputs(gen, shape, heads, dev, dt, True)
                qh, kh, temps = heads_view(q, heads), heads_view(k, heads), temp.reshape(heads)
                run = lambda: ha.head_attention_kernel(qh, kh, vh, temps)
                plain = lambda: ha.head_attention_plain(qh, kh, vh, temps)
                got = run()
                ref = (ha.head_attention_plain(*(t.cpu() for t in (qh, kh, vh, temps))).to(dev)
                       if dt == torch.float32 else plain())
                if dt == torch.float32:
                    log(f"P1 level {level} batch {b} fp32: kernel vs the card's plain version "
                        f"{max_err(got, plain()):.3e}, vs the CPU's {max_err(got, ref):.3e}")
                excess = p1_excess(got, ref, qh, kh, vh, temps)
                if not excess <= 0:
                    raise AssertionError(f"P1 level {level} batch {b} {dt}: max abs err "
                                         f"{max_err(got, ref):.3e}, over the bar by {excess:.3e}")
                if dt == torch.bfloat16:  # the same error in ulps at |out| itself (information)
                    _, e = torch.frexp(torch.maximum(got.float().abs(), ref.float().abs()))
                    ulps = ((got.float() - ref.float()).abs() / torch.ldexp(
                        torch.ones_like(e, dtype=torch.float32), e - 8)).max().item()
                    log(f"P1 level {level} batch {b} bf16: max err {ulps:.2f} ulps of "
                        f"max(|got|, |ref|)")
                if not torch.equal(got, run()):
                    raise AssertionError(f"P1 level {level} batch {b} {dt}: two calls differ")
                flipped = heads_view(k.reshape(b, heads, cp, h, w).flip(2).reshape(shape), heads)
                if p1_excess(ha.head_attention_kernel(qh, flipped, vh, temps), ref, qh, kh, vh,
                             temps) <= 0:
                    raise AssertionError(f"P1 level {level} {dt}: the bar passes a planted fault")
                record("P1", dt, site, max_err(got, ref), run, plain, qh, per_lca,
                       probe_bound_ms("P1", qh, cp), comparators={
                           "k5": lambda: ac.channel_attention_kernel(q, k, v_, temp, heads,
                                                                     w_proj=wp)})
                del q, k, qh, kh, flipped, got, ref
                # P10/P15: TNSM's unnormalised scores
                q, k, temp = k5_inputs(gen, shape, heads, dev, dt, False)
                qh, kh = heads_view(q, heads), heads_view(k, heads)
                run = lambda: bq.batched_qk_kernel(qh, kh)
                plain = lambda: bq.batched_qk_plain(qh, kh)
                got = run()
                ref = bq.batched_qk_plain(qh.cpu(), kh.cpu()).to(dev)
                excess = qk_excess(got, ref, qh, kh)
                log(f"P10/P15 level {level} batch {b} {dt}: kernel vs the card's plain version "
                    f"{max_err(got, plain()):.3e}, vs the CPU's {max_err(got, ref):.3e}, "
                    f"|score| up to {ref.abs().max().item():.1f}")
                if not excess <= 0:
                    raise AssertionError(f"P10/P15 level {level} batch {b} {dt}: max abs err "
                                         f"{max_err(got, ref):.3e}, over the bar by {excess:.3e}")
                if not torch.equal(got, run()):
                    raise AssertionError(f"P10/P15 level {level} batch {b} {dt}: two calls differ")
                flipped = heads_view(k.reshape(b, heads, cp, h, w).flip(2).reshape(shape), heads)
                if qk_excess(bq.batched_qk_kernel(qh, flipped), ref, qh, kh) <= 0:
                    raise AssertionError(f"P10/P15 level {level} {dt}: the bar passes a planted "
                                         f"fault")
                library = (lambda: torch.bmm(qh, kh.mT)) if dt == torch.float32 else (
                    (lambda: torch.bmm(qh, kh.mT, out_dtype=torch.float32)) if bmm_fp32_out
                    else None)
                record("P10/P15", dt, site, max_err(got, ref), run, plain, qh, per_tnsm,
                       probe_bound_ms("P10/P15", qh, cp), library=library, comparators={
                           "k5": lambda: ac.channel_attention_kernel(
                               q, k, v_, temp, heads, normalize_qk=False, w_proj=wp)})
                del q, k, qh, kh, flipped, got, ref, v_, vh
        p4_sites, p5_sites = fused_conv_sites()
        conv_sites = [(s, ci, co, hh, ww, pad, {v: uses for v in VARIANTS})
                      for s, ci, co, hh, ww, pad, uses in p4_sites] + \
                     [(s, ci, co, hh, ww, "zero", {v: uses for v in VARIANTS})
                      for s, ci, co, hh, ww, uses in p5_sites] + \
                     [("up3 batch 1", p4_sites[4][1], p4_sites[4][2], H // 8, W // 8, "zero",
                       {v: 0 for v in VARIANTS})]
        for site, cin, cout, h, w, pad, per_forward in conv_sites:
            b = 1 if "batch 1" in site else BATCH
            x = rnd((b, cin, h, w), -1.0, 1.0, dt)
            wt = rnd((cout, cin, 3, 3), -cin**-0.5, cin**-0.5, dt)
            a = icol.stage_3x3(x, pad)
            wmat = wt.reshape(cout, cin * 9)
            run = lambda: icol.im2col_dots_kernel(a, wmat)
            plain = lambda: icol.im2col_dots_plain(a, wmat)
            got = run()
            excess = fused_excess(got, plain(), dt)
            if not excess <= 0:
                raise AssertionError(f"P6 {site} {dt}: max abs err {max_err(got, plain()):.3e}, "
                                     f"over the bar by {excess:.3e}")
            # the whole conv: the route's (F.unfold and P6), the default
            # route's (cuDNN, after the replication pad at the stems and heads)
            record("P6", dt, site, max_err(got, plain()), run, plain, a, per_forward,
                   probe_bound_ms("P6", a, cout=cout), library=lambda: torch.matmul(wmat, a),
                   comparators={"route": lambda: icol.conv3x3_im2col(x, wt, pad),
                                "cudnn": lambda: cc.conv3x3_plain(x, wt, pad)},
                   info=f" ({pad} pad)")
            del x, a, got
            torch.cuda.empty_cache()


def relayout_cases() -> list:
    """(row, function, site, input shape, kwargs, launches per HWCB forward,
    the row's line in the JSON) of step 4d: P7 (steps 1-3), P8, P9, P11,
    P12, P13 and P14 at the three LCA levels of the 600 x 400 forward
    ((N, C, B), blocks of at most 1000 rows of N), batch 8 and 1; the HWCB
    entry (P14, one block) and exit (P11 on K2's NHWC output) at batch 1,
    8 and 32. The JSON line of P8/P9/P11 and P14 is their call on the HWCB
    path at batch 8; of P7 and P12/P13, which no path runs, level 1 at
    batch 8 (P7 at steps 3, P12)."""
    cases = []
    for level, c, _, h, w, _ in lca_sites():
        n = h * w
        n_blk = max(d for d in range(1, 1001) if n % d == 0)
        for b in (BATCH, 1):
            site = f"level {level} ({n}, {c}, {b})"
            line = level == 1 and b == BATCH
            blocked = {"n_blk": n_blk}
            cases += [("P7", "transpose_steps", f"{site} steps {st}", (n, c, b),
                       {"hwt": n_blk, "steps": st}, 0, line and st == 3) for st in (1, 2, 3)]
            cases += [("P8/P9/P11", "relayout_t3", f"P8 {site}", (n, c, b), blocked, 0, False),
                      ("P8/P9/P11", "relayout_t2", f"P9 {site}", (n, c, b), blocked, 0, False),
                      ("P8/P9/P11", "relayout_t2_rev", f"P11 {site}", (b, c, n), blocked, 0,
                       False),
                      ("P12/P13", "t3_blocked", f"P12 {site}", (n, c, b), blocked, 0, line),
                      ("P12/P13", "t2_blocked", f"P13 {site}", (n, c, b), blocked, 0, False),
                      ("P14", "pack_blocked", f"P14 {site}", (n, c, b), blocked, 0, False)]
    hw = H * W
    for b in (1, BATCH, 32):
        cases += [("P14", "pack_blocked", f"HWCB entry batch {b}", (hw, 3, b), {"n_blk": hw},
                   int(b == BATCH), b == BATCH),
                  ("P8/P9/P11", "relayout_t2_rev", f"HWCB exit batch {b}", (b, 1, 3 * hw), {},
                   int(b == BATCH), b == BATCH)]
    return cases


def compare_relayout(results: dict, dev) -> None:
    """Step 4d: each relayout through its kernel, bitwise equal
    (``torch.equal``) to its plain version, fp32 and bf16, at every case of
    ``relayout_cases``, with the device time a call of the kernel, of its
    plain version and of the one library call (``permute(...)
    .contiguous()``), each from a CUDA graph of 20 calls (at these sizes
    the wrapper's host work would otherwise be timed), the kernel's time
    through its wrapper (CUDA events) and the bound: each element read once
    and written once over 3.35 TB/s. The library call permutes the input
    viewed as (G, X, M, Y) (``ops/relayout_cuda.py:geometry``), the same
    copy as each plain version's permute."""
    from hvi_cidnet_torch.cli.kernel_times import graph_ms
    from hvi_cidnet_torch.ops import relayout as plain
    from hvi_cidnet_torch.ops import relayout_cuda as rl

    gen = torch.Generator(device="cpu").manual_seed(10)
    names = {"transpose_steps": "P7", "relayout_t3": "P8", "relayout_t2": "P9",
             "relayout_t2_rev": "P11", "t3_blocked": "P12", "t2_blocked": "P13",
             "pack_blocked": "P14"}
    for dt in (torch.float32, torch.bfloat16):
        for key, fn, site, shape, kw, per_forward, line in relayout_cases():
            x = (torch.rand(shape, generator=gen) * 4 - 2).to(dev, dt)
            geo = {k: v for k, v in kw.items() if k != "hwt"}
            gxmy, out_shape = rl.geometry(names[fn], shape, **geo)
            run = lambda: rl.relayout_kernel(x, rl.KERNELS[key], gxmy, out_shape)
            plain_fn = lambda: getattr(plain, fn)(x, **kw)
            # the same copy as one permute of the (G, X, M, Y) view
            library = lambda: x.view(gxmy).permute(0, 3, 2, 1).contiguous()
            err = check_equal(f"{key} {site} {dt}", run(), plain_fn())
            check_equal(f"{key} {site} {dt} (through the dispatcher)", getattr(rl, fn)(x, **kw),
                        library().view(out_shape))
            t_k, t_p, t_l = graph_ms(run), graph_ms(plain_fn), graph_ms(library)
            t_w = time_ms(run)
            nbytes = 2 * x.numel() * x.element_size()
            bound = 1e3 * nbytes / HBM_BYTES_PER_S
            p = rl.relayout_plan(*gxmy, x.element_size())
            results[key].append({"dtype": str(dt), "err": err, "ms": t_k, "wrapper_ms": t_w,
                                 "plain_ms": t_p, "library_ms": t_l, "bound_ms": bound,
                                 "bound_by": "bytes", "site": site, "per_forward": per_forward,
                                 "line": line})
            log(f"{key} {site} {tuple(shape)} {dt}: bitwise equal  kernel {t_k:.4f} ms "
                f"(wrapper {t_w:.4f})  plain {t_p:.4f} ms  permute().contiguous() {t_l:.4f} ms  "
                f"bound {bound:.4f} ms (bytes, {nbytes / 1e6:.1f} MB) = {bound / t_k:.0%}  plan "
                f"{'copy' if p.copy else f'tile {p.tx}x{p.ty} pitch {p.pitch}'} v {p.vi}/{p.vo} "
                f"lanes {p.lx}/{p.sx} blocks {p.blocks}")
            del x
        torch.cuda.empty_cache()


def rgb_of(variant: str, out):
    """The RGB of a forward: TNSM returns (rgb, noise or None)."""
    return out[0] if variant == "tnsm" else out


def capture_tnsm_attention(fn) -> list:
    """Runs ``fn`` and returns the inputs of every noise-aware attention call
    it makes (TNSM's K5 sites): (q, k, v, temperature, heads, w_proj)."""
    from hvi_cidnet_torch.models import tnsm

    calls, original = [], tnsm.channel_attention

    def record(q, k, v, temperature, heads, **kw):
        calls.append((q, k, v, temperature.detach(), heads, kw["w_proj"].detach()))
        return original(q, k, v, temperature, heads, **kw)

    tnsm.channel_attention = record
    try:
        fn()
    finally:
        tnsm.channel_attention = original
    return calls


def compare_forward(dev, variant: str, kernels: dict, name: str = "default"):
    """Card fp32 vs CPU fp32 with the same weights; bf16 card vs fp32 card;
    both on the route ``name`` (a key of ROUTES). TNSM also: the training
    forward's noise map and launches, and, on the default route, K5 on the
    attention inputs captured from the card's forwards. Returns the bf16
    model."""
    from hvi_cidnet_torch.models.cidnet import (
        CIDNet, CIDNetConfig, cast_conv_weights, cidnet_forward, cidnet_hvi,
    )

    tnsm = variant == "tnsm"
    routes, _, training_launches = ROUTES[name]
    route = f"{name} route"
    forward = lambda *a, **kw: cidnet_forward(*a, routes=routes, **kw)
    tol_max, tol_mean, tol_bf16 = ((TOL_TNSM["max"], TOL_TNSM["mean"], TOL_TNSM["bf16_mean"])
                                   if tnsm else
                                   (TOL_FORWARD_MAX, TOL_FORWARD_MEAN, TOL_BF16_FORWARD_MEAN))
    cfg = CIDNetConfig(variant=variant)
    cpu_model = CIDNet(cfg, generator=torch.Generator().manual_seed(0)).eval()
    gpu_model = CIDNet(cfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, H, W, 3)).astype(np.float32))
    fp32_sites, ref_noise = [], None
    with torch.no_grad():
        t0 = time.perf_counter()
        # TNSM: training=True adds the noise map and leaves the rgb as it is
        # (bitwise on the CPU: tests/test_torch_tnsm.py)
        ref = forward(cpu_model, x, training=tnsm)
        if tnsm:
            ref, ref_noise = ref
        ref_hvi = cidnet_hvi(cpu_model, x, routes=routes)
        cpu_s = time.perf_counter() - t0
        run = lambda: rgb_of(variant, forward(gpu_model, x.to(dev))).cpu()
        if tnsm and routes is None:
            out = []
            fp32_sites = capture_tnsm_attention(lambda: out.append(run()))
            got = out[0]
        else:
            got = run()
        got_hvi = cidnet_hvi(gpu_model, x.to(dev), routes=routes).cpu()
    for t in (got, ref):
        if t.shape != (1, H, W, 3) or not torch.isfinite(t).all():
            raise AssertionError(f"{variant} forward output bad: {tuple(t.shape)}")
    hvi_err = max_err(got_hvi, ref_hvi)
    edge = hue_edge(ref_hvi, K)
    diff = (got - ref).abs().amax(-1)
    err = diff[~edge].max().item()
    mean = (got - ref).abs().mean().item()
    log(f"{variant} {route} forward fp32 (1, {H}, {W}, 3): card vs CPU max_abs_err {err:.3e} (hue-edge "
        f"pixels {int(edge.sum())} excluded), mean_abs_err {mean:.3e}, output-HVI max_abs_err "
        f"{hvi_err:.3e}  [CPU fp32 forward x2: {cpu_s:.1f} s]")
    check(f"{variant} {route} forward fp32 card vs CPU", err, tol_max)
    check(f"{variant} {route} forward fp32 card vs CPU (mean)", mean, tol_mean)
    check(f"{variant} {route} forward output HVI card vs CPU", hvi_err, tol_max)
    if tnsm:
        compare_tnsm_training(dev, kernels, gpu_model, x, got, ref_noise, routes,
                              training_launches, route)
    if routes is None:
        compare_hwcb(dev, variant, kernels, gpu_model, x, got, ref, ref_noise, edge,
                     (tol_max, tol_mean))

    bf_model = cast_conv_weights(
        CIDNet(cfg, generator=torch.Generator().manual_seed(0)).to(dev), torch.bfloat16
    ).eval()
    out = []
    with torch.no_grad():
        bf_run = lambda: out.append(rgb_of(variant, forward(
            bf_model, x.to(dev, torch.bfloat16), compute_dtype=torch.bfloat16)))
        bf16_sites = capture_tnsm_attention(bf_run) if tnsm and routes is None else bf_run()
    bf = out[0]
    if not torch.isfinite(bf.float()).all():
        raise AssertionError(f"{variant} bf16 forward is not finite")
    bf_mean = (bf.float().cpu() - got).abs().mean().item()
    bf_max = (bf.float().cpu() - got).abs().max().item()
    log(f"{variant} {route} forward bf16 vs fp32 on the card: mean_abs_err {bf_mean:.3e}, "
        f"max_abs_err {bf_max:.3e}")
    check(f"{variant} {route} forward bf16 vs fp32 (mean)", bf_mean, tol_bf16)
    if tnsm and routes is None:
        compare_k5_captured(fp32_sites, bf16_sites)
    return bf_model


def compare_tnsm_training(dev, kernels, gpu_model, x, got, ref_noise, routes, want,
                          route) -> None:
    """The TNSM forward with training=True on the card on ``routes``: its
    launches (I_TNSM5 runs, for its noise map) against ``want``, its rgb
    against the serving forward's ``got``, and its fused noise map against
    the CPU's ``ref_noise``."""
    from hvi_cidnet_torch.models.cidnet import cidnet_forward

    with torch.no_grad():
        torch.cuda.synchronize()
        reset(kernels)
        rgb, noise = cidnet_forward(gpu_model, x.to(dev), training=True, routes=routes)
        torch.cuda.synchronize()
        launched = counts(kernels)
    log(f"tnsm training=True launches per forward ({route}): {launched}")
    if launched != want:
        raise AssertionError(f"tnsm training launches {launched} != {want}")
    noise = noise.cpu()
    if noise.shape != (1, H, W, 3) or not torch.isfinite(noise).all():
        raise AssertionError(f"tnsm fused noise map bad: {tuple(noise.shape)}")
    check("tnsm training=True rgb vs serving rgb on the card", max_err(rgb.cpu(), got),
          TOL_TNSM["max"])
    err, mean = max_err(noise, ref_noise), (noise - ref_noise).abs().mean().item()
    log(f"tnsm fused noise map (1, {H}, {W}, 3) fp32: card vs CPU max_abs_err {err:.3e}, "
        f"mean_abs_err {mean:.3e}, range [{noise.min().item():.4f}, {noise.max().item():.4f}]")
    check("tnsm fused noise map card vs CPU", err, TOL_TNSM["noise_max"])


def compare_hwcb(dev, variant, kernels, gpu_model, x, got, ref, ref_noise, edge, tols) -> None:
    """Step 5d: the HWCB serving contract on the card in fp32. At 1 x 400 x
    600 (the relayouts copy) against the CPU's NHWC forward at the
    variant's bars and bitwise the card's NHWC forward ``got`` permuted;
    at batch 2 (they transpose) bitwise the card's NHWC forward permuted.
    TNSM also with training=True: its launches (TNSM_TRAINING_HWCB) and
    the fused noise map, (H, W, 3, B), against the CPU's and bitwise the
    NHWC one permuted."""
    from hvi_cidnet_torch.models.cidnet import cidnet_forward

    tnsm = variant == "tnsm"
    to_hwcb = lambda t: t.permute(1, 2, 3, 0).contiguous()
    hwcb = lambda t, **kw: cidnet_forward(gpu_model, to_hwcb(t).to(dev), input_layout="hwcb",
                                          **kw)
    with torch.no_grad():
        got_h = rgb_of(variant, hwcb(x)).cpu()
        if got_h.shape != (H, W, 3, 1) or not torch.isfinite(got_h).all():
            raise AssertionError(f"{variant} HWCB forward output bad: {tuple(got_h.shape)}")
        diff = (got_h - to_hwcb(ref)).abs().amax(2)[..., 0]
        err, mean = diff[~edge[0]].max().item(), (got_h - to_hwcb(ref)).abs().mean().item()
        check(f"{variant} HWCB forward fp32 card vs CPU", err, tols[0])
        check(f"{variant} HWCB forward fp32 card vs CPU (mean)", mean, tols[1])
        check_equal(f"{variant} HWCB forward vs the card's NHWC forward", got_h, to_hwcb(got))
        x2 = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (2, H, W, 3)).astype(
            np.float32))
        nhwc2 = cidnet_forward(gpu_model, x2.to(dev), training=tnsm)
        torch.cuda.synchronize()
        reset(kernels)
        hwcb2 = hwcb(x2, training=tnsm)
        torch.cuda.synchronize()
        launched = counts(kernels)
        want = TNSM_TRAINING_HWCB if tnsm else PER_FORWARD_HWCB[variant]
        if launched != want:
            raise AssertionError(f"{variant} HWCB forward (training={tnsm}) launches {launched} "
                                 f"!= {want}")
        rgb_of_2 = lambda out: out[0] if tnsm else out
        check_equal(f"{variant} HWCB forward batch 2 vs the card's NHWC forward",
                    rgb_of_2(hwcb2), to_hwcb(rgb_of_2(nhwc2)))
        line = (f"{variant} HWCB forward fp32 ({H}, {W}, 3, 1): card vs CPU max_abs_err "
                f"{err:.3e} (hue-edge pixels excluded), mean_abs_err {mean:.3e}; bitwise the "
                f"card's NHWC forward permuted at batch 1 and 2; launches (training={tnsm}) "
                f"{launched}")
        if tnsm:
            noise_h = hwcb(x, training=True)[1].cpu()
            noise_err = max_err(noise_h, to_hwcb(ref_noise))
            check("tnsm HWCB fused noise map card vs CPU", noise_err, TOL_TNSM["noise_max"])
            check_equal("tnsm HWCB fused noise map batch 2 vs NHWC", hwcb2[1], to_hwcb(nhwc2[1]))
            line += f"; fused noise map {tuple(noise_h.shape)} vs CPU max_abs_err {noise_err:.3e}"
    log(line)


def attention_f64(q, k, v, temperature, heads, w_proj):
    """K5's unnormalised, folded arm in float64 on the CPU (the twin's
    algebra, ``ops/attention.py``), and the masked scores it softmaxes."""
    b, c, h, w = q.shape
    cp = c // heads
    q64, k64, v64 = (t.cpu().reshape(b, c, h * w).double() for t in (q, k, v))
    scores = torch.bmm(q64, k64.transpose(1, 2))
    scores = scores * temperature.cpu().reshape(heads).double().repeat_interleave(cp)[None, :, None]
    head = torch.arange(c) // cp
    scores = scores.masked_fill(head[:, None] != head[None, :], float("-inf"))
    attn = torch.matmul(w_proj.cpu().reshape(c, c).double(), torch.softmax(scores, dim=-1))
    return torch.bmm(attn, v64).reshape(b, c, h, w), scores


def compare_k5_captured(fp32_sites: list, bf16_sites: list) -> None:
    """K5's unnormalised arm at each TNSM site shape on the q, k, v and
    temperature the full-width forward gave it: fp32 against its twin run on
    the CPU in fp32 (TOL_FP32["K5"]), with the twin's and the kernel's gap
    to float64 beside it; bf16 against the twin on the same bf16 inputs, on
    the CPU (two bf16 ulps relative, as every bf16 K5 check)."""
    from hvi_cidnet_torch.ops import attention_cuda as ac

    for dt, sites in ((torch.float32, fp32_sites), (torch.bfloat16, bf16_sites)):
        seen = set()
        for q, k, v, temp, heads, wp in sites:
            if q.shape in seen:
                continue
            seen.add(q.shape)
            got = ac.channel_attention_kernel(q, k, v, temp, heads, normalize_qk=False, w_proj=wp)
            ref = k5_twin_cpu(q, k, v, temp, heads, False, wp)
            exact, scores = attention_f64(q, k, v, temp, heads, wp)
            top2 = scores.topk(2, dim=-1).values
            gap = (top2[..., 0] - top2[..., 1]).min().item()
            err, rel = max_err(got, ref), rel_err(got, ref)
            log(f"K5 unnormalised, captured from the tnsm forward {tuple(q.shape)} heads {heads} "
                f"{dt}: |score| up to {scores[torch.isfinite(scores)].abs().max().item():.1f}, "
                f"smallest top-2 gap {gap:.3e}; kernel vs CPU twin max_abs_err {err:.3e} (rel "
                f"{rel:.3e}); vs float64: kernel {max_err(got.cpu().double(), exact):.3e}, CPU "
                f"twin {max_err(ref.cpu().double(), exact):.3e}")
            if dt == torch.float32:
                check(f"K5 captured {tuple(q.shape)} fp32", err, TOL_FP32["K5"])
            elif not rel <= TOL_BF16_REL:
                raise AssertionError(f"K5 captured {tuple(q.shape)} bf16: rel err {rel:.3e} > "
                                     f"{TOL_BF16_REL:.1e}")
        if len(seen) != 3:
            raise AssertionError(f"K5 captured {dt}: {len(seen)} site shapes, expected 3")


def counts(kernels) -> dict:
    return {k: v.launches for k, v in kernels.items()}


def reset(kernels) -> None:
    for v in kernels.values():
        v.launches = 0


def summarise(key: str, rows: list, launches: dict) -> dict:
    """One kernel's line: errors over both dtypes; times and bounds summed
    over the kernel's sites in one forward, 600 x 400, batch 8, bf16: base
    in ``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` (for P2/P3 and
    P5, which no one PyTorch call computes, the unfused route's ops in their
    place in ``unfused_ms``), each path in ``*_by_path``; P10/P15, which
    only TNSM runs, per TNSM forward. The probe route's comparators too: K5
    at the same sites (``k5_ms``), the route's whole conv and cuDNN's
    (``route_ms``, ``cudnn_ms``). ``launches``: the serving run of the
    kernel's path (the fused route's for P2/P3, P4, P5, the probe route's
    for P1, P6, P10/P15)."""
    bf = [r for r in rows if r["dtype"] == "torch.bfloat16"]
    if key == "K2":
        bf = bf[:1]  # the no-gates arm, as the forward runs by default
    main_path = "tnsm" if key == "P10/P15" else "base"

    def per_forward(field, path=main_path):
        if bf[0].get(field) is None:
            return None
        # K1-K4: each row is one launch of every path's forward
        return sum(r[field] * r.get("per_forward", {}).get(path, 1) for r in bf)

    sources = {"K1": ("rgb_to_hvi", "hvi.cu", "hvi_pallas.py:57"),
               "K2": ("hvi_to_rgb", "hvi.cu", "hvi_pallas.py:102"),
               "K3": ("half_prelu", "resize.cu", "resize_pallas.py:76"),
               "K4": ("double_bilinear", "resize.cu", "resize_pallas.py:143"),
               "K5": ("channel_attention", "attention.cu", "attention.py:181"),
               "K6": ("layer_norm", "norm.cu", "norm_pallas.py:53"),
               "K7": ("iel_branch", "iel.cu", "iel_pallas.py:72"),
               "P2/P3": ("ln_iel", "ln_iel.cu",
                         "experiments/iel_pallas_nhcw.py:104 and experiments/iel_fused_pallas.py:75"),
               "P4": ("conv3x3", "conv3x3.cu", "experiments/conv_pallas_nhcw.py:64"),
               "P5": ("conv3x3_half_prelu", "conv3x3.cu", "experiments/fused_pallas_nhcw.py:67"),
               "P1": ("head_attention", "head_attention.cu",
                      "experiments/attn_kernel_probe_r2.py:32"),
               "P6": ("im2col_dots", "im2col_gemm.cu", "experiments/flat_pilot_r3.py:62"),
               "P10/P15": ("batched_qk", "batched_qk.cu", "experiments/relayout_probe_r5h.py:98 "
                           "and experiments/mosaic_micro_r5h.py:106")}
    name, src, tpu = sources[key]
    worst = max(bf, key=lambda r: r["bound_ms"])
    line = {
        "name": name,
        "route": "cuda",
        "source": f"hvi_cidnet_torch/csrc/{src}",
        "replaces": tpu if tpu.startswith("experiments/") else f"hvi_cidnet_tpu/ops/{tpu}",
        "launches": sum(launches[v][key] for v in VARIANTS),
        "launches_by_path": {v: launches[v][key] for v in VARIANTS},
        "max_abs_err": max(r["err"] for r in rows if r["dtype"] == "torch.float32"),
        "max_abs_err_bf16": max(r["err"] for r in rows if r["dtype"] == "torch.bfloat16"),
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": worst["bound_by"],
        "library_ms": per_forward("library_ms"),
        "ms_by_path": {v: per_forward("ms", v) for v in VARIANTS},
        "plain_ms_by_path": {v: per_forward("plain_ms", v) for v in VARIANTS},
        "bound_ms_by_path": {v: per_forward("bound_ms", v) for v in VARIANTS},
    }
    if key == "K5":
        line["bound_cuda_core_ms"] = per_forward("bound_cuda_core_ms")
    if key in FUSED:
        line["unfused_ms"] = per_forward("unfused_ms")
    for field in ("k5_ms", "route_ms", "cudnn_ms"):
        if field in bf[0]:
            line[field] = per_forward(field)
    return line


def summarise_relayout(key: str, rows: list, launches: dict) -> dict:
    """The JSON line of a relayout row: its bf16 call on the HWCB path at
    batch 8 (P8/P9/P11: the exit, P14: the entry), or, for P7 and P12/P13,
    which no path runs, at level 1 batch 8 (relayout_cases); device times
    a call from CUDA graphs; ``launches`` from the HWCB serving run (0 for
    P7 and P12/P13)."""
    row = next(r for r in rows if r["line"] and r["dtype"] == "torch.bfloat16")
    tpu = {"P7": "experiments/transpose_kernel_r3.py:38",
           "P8/P9/P11": "experiments/relayout_probe_r5h.py:61, :79 and :211",
           "P12/P13": "experiments/mosaic_micro_r5h.py:43 and :62",
           "P14": "experiments/mosaic_micro_r5h.py:85"}[key]
    return {
        "name": {"P7": "transpose_steps", "P8/P9/P11": "relayout_t3/t2/t2_rev",
                 "P12/P13": "t3_blocked/t2_blocked", "P14": "pack_blocked"}[key],
        "route": "cuda",
        "source": "hvi_cidnet_torch/csrc/relayout.cu",
        "replaces": tpu,
        "launches": sum(launches[v][key] for v in VARIANTS),
        "launches_by_path": {v: launches[v][key] for v in VARIANTS},
        "max_abs_err": max(r["err"] for r in rows if r["dtype"] == "torch.float32"),
        "max_abs_err_bf16": max(r["err"] for r in rows if r["dtype"] == "torch.bfloat16"),
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "wrapper_ms": row["wrapper_ms"],
        "site": row["site"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from hvi_cidnet_torch.models.cidnet import HVIGates, cidnet_forward
    from hvi_cidnet_torch.ops import _build
    from hvi_cidnet_torch.ops import (
        attention_cuda, batched_qk_cuda, conv3x3_cuda, head_attention_cuda, hvi_cuda, iel_cuda,
        im2col_cuda, ln_iel_cuda, norm_cuda, relayout_cuda, resize_cuda,
    )
    from hvi_cidnet_torch.ops.routes import FUSED as FUSED_ROUTE
    from hvi_cidnet_torch.ops.routes import PROBE as PROBE_ROUTE
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
               "K3": resize_cuda.HALF_PRELU, "K4": resize_cuda.DOUBLE,
               "K5": attention_cuda.ATTENTION, "K6": norm_cuda.LAYER_NORM,
               "K7": iel_cuda.IEL_BRANCH, "P2/P3": ln_iel_cuda.LN_IEL,
               "P4": conv3x3_cuda.CONV3X3, "P5": conv3x3_cuda.CONV3X3_HALF_PRELU,
               "P1": head_attention_cuda.HEAD_ATTENTION, "P6": im2col_cuda.IM2COL_DOTS,
               "P10/P15": batched_qk_cuda.BATCHED_QK, **relayout_cuda.KERNELS}
    results = {k: [] for k in kernels}
    compare_relayout(results, dev)
    compare_probe(results, dev)
    torch.cuda.empty_cache()
    compare_fused(results, dev)
    compare_hvi(results, dev)
    compare_resize(results, dev)
    compare_lca(results, dev)
    batch1_info(dev)
    torch.cuda.empty_cache()
    ROUTES.update(default=(None, PER_FORWARD, TNSM_TRAINING),
                  fused=(FUSED_ROUTE, PER_FORWARD_FUSED, TNSM_TRAINING_FUSED),
                  probe=(PROBE_ROUTE, PER_FORWARD_PROBE, TNSM_TRAINING_PROBE))
    routes = {name: (route, want) for name, (route, want, _) in ROUTES.items()}
    bf_models = {v: compare_forward(dev, v, kernels) for v in VARIANTS}
    for name in ("fused", "probe"):
        for v in VARIANTS:
            compare_forward(dev, v, kernels, name)
    torch.cuda.empty_cache()

    # launches of one forward (the bf16 serving models, 1 x 400 x 600)
    x = torch.rand((1, H, W, 3), generator=torch.Generator().manual_seed(2)).to(dev, torch.bfloat16)
    for name, (route, want) in routes.items():
        for variant, model in bf_models.items():
            reset(kernels)
            with torch.no_grad():
                cidnet_forward(model, x, compute_dtype=torch.bfloat16, routes=route)
            torch.cuda.synchronize()
            per_forward = counts(kernels)
            log(f"{variant} {name} route launches per forward: {per_forward}")
            if per_forward != want[variant]:
                raise AssertionError(f"{variant} {name} route launches per forward {per_forward} "
                                     f"!= {want[variant]}")
    x_hwcb = x.permute(1, 2, 3, 0).contiguous()
    for variant, model in bf_models.items():
        reset(kernels)
        with torch.no_grad():
            cidnet_forward(model, x_hwcb, compute_dtype=torch.bfloat16, input_layout="hwcb")
        torch.cuda.synchronize()
        per_forward = counts(kernels)
        log(f"{variant} HWCB forward launches per forward: {per_forward}")
        if per_forward != PER_FORWARD_HWCB[variant]:
            raise AssertionError(f"{variant} HWCB launches per forward {per_forward} != "
                                 f"{PER_FORWARD_HWCB[variant]}")

    # the main path: requests through the serving entry point, each variant,
    # on the default route, the fused one and the probe one (this slice's
    # path)
    gates = HVIGates(gated=True, gated2=True, alpha=0.95, alpha_s=1.1)
    rng = np.random.default_rng(3)
    requests = [rng.uniform(0, 0.4, (h, w, 3)).astype(np.float32)
                for h, w in [(400, 600), (389, 517), (600, 400), (389, 517)]]
    n = len(requests)
    served = {name: {} for name in routes}
    for name, (route, want) in routes.items():
        for variant, model in bf_models.items():
            enhancer = Enhancer(model, gates, gamma=0.8, compute_dtype=torch.bfloat16, device=dev,
                                routes=route)
            reset(kernels)
            t0 = time.perf_counter()
            outs = [enhancer.enhance(img) for img in requests]
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            served[name][variant] = counts(kernels)
            for img, out in zip(requests, outs):
                if (out.shape != img.shape or not np.isfinite(out).all() or out.min() < 0
                        or out.max() > 1):
                    raise AssertionError(f"{variant} {name} route served {img.shape} -> "
                                         f"{out.shape}: bad output")
            log(f"{variant} {name} route served {n} requests {[r.shape[:2] for r in requests]} "
                f"in {serve_s:.3f} s (first includes warm-up); launches {served[name][variant]}")
            expect = {k: n * v for k, v in want[variant].items()}
            if served[name][variant] != expect:
                raise AssertionError(f"{variant} {name} route serving launches "
                                     f"{served[name][variant]} != {expect}")

    # this slice's path: batches packed as (H, W, 3, B) through the HWCB
    # serving contract, each variant (the default route)
    batches = [rng.uniform(0, 0.4, (h, w, 3, b)).astype(np.float32)
               for h, w, b in [(400, 600, 2), (400, 600, 1), (600, 400, 3), (296, 400, 2)]]
    served["hwcb"] = {}
    for variant, model in bf_models.items():
        reset(kernels)
        t0 = time.perf_counter()
        with torch.no_grad():
            outs = [rgb_of(variant, cidnet_forward(
                model, torch.from_numpy(xb).to(dev, torch.bfloat16), compute_dtype=torch.bfloat16,
                input_layout="hwcb")).float().cpu() for xb in batches]
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        served["hwcb"][variant] = counts(kernels)
        for xb, out in zip(batches, outs):
            if out.shape != xb.shape or not torch.isfinite(out).all():
                raise AssertionError(f"{variant} HWCB batch {xb.shape} -> {tuple(out.shape)}")
        log(f"{variant} HWCB served {len(batches)} batches {[b.shape for b in batches]} in "
            f"{serve_s:.3f} s; launches {served['hwcb'][variant]}")
        expect = {k: len(batches) * v for k, v in PER_FORWARD_HWCB[variant].items()}
        if served["hwcb"][variant] != expect:
            raise AssertionError(f"{variant} HWCB serving launches {served['hwcb'][variant]} "
                                 f"!= {expect}")

    # throughput at 600 x 400 bf16 (information)
    for name, (route, _) in routes.items():
        for variant, model in bf_models.items():
            for b in (1, 8, 32):
                xb = torch.rand((b, H, W, 3), generator=torch.Generator().manual_seed(b)).to(
                    dev, torch.bfloat16)
                torch.cuda.reset_peak_memory_stats()
                with torch.no_grad():
                    ms = time_ms(lambda: rgb_of(variant, cidnet_forward(
                        model, xb, compute_dtype=torch.bfloat16, routes=route)).clamp_(0, 1),
                        iters=5, warmup=2)
                peak = torch.cuda.max_memory_allocated() / 2**30
                log(f"{variant} {name} route forward 600x400 bf16 batch {b}: {ms:.2f} ms, "
                    f"{1000 * b / ms:.1f} img/s, peak {peak:.2f} GiB")
    # HWCB against NHWC on the default route, in turns (NHWC, HWCB, HWCB, NHWC)
    for variant, model in bf_models.items():
        for b in (1, 8, 32):
            xb = torch.rand((b, H, W, 3), generator=torch.Generator().manual_seed(b)).to(
                dev, torch.bfloat16)
            xh = xb.permute(1, 2, 3, 0).contiguous()
            arms = {"nhwc": lambda: rgb_of(variant, cidnet_forward(
                        model, xb, compute_dtype=torch.bfloat16)).clamp_(0, 1),
                    "hwcb": lambda: rgb_of(variant, cidnet_forward(
                        model, xh, compute_dtype=torch.bfloat16, input_layout="hwcb")).clamp_(0, 1)}
            ms = {"nhwc": [], "hwcb": []}
            with torch.no_grad():
                for arm in ("nhwc", "hwcb", "hwcb", "nhwc"):
                    ms[arm].append(time_ms(arms[arm], iters=5, warmup=2))
            t_n, t_h = (sum(ms[a]) / 2 for a in ("nhwc", "hwcb"))
            log(f"{variant} HWCB vs NHWC forward 600x400 bf16 batch {b}: HWCB {t_h:.2f} ms "
                f"({1000 * b / t_h:.1f} img/s) against NHWC {t_n:.2f} ms ({1000 * b / t_n:.1f} "
                f"img/s), ratio {t_h / t_n:.4f}; in turns {ms['nhwc'][0]:.2f} / {ms['hwcb'][0]:.2f}"
                f" / {ms['hwcb'][1]:.2f} / {ms['nhwc'][1]:.2f} ms")

    path_of = lambda key: ("fused" if key in FUSED else "probe" if key in PROBE else
                           "hwcb" if key in RELAYOUTS else "default")
    summary = [(summarise_relayout if key in RELAYOUTS else summarise)(
        key, results[key], served[path_of(key)]) for key in kernels]
    log(smi)  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
