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
5e. F2, the forward's input contract: for base at batch 2, fp32 and bf16, a
   strided NHWC input (the permute of an NCHW tensor, a crop
   ``x[:, :400, :600]`` of a larger one) and a strided HWCB input give,
   bitwise, the forward of their contiguous copy, and an fp16 input the
   forward of its fp32 cast;
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
   contract for each variant; each run's counts are set
   to 0 before it and read after;
8. prints each variant's images per second at 600 x 400 bf16, batch 1, 8
   and 32, on the default, the fused and the probe route, and HWCB against
   NHWC on the default route in turns (information);
9. evaluates a dataset folder end to end (the eval path), with PIL
   and cv2 made unimportable: writes synthetic PNGs (``data/png.py``: six 600 x 400, two
   601 x 397, one 1280 x 720, one 30 x 64 sliver; four padded shapes, a
   partial chunk at batch 8) and base's seeded weights as the JAX trainer's
   ``.npz`` (``compat/checkpoint.py``), then runs ``cli/eval.py --unpaired
   --custome`` on them in fp32 and bf16: every PNG at its input's size; fp32
   (TF32 off) within one uint8 level of ``Evaluator.enhance`` of the same
   image on the card, 99.9% of pixels equal; bf16 against fp32 within base's
   bf16 mean bar; the launches of each run, counted from 0 around it, the
   base forward's times the chunks; MSSA (the CLI's default variant) in
   bf16 with its own weights; base again with ``--max_programs 2`` (the
   quantum escalates to 1024: the tail chunks repeat rows, the sliver takes
   edge padding); then ``cli/eval_tnsm.py`` on the 600 x 400 images with a
   full TNSM file (every tensor loaded), ``cli/convert_weights.py`` to an HF
   folder (read back bitwise) and ``cli/eval_hf.py --local_file`` on one
   image; prints ``run_dataset``'s images per second on 48 PNGs at 600 x 400
   (bf16, batch 8) beside the forward's alone at the same batch
   (information);
10. scores on the card (this slice's path), with PIL, cv2 and jax made
   unimportable: LPIPS with seeded AlexNet + lin weights written as a
   combined state dict and read back, card against CPU within 1e-5
   relative on one 600 x 400 pair and a batch of 8, also with TF32 allowed
   globally (``lpips_distance`` turns it off and restores the flags);
   ``cli/parity.py``'s ``main()`` for "LOLv1 wo_perc" on a synthetic LOLv1
   layout (15 PNG pairs at 600 x 400, base random weights as a ``.pth``),
   LPIPS on the card: the report written, both GT-mean rows equal to PSNR,
   SSIM and LPIPS averaged over the written PNGs by hand (1e-9), the eval's
   launches two chunks of one base forward, the gate passing on the rows
   adopted and failing at +1 dB, then ``--dry_run``; ``cli/measure.py`` on
   the same folders (the rows' numbers); ``cli/measure_SID_blur.py`` on two
   scenes, one output a pixel narrower than its GT (resized); and
   ``cli/measure_niqe_bris.py`` on four 600 x 400 PNGs (NIQE as by hand;
   BRISQUE native, or n/a with the reason printed); prints the host ms a
   pair of PSNR, SSIM, NIQE and the BRISQUE features, LPIPS's card ms a
   pair and the parity case's seconds (information);
11. trains on the card (this slice's path), with PIL, cv2 and jax made
   unimportable, in a temporary directory: (a) ``composite_loss``'s loss and
   every parameter's gradient, base (gamma, perceptual) and TNSM at full
   width, 2 x 256 x 256, fp32 with TF32 off, kernels on the card against
   their plain versions on the CPU (base 1e-3, TNSM 2e-2 of each tensor's
   largest |gradient|; no gradient None or zero on one device only); (b)
   ``cli/train.py``'s ``main()``, base, bf16, crop 256, batch 8, 3 epochs
   of 6 synthetic steps, random seeded VGG19: finite losses, epoch 3's mean
   below epoch 1's, ``epoch_{1,2,3}.npz``, PNG canaries, the report, and
   every step's launches K1 3 (the forward's and the loss's two HVI
   projections), K2 1, K3 6, K4 6, K5 11, K6 33, K7 22; (c) a checkpoint
   written and read back bitwise (parameters, Adam moments, steps, lr), one
   step from each (bitwise under ``torch.use_deterministic_algorithms``,
   else within lr bars), and ``--start_epoch 2`` through the CLI; (d) a
   generated LOLv1 layout (16 PNG pairs at 600 x 400, 4 eval pairs), one
   epoch of the reference's 485 samples (60 steps) with the in-loop eval,
   the trained parameters still fp32; (e) ``cli/train_tnsm.py`` (K5 24, K6
   84 a step, the noise terms in the loss); (f) ``remat`` and ``grad_accum
   2`` against the plain step (fp32, lr bars; peak memory); (g) prints the
   base step's ms and images/s at batch 8 and 16 with and without the
   perceptual term, peak memory, the perceptual term with TF32 on and off,
   and the share of the step in ``twin_backward`` and in each kernel;
12. scales out on the card (this slice's path), with PIL, cv2 and jax made
   unimportable, in a temporary directory; on one card the replicas and
   ranks share it (two ranks on gloo), on two or more they take a card
   each (nccl): (a) ``dp_enhance_fn`` over two replicas, base and TNSM at
   8 x 400 x 600, gates and gamma on, against ``Enhancer.enhance_batch`` on
   one replica (fp32 within each variant's forward bars, bf16 within its
   bf16 mean bar), the launches two batch-4 forwards, a batch of 7 raising
   the JAX ValueError; (b) ``Evaluator(mesh=)`` fp32 on step 9's folder
   within one uint8 level of ``cli/eval.py``'s single-device PNGs (99.9%
   equal), ``cli/eval.py --dp`` printing the no-op line on one card; (c)
   ``cli/train.py --multihost true`` as two processes (children with
   jax, PIL and cv2 blocked; the kernels built here first), base fp32 with
   deterministic algorithms, crop 256, global batch 16, 2 x 3 steps, the
   perceptual term on a seeded VGG19, against one process at batch 16:
   epoch losses within 1e-5 relative, final parameters within the lr bars,
   the ranks' state digests equal; (d) ``--multihost true --num_processes
   1`` on nccl: losses bitwise the one-process run's (two ranks on two
   cards where there are two); (e) ``AsyncCheckpoints`` bitwise the
   synchronous ``.npz``; ``--start_epoch 2`` over two ranks with the file
   in rank 0's directory only: both resume the file's state bitwise;
   ``--ckpt_backend orbax`` over two ranks: the kept file bitwise the
   ranks' final state; (f) every rank's launches a step K1 3, K2 1, K3 6,
   K4 6, K5 11, K6 33, K7 22; prints the bf16 step's ms for two ranks and
   for one process (information: one card) and the step's seconds;
13. serves one image with its rows split over a row group on the card
   (this slice's path), with PIL, cv2 and jax made unimportable, on the
   cards or, with one card, on it repeated, every plain version made to
   raise on a CUDA tensor: (a) base, MSSA and TNSM at full width, a 1 x 720
   x 1280 frame (gates and gamma on) through ``spatial_enhance_fn`` over 2
   shards against one device's forward of the same frame (fp32 within each
   variant's forward bars, bf16 within its bf16 mean bar); (b) the same over
   4 shards, 720 padded to 736 and cropped back (fp32); (c)
   ``dp_spatial_enhance_fn`` on a (2, 2) mesh at 4 x 400 x 600 (fp32, bf16)
   and its indivisible batch; (d) on every run of (a) and (b), K5's A
   bitwise equal on every shard at every site, and each K3, K4 and K7 site's
   band outputs bitwise the whole-plane kernel's on the shards' inputs put
   together; (e) the launches of a frame, per shard, base K1 1, K2 1, K3 6,
   K4 6, K5 11 (its split entries; the one-call entry 0), K6 33, K7 22, MSSA
   and TNSM at theirs; (f) ``cli/demo.py --spatial --random_init`` against
   the same call without the flag; (g) prints the frame's ms over 2 and 4
   shards against one device's in turns, the shards' host time in
   exchanges and halo assembly and the device time of the concatenation
   kernels (information);
14. prints ``{"kernels": [...]}`` (K1-K7's ``launches`` from step 10's
   parity eval, ``launches_eval`` from step 9's, ``launches_train`` from
   step 11b's, ``launches_dp_serving`` and ``launches_dp_train_step`` from
   step 12's, ``launches_spatial`` from 13a's base bf16 frame) and, last,
   ``{"ok": true, "device": ...}``.

Any failure raises, and the script exits nonzero without the last line.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
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


def compare_f2(dev, bf_model) -> None:
    """Step 5e: strided NHWC and HWCB inputs against their contiguous copies,
    and fp16 against its fp32 cast, bitwise, base at batch 2 (fp32 and the
    bf16 serving model)."""
    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, cidnet_forward

    fp_model = CIDNet(CIDNetConfig(), generator=torch.Generator().manual_seed(0)).to(dev).eval()
    gen = torch.Generator().manual_seed(11)
    for dt, model in ((torch.float32, fp_model), (torch.bfloat16, bf_model)):
        fwd = lambda t, **kw: cidnet_forward(model, t, compute_dtype=dt, **kw)
        big = torch.rand((2, H + 40, W + 56, 3), generator=gen).to(dev, dt)
        crop = big[:, :H, :W]
        cases = {"crop x[:, :400, :600]": crop,
                 "x_nchw.permute(0, 2, 3, 1)": crop.permute(0, 3, 1, 2).contiguous().permute(
                     0, 2, 3, 1)}
        with torch.no_grad():
            ref = fwd(crop.contiguous())
            for name, t in cases.items():
                if t.is_contiguous():
                    raise AssertionError(f"F2 {name}: the test input is contiguous")
                check_equal(f"F2 base {dt} {name} vs its contiguous copy", fwd(t), ref)
            hwcb = crop.contiguous().permute(1, 2, 3, 0)  # (H, W, 3, B), strided
            got = fwd(hwcb, input_layout="hwcb")
            check_equal(f"F2 base {dt} strided HWCB vs its contiguous copy", got,
                        fwd(hwcb.contiguous(), input_layout="hwcb"))
            check_equal(f"F2 base {dt} strided HWCB vs NHWC permuted", got,
                        ref.permute(1, 2, 3, 0))
            x16 = torch.rand((2, H, W, 3), generator=gen).to(dev, torch.float16)
            check_equal(f"F2 base {dt} fp16 input vs its fp32 cast", fwd(x16), fwd(x16.float()))
    log("F2 (5e): base batch 2 fp32 and bf16: strided NHWC (crop, permute) and HWCB inputs "
        "bitwise their contiguous copies; fp16 input bitwise its fp32 cast")


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


# step 9's folder, (H, W): six 600 x 400, two 601 x 397 (reflect-padded to
# 608 x 400), one 1280 x 720 and a 30 x 64 sliver: four padded shapes, and
# the six 600 x 400 a partial chunk at batch 8
EVAL_SIZES = [(400, 600)] * 6 + [(397, 601)] * 2 + [(720, 1280), (64, 30)]
EVAL_BATCH = 8
EVAL_RATE_IMAGES = 48   # 600 x 400 PNGs of the img/s comparison


@contextlib.contextmanager
def cwd(path: str):
    """The eval CLIs write under ./output and ./output_hf: run them in ``path``."""
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


@contextlib.contextmanager
def without_modules(*names: str):
    """Importing any of ``names`` raises ImportError inside the block (the
    card's machine may or may not have them; the eval path must not need
    them)."""
    saved = {n: sys.modules[n] for n in sys.modules if n.split(".")[0] in names}
    for n in saved:
        del sys.modules[n]
    sys.modules.update({n: None for n in names})
    try:
        yield
    finally:
        for n in names:
            del sys.modules[n]
        sys.modules.update(saved)


def call_cli(main, argv: list):
    """Run a CLI's ``main(argv)`` in this process; log its stdout and return
    (what ``main`` returned, its stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    for line in buf.getvalue().splitlines():
        log(f"    | {line}")
    return result, buf.getvalue()


def run_cli(main, argv: list) -> str:
    """Run a CLI's ``main(argv)`` in this process; log and return its stdout."""
    return call_cli(main, argv)[1]


def synthetic_png(rng, h: int, w: int) -> np.ndarray:
    """A dark RGB uint8 image: a colour gradient under noise."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    img = (0.05 + 0.25 * (yy[..., None] * rng.uniform(0, 1, 3) + xx[..., None]
                          * rng.uniform(0, 1, 3)) + rng.normal(0, 0.03, (h, w, 3)))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def eval_path(dev, kernels) -> dict:
    """Step 9: the eval CLIs on synthetic PNGs at full width, on the card.
    Returns the launches of each variant's bf16 run of ``cli/eval.py``
    (TNSM's: ``cli/eval_tnsm.py``), by variant. PIL and cv2 cannot be
    imported while it runs."""
    with without_modules("PIL", "cv2"):
        return _eval_path(dev, kernels)


def _eval_path(dev, kernels) -> dict:
    from hvi_cidnet_torch.cli import convert_weights, eval_hf, eval_tnsm
    from hvi_cidnet_torch.cli import eval as eval_cli
    from hvi_cidnet_torch.compat.checkpoint import save_checkpoint
    from hvi_cidnet_torch.compat.jax_params import load_state_dict_file
    from hvi_cidnet_torch.data import png
    from hvi_cidnet_torch.data.datasets import EvalDataset
    from hvi_cidnet_torch.eval.evaluator import (
        Evaluator, _bucket, gates_for_dataset, plan_bucket_quantum,
    )
    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, HVIGates, cidnet_forward

    rng = np.random.default_rng(9)
    base = CIDNet(CIDNetConfig(), generator=torch.Generator().manual_seed(0))
    mssa = CIDNet(CIDNetConfig(variant="mssa"), generator=torch.Generator().manual_seed(2))
    tnsm = CIDNet(CIDNetConfig(variant="tnsm"), generator=torch.Generator().manual_seed(1))
    with tempfile.TemporaryDirectory() as tmp:
        src, src_tnsm = os.path.join(tmp, "in"), os.path.join(tmp, "in_tnsm")
        os.makedirs(src)
        os.makedirs(src_tnsm)
        imgs = {}
        for i, (h, w) in enumerate(EVAL_SIZES):
            name = f"{i:02d}_{w}x{h}.png"
            imgs[name] = synthetic_png(rng, h, w)
            png.write(os.path.join(src, name), imgs[name])
            if (h, w) == (H, W):
                png.write(os.path.join(src_tnsm, name), imgs[name])
        npz, tnsm_npz = os.path.join(tmp, "base.npz"), os.path.join(tmp, "tnsm.npz")
        mssa_npz = os.path.join(tmp, "mssa.npz")
        save_checkpoint(npz, base.state_dict())
        save_checkpoint(mssa_npz, mssa.state_dict())
        save_checkpoint(tnsm_npz, tnsm.state_dict())
        argv = ["--unpaired", "--custome", "--custome_path", src, "--weights", npz,
                "--variant", "base", "--eval_batch", str(EVAL_BATCH)]

        def chunks(sizes, quantum):
            per = {}
            for hw in sizes:
                b = _bucket(*hw, quantum)
                per[b] = per.get(b, 0) + 1
            return sum(-(-n // EVAL_BATCH) for n in per.values()), len(per)

        def cli_run(main, argv, tag, sizes, quantum, variant="base"):
            """One CLI run in its own directory, launches counted from 0
            around it; returns (its directory, its stdout, its launches)."""
            run_dir = os.path.join(tmp, tag)
            os.makedirs(run_dir)
            with cwd(run_dir):
                torch.cuda.synchronize()
                reset(kernels)
                t0 = time.perf_counter()
                text = run_cli(main, argv)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launched = counts(kernels)
            n_chunks, n_buckets = chunks(sizes, quantum)
            want = {k: n_chunks * v for k, v in PER_FORWARD[variant].items()}
            log(f"eval {tag}: {len(sizes)} images, {n_buckets} padded shapes, {n_chunks} chunks "
                f"in {secs:.2f} s (model load and first use included); launches {launched}")
            if launched != want:
                raise AssertionError(f"eval {tag} launches {launched} != {n_chunks} chunks x "
                                     f"one {variant} forward {want}")
            return run_dir, text, launched

        def outputs(run_dir, folder, names):
            out = {}
            for name in names:
                got = png.read(os.path.join(run_dir, "output", folder, name))
                if got.shape != imgs[name].shape:
                    raise AssertionError(f"eval wrote {name} at {got.shape}, input {imgs[name].shape}")
                out[name] = got
            return out

        sizes = [(h, w) for h, w in EVAL_SIZES]
        quantum = plan_bucket_quantum(sizes)
        outs, served = {}, {}
        for dtype in ("float32", "bfloat16"):
            run_dir, _, launched = cli_run(eval_cli.main, argv + ["--dtype", dtype], dtype, sizes,
                                           quantum)
            outs[dtype] = outputs(run_dir, "custome", imgs)
        served["base"] = launched
        # MSSA, the CLI's default variant, with its own weights
        run_dir, _, served["mssa"] = cli_run(
            eval_cli.main, ["--unpaired", "--custome", "--custome_path", src, "--weights",
                            mssa_npz, "--dtype", "bfloat16"], "mssa", sizes, quantum, "mssa")
        outputs(run_dir, "custome", imgs)
        ev = Evaluator(npz, CIDNetConfig(variant="base"), gates_for_dataset(unpaired=True),
                       device=dev)
        equal = total = worst = 0
        for name, img in imgs.items():
            ref = (ev.enhance(img.astype(np.float32) / 255.0) * 255.0).astype(np.uint8)
            d = np.abs(outs["float32"][name].astype(np.int16) - ref)
            worst, equal, total = max(worst, int(d.max())), equal + int((d == 0).sum()), total + d.size
        log(f"eval fp32 PNGs vs Evaluator.enhance on the card: max {worst} uint8 levels, "
            f"{equal}/{total} values equal ({100 * equal / total:.4f}%)")
        if worst > 1 or equal < 0.999 * total:
            raise AssertionError(f"eval fp32 PNGs vs enhance: max {worst} levels, "
                                 f"{equal}/{total} equal (bar: 1 level, 99.9%)")
        diff = np.concatenate([(outs["bfloat16"][n].astype(np.float64)
                                - outs["float32"][n]).ravel() / 255.0 for n in imgs])
        log(f"eval bf16 PNGs vs fp32 PNGs: mean_abs_err {np.abs(diff).mean():.3e}, "
            f"max_abs_err {np.abs(diff).max():.3e}")
        check("eval bf16 vs fp32 PNGs (mean)", float(np.abs(diff).mean()), TOL_BF16_FORWARD_MEAN)

        mp_quantum = plan_bucket_quantum(sizes, max_programs=2)
        run_dir, _, _ = cli_run(eval_cli.main, argv + ["--dtype", "bfloat16", "--max_programs",
                                                       "2"], "max_programs", sizes, mp_quantum)
        n_chunks, _ = chunks(sizes, mp_quantum)
        mp = outputs(run_dir, "custome", imgs)
        moved = np.mean([np.abs(mp[n].astype(np.float64) - outs["bfloat16"][n]).mean() / 255
                         for n in imgs])
        log(f"eval --max_programs 2: pad quantum {mp_quantum}, {n_chunks} chunks of "
            f"{EVAL_BATCH} rows each (tails repeated), every PNG at its input's size; the "
            f"larger pad moved the outputs by {moved:.3e} on average (attention reads the pad)")

        tnsm_sizes = [(H, W)] * sum(hw == (H, W) for hw in EVAL_SIZES)
        _, text, served["tnsm"] = cli_run(
            eval_tnsm.main, ["--unpaired", "--custome", "--custome_path", src_tnsm, "--weights",
                             tnsm_npz, "--dtype", "bfloat16"], "tnsm", tnsm_sizes, quantum, "tnsm")
        n_params = len(tnsm.state_dict())
        if f"loaded {n_params}/{n_params} tensors" not in text:
            raise AssertionError(f"eval_tnsm did not load all {n_params} tensors of a full file")
        outputs(os.path.join(tmp, "tnsm"), "custome", os.listdir(src_tnsm))

        hf_dir = os.path.join(tmp, "hf")
        run_cli(convert_weights.main, [npz, hf_dir, "--hf"])
        back, own = load_state_dict_file(hf_dir), base.state_dict()
        if back.keys() != own.keys() or not all(torch.equal(back[k], own[k]) for k in own):
            raise AssertionError("convert_weights --hf: the folder does not read back bitwise")
        one = list(imgs)[6]  # a 601 x 397 image
        run_dir = os.path.join(tmp, "eval_hf")
        os.makedirs(run_dir)
        with cwd(run_dir):
            run_cli(eval_hf.main, ["--local_file", os.path.join(hf_dir, "model.safetensors"),
                                   "--config_json", os.path.join(hf_dir, "config.json"),
                                   "--input_img", os.path.join(src, one)])
        got = png.read(os.path.join(run_dir, "output_hf", one)).astype(np.int16)
        ev_hf = Evaluator(base, None, HVIGates(alpha=1.0, alpha_s=1.0), device=dev)
        ref = (np.clip(ev_hf.enhance(imgs[one].astype(np.float32) / 255.0), 0, 1) * 255
               ).astype(np.uint8)
        log(f"eval_hf --local_file {one}: {got.shape}, max {int(np.abs(got - ref).max())} "
            "uint8 levels from Evaluator.enhance")
        if got.shape != ref.shape or np.abs(got - ref).max() > 1:
            raise AssertionError("eval_hf output disagrees with enhance")

        # images per second (information): run_dataset on 48 PNGs at 600 x 400,
        # bf16, batch 8, a warm-up run first, against the forward alone
        rate = os.path.join(tmp, "rate")
        os.makedirs(rate)
        for i in range(EVAL_RATE_IMAGES):
            png.write(os.path.join(rate, f"{i:03d}.png"), synthetic_png(rng, H, W))
        ev_bf = Evaluator(npz, CIDNetConfig(variant="base"), gates_for_dataset(unpaired=True),
                          compute_dtype=torch.bfloat16, device=dev)
        data = EvalDataset(rate, pad=True)
        ev_bf.run_dataset(data, os.path.join(tmp, "rate_out"), verbose=False,
                          batch_size=EVAL_BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = ev_bf.run_dataset(data, os.path.join(tmp, "rate_out"), verbose=False,
                              batch_size=EVAL_BATCH)
        torch.cuda.synchronize()
        dataset_rate = n / (time.perf_counter() - t0)
        xb = torch.rand((EVAL_BATCH, H, W, 3), generator=torch.Generator().manual_seed(4)).to(
            dev, torch.bfloat16)
        with torch.no_grad():
            ms = time_ms(lambda: cidnet_forward(ev_bf.model, xb, ev_bf.gates,
                                                compute_dtype=torch.bfloat16).clamp_(0, 1),
                         iters=10, warmup=2)
        # the host's share, one step at a time on this machine's CPU: decode
        # of one input, enhance_batch of one chunk (copies in and out
        # included), encode of one output
        stacked = np.stack([data[i][0] for i in range(EVAL_BATCH)])
        out8 = (ev_bf.enhance_batch(stacked)[0] * 255).astype(np.uint8)
        host = {}
        for step, fn in (("decode", lambda: data[0]),
                         ("enhance_batch", lambda: ev_bf.enhance_batch(stacked)),
                         ("encode", lambda: png.write(os.path.join(tmp, "one.png"), out8))):
            fn()
            t0 = time.perf_counter()
            for _ in range(5):
                fn()
            host[step] = (time.perf_counter() - t0) / 5 * 1000
        log(f"eval rate, 600x400 bf16 batch {EVAL_BATCH}: run_dataset {dataset_rate:.1f} img/s "
            f"({n} PNGs decoded, run and written) against the forward alone "
            f"{1000 * EVAL_BATCH / ms:.1f} img/s ({ms:.2f} ms a batch); one PNG decoded "
            f"{host['decode']:.2f} ms, enhance_batch of {EVAL_BATCH} {host['enhance_batch']:.2f} ms "
            f"(copies in and out included), one PNG encoded {host['encode']:.2f} ms (2 writer "
            f"threads); card {nvidia_smi()}")
    return served


# step 10: the parity loop's LOLv1 layout (the size of eval15), the unpaired
# folder of measure_niqe_bris, LPIPS on the card against the CPU (fp32, TF32
# off inside lpips_distance) and the batch of its timing
SCORE_IMAGES = 15
SCORE_UNPAIRED = 4
SCORE_LPIPS_BATCH = 8
TOL_LPIPS_REL = 1e-5
TOL_SCORE = 1e-9        # a harness's averages against the same metrics by hand


def host_ms(fn, reps: int = 3) -> float:
    """Mean wall time of ``fn`` on the host, after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1000


def check_close(name: str, got: tuple, want: tuple, tol: float = TOL_SCORE) -> None:
    err = max(abs(g - w) for g, w in zip(got, want))
    if not err <= tol:
        raise AssertionError(f"{name}: {got} against {want} by hand, max abs err {err:.3e}")


def scoring_path(dev, kernels) -> dict:
    """Step 10: the scoring path on the card, with PIL, cv2 and jax made
    unimportable. Returns the launches of the parity loop's eval, counted
    from 0 around ``cli/parity.py``'s ``main()``."""
    with without_modules("PIL", "cv2", "jax"):
        return _scoring_path(dev, kernels)


def _scoring_path(dev, kernels) -> dict:
    from hvi_cidnet_torch.cli import measure as measure_cli
    from hvi_cidnet_torch.cli import measure_niqe_bris, measure_SID_blur, parity
    from hvi_cidnet_torch.compat.checkpoint import export_pth
    from hvi_cidnet_torch.data import png
    from hvi_cidnet_torch.metrics import brisque, brisque_cv, lpips, niqe, pil_resize
    from hvi_cidnet_torch.metrics.psnr_ssim import gt_mean_rectify, psnr, ssim_matlab
    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig

    rng = np.random.default_rng(10)
    with tempfile.TemporaryDirectory() as tmp:
        # 1. LPIPS on the card: seeded AlexNet + lin weights written as the
        # lpips package's combined state dict and read back
        seeded = lpips.init_lpips(torch.Generator().manual_seed(5)).state_dict()
        lp_path = os.path.join(tmp, "alex_lpips.pth")
        torch.save({(f"{k[:4]}.model.1.weight" if k.startswith("lin") else k): v
                    for k, v in seeded.items()}, lp_path)
        lp_cpu = lpips.load_lpips_torch(lp_path)
        lp_card = lpips.load_lpips_torch(lp_path).to(dev)
        g = torch.Generator().manual_seed(6)
        a8 = torch.rand((SCORE_LPIPS_BATCH, 3, H, W), generator=g) * 2 - 1
        b8 = (a8 + 0.25 * torch.randn(a8.shape, generator=g)).clamp(-1, 1)
        for n in (1, SCORE_LPIPS_BATCH):
            want = lpips.lpips_distance(lp_cpu, a8[:n], b8[:n])
            for tf32 in (False, True):
                torch.backends.cudnn.allow_tf32 = tf32
                torch.backends.cuda.matmul.allow_tf32 = tf32
                got = lpips.lpips_distance(lp_card, a8[:n].to(dev), b8[:n].to(dev)).cpu()
                flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
                if flags != (tf32, tf32):
                    raise AssertionError(f"lpips_distance left the TF32 flags at {flags}, "
                                         f"not {(tf32, tf32)}")
                err = float(((got - want).abs() / want.abs()).max())
                log(f"LPIPS card vs CPU, {n} x 3 x {H} x {W}, TF32 allowed globally: {tf32}: "
                    f"max rel err {err:.3e} (values {float(want.min()):.6f}.."
                    f"{float(want.max()):.6f}); global flags restored")
                check(f"LPIPS card vs CPU (relative), batch {n}, TF32 {tf32}", err,
                      TOL_LPIPS_REL)
        a1, b1, a8, b8 = a8[:1].to(dev), b8[:1].to(dev), a8.to(dev), b8.to(dev)
        lp_ms = time_ms(lambda: lpips.lpips_distance(lp_card, a1, b1), iters=10)
        lp8_ms = time_ms(lambda: lpips.lpips_distance(lp_card, a8, b8), iters=5)

        # 2. the parity loop at LOLv1's shape: 15 pairs at 600 x 400 and base
        # random weights as a .pth, through cli/parity.py's main()
        case = next(c for c in parity.CASES if c.name == "LOLv1 wo_perc")
        wroot, droot = os.path.join(tmp, "weights"), os.path.join(tmp, "datasets")
        wpath = os.path.join(wroot, case.weights_rel)
        export_pth(wpath, CIDNet(CIDNetConfig(), generator=torch.Generator().manual_seed(0))
                   .state_dict())
        low, high = os.path.join(droot, case.eval_dir_rel), os.path.join(droot, case.label_dir_rel)
        os.makedirs(low)
        os.makedirs(high)
        for i in range(SCORE_IMAGES):
            lo = synthetic_png(rng, H, W)
            png.write(os.path.join(low, f"{i + 1}.png"), lo)
            png.write(os.path.join(high, f"{i + 1}.png"),
                      np.clip(lo.astype(np.int32) * 3 + 10, 0, 255).astype(np.uint8))
        out_root, report = os.path.join(tmp, "output"), os.path.join(tmp, "parity_report.md")
        rows, run_case = [], parity.run_case

        def recording_run_case(*args, **kw):
            got = run_case(*args, **kw)
            rows.extend(got)
            return got

        parity.run_case = recording_run_case
        try:
            torch.cuda.synchronize()
            reset(kernels)
            t0 = time.perf_counter()
            code, _ = call_cli(parity.main, [
                "--weights_root", wroot, "--datasets_root", droot, "--out_root", out_root,
                "--report", report, "--cases", case.name, "--lpips_weights", lp_path,
                "--eval_batch", str(EVAL_BATCH)])
            torch.cuda.synchronize()
            parity_s = time.perf_counter() - t0
            launched = counts(kernels)
        finally:
            parity.run_case = run_case
        n_chunks = -(-SCORE_IMAGES // EVAL_BATCH)
        want = {k: n_chunks * v for k, v in PER_FORWARD["base"].items()}
        log(f"parity {case.name}: {SCORE_IMAGES} images at {W} x {H}, {n_chunks} chunks in "
            f"{parity_s:.2f} s (eval, both GT-mean rows, LPIPS on the card; weights load and "
            f"first use included); exit code {code}; launches {launched}")
        if launched != want:
            raise AssertionError(f"parity eval launches {launched} != {n_chunks} chunks x one "
                                 f"base forward {want}")
        if [r["gt_mean"] for r in rows] != [False, True] or any(
                r["images"] != SCORE_IMAGES for r in rows):
            raise AssertionError(f"parity rows {rows}")
        if code != (0 if all(r["pass"] for r in rows) else 1):
            raise AssertionError(f"parity exit code {code} for rows {rows}")
        with open(report) as f:
            text = f.read()
        if "2 row(s) measured" not in text or case.name not in text:
            raise AssertionError(f"parity report:\n{text}")
        # every row against the metrics averaged over the written PNGs by hand
        out_dir = os.path.join(out_root, case.name.replace(" ", "_"))
        names = sorted(os.listdir(out_dir))
        if names != sorted(os.listdir(high)):
            raise AssertionError(f"parity wrote {names}")
        for r in rows:
            tot = np.zeros(3)
            for name in names:
                a, b = png.read(os.path.join(out_dir, name)), png.read(os.path.join(high, name))
                if r["gt_mean"]:
                    a = gt_mean_rectify(a.astype(np.float64), b)
                lp = lpips.lpips_distance(lp_card, lpips.im2tensor_range(
                    np.asarray(a, np.float64).clip(0, 255).astype(np.uint8)),
                    lpips.im2tensor_range(b))
                tot += [psnr(a, b), ssim_matlab(a, b), float(lp[0])]
            check_close(f"parity row gt_mean={r['gt_mean']}", (r["psnr"], r["ssim"], r["lpips"]),
                        tuple(tot / len(names)))
            log(f"parity row gt_mean={r['gt_mean']}: PSNR {r['psnr']:.4f} dB, SSIM "
                f"{r['ssim']:.4f}, LPIPS {r['lpips']:.4f} (pass against the README: {r['pass']}),"
                f" equal to the metrics by hand within {TOL_SCORE:.0e}")
        # the gate is live: the measured rows adopted pass, +1 dB fails
        adopted = parity.gate_check(case, wpath, low, high, os.path.join(tmp, "gate"),
                                    lpips=lp_card, device=dev)
        for r, a in zip(rows, adopted):
            check_close("parity adopted row", (a["psnr"], a["ssim"], a["lpips"]),
                        (r["psnr"], r["ssim"], r["lpips"]))
        log("parity gate: the measured rows adopted as expectations pass, at +1 dB every row "
            "fails")
        code, _ = call_cli(parity.main, ["--dry_run"])
        if code != 0:
            raise AssertionError(f"parity --dry_run exit code {code}")

        # 3. cli/measure.py on the same folders: the rows' numbers
        for r in rows:
            got, _ = call_cli(measure_cli.main, [
                "--im_dir", os.path.join(out_dir, "*.png"), "--label_dir", high,
                "--lpips_weights", lp_path] + ["--use_GT_mean"] * r["gt_mean"])
            check_close(f"measure --use_GT_mean={r['gt_mean']}", got,
                        (r["psnr"], r["ssim"], r["lpips"]))
        # measure_SID_blur on two scenes; one output a pixel narrower than
        # its GT, so pil_resize runs
        sid_out, sid_gt = os.path.join(tmp, "sid_out"), os.path.join(tmp, "sid_gt")
        tot, n = np.zeros(3), 0
        for scene in ("10001", "10002"):
            os.makedirs(os.path.join(sid_out, scene))
            os.makedirs(os.path.join(sid_gt, scene))
            for i, w in enumerate((W, W - 1)):
                b = png.read(os.path.join(high, names[2 * int(scene[-1]) + i]))
                a = png.read(os.path.join(out_dir, names[2 * int(scene[-1]) + i]))[:, :w]
                png.write(os.path.join(sid_out, scene, f"{i}.png"), a)
                png.write(os.path.join(sid_gt, scene, f"{i}.png"), b)
                a = pil_resize.resize(a, (W, H)) if a.shape != b.shape else a
                lp = lpips.lpips_distance(lp_card, lpips.im2tensor_range(a),
                                          lpips.im2tensor_range(b))
                tot += [psnr(a, b, eps_guard=False), ssim_matlab(a, b), float(lp[0])]
                n += 1
        got, _ = call_cli(measure_SID_blur.main, ["--SID", "--out_root", sid_out, "--gt_root",
                                                  sid_gt, "--lpips_weights", lp_path])
        check_close("measure_SID_blur", got, tuple(tot / n))

        # 4. measure_niqe_bris on four 600 x 400 PNGs: NIQE as by hand;
        # BRISQUE the native score, or n/a with the reason
        un = os.path.join(tmp, "unpaired")
        os.makedirs(un)
        imgs = [png.read(os.path.join(out_dir, name)) for name in names[:SCORE_UNPAIRED]]
        for i, img in enumerate(imgs):
            png.write(os.path.join(un, f"{i}.png"), img)
        (niqe_avg, bris_avg), _ = call_cli(measure_niqe_bris.main,
                                           ["--im_dir", os.path.join(un, "*.png")])
        by_hand = sum(niqe.calculate_niqe(img) for img in imgs) / len(imgs)
        if not np.isfinite(niqe_avg):
            raise AssertionError(f"NIQE {niqe_avg}")
        check_close("measure_niqe_bris NIQE", (niqe_avg,), (by_hand,))
        why = brisque_cv.reason()
        if why is None:
            if not np.isfinite(bris_avg):
                raise AssertionError(f"native BRISQUE available but scored {bris_avg}")
            log(f"BRISQUE: the native OpenCV backend, average {bris_avg:.4f}")
        else:
            if bris_avg == bris_avg:
                raise AssertionError(f"BRISQUE scored {bris_avg} with no trained model")
            log(f"BRISQUE: n/a here ({why})")
        log(f"NIQE average {niqe_avg:.6f} over {len(imgs)} images, equal to calculate_niqe by "
            "hand")

        # 5. information: host ms a 600 x 400 pair, card ms an LPIPS pair
        a, b = imgs[0], png.read(os.path.join(high, names[0]))
        t = {"PSNR": host_ms(lambda: psnr(a, b)), "SSIM": host_ms(lambda: ssim_matlab(a, b)),
             "NIQE": host_ms(lambda: niqe.calculate_niqe(a)),
             "BRISQUE features": host_ms(lambda: brisque.brisque_features(a))}
        log(f"scoring at {W} x {H}: host ms a pair (an image for NIQE and BRISQUE) "
            + ", ".join(f"{k} {v:.2f}" for k, v in t.items())
            + f"; LPIPS on the card {lp_ms:.3f} ms a pair at batch 1, "
            f"{lp8_ms / SCORE_LPIPS_BATCH:.3f} ms a pair at batch {SCORE_LPIPS_BATCH}; the parity "
            f"case (eval of {SCORE_IMAGES} images and both rows scored) {parity_s:.2f} s; card "
            f"{nvidia_smi()}")
    return launched


# step 11: training on the card. Launches per base train step (crop 256, no
# remat, no accumulation): the forward's K1-K7 and the loss's two K1 (the
# output's and the ground truth's HVI, fp32); TNSM's training forward runs
# 12 LCAs and 12 TNSM blocks (K5 24, K6 84)
TRAIN_STEP = {"base": dict(NONE_FUSED, **NONE_PROBE, **NONE_RELAYOUT, K1=3, K2=1, K3=6, K4=6,
                           K5=11, K6=33, K7=22),
              "tnsm": dict(NONE_FUSED, **NONE_PROBE, **NONE_RELAYOUT, K1=3, K2=1, K3=6, K4=6,
                           K5=24, K6=84, K7=24)}
TRAIN_CROP = 256
TRAIN_BATCH = 8
# 11a, composite_loss's gradients, kernels on the card (fp32, TF32 off)
# against the plain versions on the CPU, same weights, VGG and batch (2 x
# 256 x 256): per parameter, the largest difference over that tensor's
# largest |gradient| on the CPU; the loss relative. Base: the full forward
# agrees to ~1e-5 of its output (step 5), 100x that. TNSM: scaled from
# tests/tnsm_sensitivity.py as TOL_TNSM was (its forward moves ~13x base's
# for a one-ulp change of the input: 1.1e-5 against 8.6e-7), rounded up
TOL_GRAD = {"base": 1e-3, "tnsm": 2e-2}
TOL_TRAIN_LOSS = {"base": 1e-5, "tnsm": 1e-4}
# TNSM's near-one-hot softmax rows make some parameters' gradients (sums
# that nearly cancel, such as a PReLU slope's) move by more than TOL_GRAD
# when the input moves by one ulp on the CPU alone. Its bar per tensor is
# the larger of TOL_GRAD and this factor times that measured sensitivity
# (the factor TOL_TNSM took over the forward's)
SENSITIVITY_FACTOR = 10
# parameters after one step of two runs that should agree (11c when cuDNN's
# backward is not bitwise, 11f), in units of lr: the mean |diff|, the share
# of elements past 0.1 lr, the largest (Adam's first update is about
# lr * sign(g): a near-zero gradient whose sign differs moves 2 lr)
LR_BARS = {"mean": 1e-3, "share_past_0.1": 1e-2, "max": 2.0}
# 11f's losses: remat recomputes the same forward; grad_accum 2 averages two
# half-batch means (fp32, TF32 off)
TOL_REMAT_LOSS = 1e-6
TOL_ACCUM_LOSS = 1e-5
# the kernels' CUDA function names, for the profiler's device times
KERNEL_NAMES = {"K1": r"\brgb_to_hvi_kernel\b", "K2": r"\bhvi_to_rgb_kernel\b",
                "K3": r"\bhalf_prelu_kernel\b", "K4": r"\bdouble_kernel\b",
                "K5": r"\b(scores_mma|apply_mma|scores_f32|apply_f32|rows)_kernel\b",
                "K6": r"\blayer_norm_kernel\b", "K7": r"\biel_branch_kernel\b"}


def training_path(dev, kernels) -> dict:
    """Step 11: training on the card, with PIL, cv2 and jax made
    unimportable, in a temporary directory (the train CLI writes
    ./weights/train and --val_folder). Returns the launches of 11b's
    ``cli/train.py`` run, per kernel."""
    with without_modules("PIL", "cv2", "jax"), tempfile.TemporaryDirectory() as tmp, cwd(tmp):
        return _training_path(dev, kernels)


def lr_units(name: str, got: dict, ref: dict, lr: float) -> str:
    """Check two parameter sets against LR_BARS; returns the figures."""
    diff = torch.cat([(got[k].float() - ref[k].float()).abs().flatten() for k in ref]).double() / lr
    mean, share, worst = diff.mean().item(), (diff > 0.1).double().mean().item(), diff.max().item()
    figures = f"mean {mean:.3e} lr, share past 0.1 lr {share:.3e}, max {worst:.3e} lr"
    if not (mean <= LR_BARS["mean"] and share <= LR_BARS["share_past_0.1"]
            and worst <= LR_BARS["max"]):
        raise AssertionError(f"{name}: {figures} past {LR_BARS}")
    return figures


def _train_batch(seed: int, n: int = TRAIN_BATCH, hw: int = TRAIN_CROP):
    g = torch.Generator().manual_seed(seed)
    low = torch.rand((n, hw, hw, 3), generator=g) * 0.3
    high = (low * 3 + 0.02 * torch.randn(low.shape, generator=g)).clamp(0, 1)
    return low, high


def _param_grads(model, cfg, vgg, low, high) -> tuple:
    """(loss, {name: gradient on the CPU or None}) of composite_loss."""
    from hvi_cidnet_torch.train.trainer import composite_loss

    d = next(model.parameters()).device
    loss, _ = composite_loss(model, low.to(d), high.to(d), 0.8, vgg, cfg)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.item(), {n: None if g is None else g.cpu() for n, g in zip(names, grads)}


def _rel_by_tensor(got: dict, ref: dict) -> dict:
    """Per parameter: max |got - ref| over the tensor's largest |ref|."""
    return {n: (got[n] - r).abs().max().item() / r.abs().max().item()
            for n, r in ref.items() if r is not None and r.abs().max().item() > 0}


def _grads_card_vs_cpu(dev, variant: str) -> None:
    """11a: composite_loss's loss and every parameter's gradient, and the
    CPU's own sensitivity: its gradients with the input moved by one ulp."""
    from hvi_cidnet_torch.losses.vgg import VGGFeatures
    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig
    from hvi_cidnet_torch.train.trainer import TrainConfig

    cfg = TrainConfig(model=CIDNetConfig(variant=variant), compute_dtype="float32",
                      gamma_aug=variant == "base", use_perceptual=True)
    cpu_model = CIDNet(cfg.model, generator=torch.Generator().manual_seed(21))
    cpu_vgg = VGGFeatures(generator=torch.Generator().manual_seed(0)).requires_grad_(False)
    low, high = _train_batch(22, n=2)
    t0 = time.perf_counter()
    ref_loss, ref = _param_grads(cpu_model, cfg, cpu_vgg, low, high)
    cpu_s = time.perf_counter() - t0
    _, moved = _param_grads(cpu_model, cfg, cpu_vgg, torch.nextafter(low, torch.ones(())), high)
    t0 = time.perf_counter()
    got_loss, got = _param_grads(copy.deepcopy(cpu_model).to(dev), cfg,
                                 copy.deepcopy(cpu_vgg).to(dev), low, high)
    card_s = time.perf_counter() - t0
    rel = abs(got_loss - ref_loss) / abs(ref_loss)
    if not rel <= TOL_TRAIN_LOSS[variant]:
        raise AssertionError(f"11a {variant}: loss {got_loss} card vs {ref_loss} CPU, rel {rel:.3e}")
    for name, r in ref.items():
        g = got[name]
        if (g is None) != (r is None):
            raise AssertionError(f"11a {variant}: {name} gradient None on one device only")
        if r is not None and (r.abs().max().item() == 0) != (g.abs().max().item() == 0):
            raise AssertionError(f"11a {variant}: {name} all zero on one device only")
    worst, sens = _rel_by_tensor(got, ref), _rel_by_tensor(moved, ref)
    bar = {n: max(TOL_GRAD[variant], SENSITIVITY_FACTOR * sens[n] if variant == "tnsm" else 0)
           for n in worst}
    past = sorted(((n, worst[n], bar[n]) for n in worst if worst[n] > bar[n]), key=lambda t: -t[1])
    if past:
        raise AssertionError(f"11a {variant}: gradients past their bars (name, err, bar): {past[:5]}")
    top = max(worst, key=worst.get)
    top_sens = max(sens, key=sens.get)
    kernel_params = [n for n in worst if n.endswith(("prelu.weight", "temperature", "density_k",
                                                     "project_out.weight", "norm.weight",
                                                     "norm.bias", "dwconv1.weight", "dwconv2.weight"))]
    log(f"11a {variant} composite_loss 2 x {TRAIN_CROP} x {TRAIN_CROP} fp32 (TF32 off), kernels on "
        f"the card vs plain versions on the CPU ({card_s:.2f} s / {cpu_s:.2f} s): loss "
        f"{got_loss:.6f} vs {ref_loss:.6f} (rel {rel:.2e}); {len(worst)} nonzero gradients, worst "
        f"{top} {worst[top]:.2e} of its max (sensitivity there {sens[top]:.2e}); the CPU's own "
        f"with the input moved one ulp: worst {top_sens} {sens[top_sens]:.2e}, median "
        f"{float(np.median(list(sens.values()))):.2e} (card's median "
        f"{float(np.median(list(worst.values()))):.2e}); the kernels' own parameters "
        f"({len(kernel_params)}: PReLU slopes, temperatures, project_out, LN, IEL dw, density_k) "
        f"worst {max(worst[n] for n in kernel_params):.2e}; density_k "
        f"{worst['trans.density_k']:.2e}; no gradient None or zero on one device only")


def _state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _opt_state(opt) -> list:
    return [(p_state.get("step"), p_state.get("exp_avg"), p_state.get("exp_avg_sq"))
            for p_state in (opt.state[p] for g in opt.param_groups for p in g["params"])]


def _train_cli(main, argv, kernels, steps: int, want: dict, name: str):
    """Run a train CLI's main(argv) with the counts from 0 around it; check
    every step's launches are ``want``."""
    reset(kernels)
    t0 = time.perf_counter()
    record, _ = call_cli(main, argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts(kernels)
    n = sum(len(x) for x in record["losses"])
    if n != steps:
        raise AssertionError(f"{name}: {n} steps, expected {steps}")
    expect = {k: steps * v for k, v in want.items()}
    if launched != expect:
        raise AssertionError(f"{name}: launches {launched} != {steps} steps x {want}")
    if not all(np.isfinite(x) for ep in record["losses"] for x in ep):
        raise AssertionError(f"{name}: a loss is not finite")
    return record, launched, seconds


def _training_path(dev, kernels) -> dict:
    from hvi_cidnet_torch.cli import train as train_cli
    from hvi_cidnet_torch.cli import train_tnsm
    from hvi_cidnet_torch.data import png
    from hvi_cidnet_torch.losses.vgg import VGGFeatures
    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig
    from hvi_cidnet_torch.ops import attention_cuda, hvi_cuda, iel_cuda, norm_cuda, resize_cuda
    from hvi_cidnet_torch.train import checkpoint as ckpt
    from hvi_cidnet_torch.train.trainer import (
        TrainConfig, composite_loss, make_optimizer, train_step,
    )

    # a. gradients, card against CPU
    for variant in ("base", "tnsm"):
        _grads_card_vs_cpu(dev, variant)
    torch.cuda.empty_cache()

    # b. cli/train.py, base, full width, bf16, crop 256, batch 8
    steps_b = 6 * 3
    argv_b = ["--synthetic_steps", "6", "--nEpochs", "3", "--snapshots", "1", "--batchSize",
              str(TRAIN_BATCH), "--cropSize", str(TRAIN_CROP), "--allow_random_vgg", "true",
              "--start_warmup", "false", "--seed", "1", "--variant", "base"]
    record, launched, seconds = _train_cli(train_cli.main, argv_b, kernels, steps_b,
                                           TRAIN_STEP["base"], "11b")
    means = [float(np.mean(x)) for x in record["losses"]]
    if not means[2] < means[0]:
        raise AssertionError(f"11b: epoch-3 mean loss {means[2]} not below epoch 1's {means[0]}")
    for e in (1, 2, 3):
        if not os.path.isfile(f"weights/train/epoch_{e}.npz"):
            raise AssertionError(f"11b: weights/train/epoch_{e}.npz not written")
    for name in ("test.png", "gt.png"):
        if png.read(f"results/training/{name}").shape != (TRAIN_CROP, TRAIN_CROP, 3):
            raise AssertionError(f"11b: canary {name} is not a {TRAIN_CROP}^2 RGB PNG")
    if not os.path.isfile(record["report"]):
        raise AssertionError("11b: no report")
    log(f"11b cli/train.py base bf16 crop {TRAIN_CROP} batch {TRAIN_BATCH}: {steps_b} steps in "
        f"{seconds:.2f} s (kernel build done, first step's warm-up included); epoch mean losses "
        f"{', '.join(f'{m:.4f}' for m in means)}; epoch_1..3.npz, canaries, report written; "
        f"launches a step {TRAIN_STEP['base']}")

    # c. resume: through the API (save -> load bitwise, one step from each),
    # then through the CLI (--start_epoch 2 from b's epoch_2.npz)
    cfg = TrainConfig(model=CIDNetConfig(), use_perceptual=True)
    vgg = VGGFeatures(generator=torch.Generator().manual_seed(0)).to(dev).requires_grad_(False)
    model = CIDNet(cfg.model, generator=torch.Generator().manual_seed(31)).to(dev)
    opt = make_optimizer(model, cfg)
    for i in range(3):
        low, high = (t.to(dev) for t in _train_batch(40 + i))
        train_step(model, opt, low, high, 1.0, vgg, cfg)
    ckpt.save_checkpoint("resume.npz", model, opt, epoch=3)
    loaded = CIDNet(cfg.model, generator=torch.Generator().manual_seed(32)).to(dev)
    lopt = make_optimizer(loaded, cfg)
    if ckpt.load_checkpoint("resume.npz", loaded, lopt) != 3:
        raise AssertionError("11c: epoch not restored")
    same = all(torch.equal(a, b) for a, b in zip(_state(model).values(), _state(loaded).values()))
    for (s1, m1, v1), (s2, m2, v2) in zip(_opt_state(opt), _opt_state(lopt)):
        same &= torch.equal(s1.cpu(), s2.cpu()) and torch.equal(m1, m2) and torch.equal(v1, v2)
    same &= opt.param_groups[0]["lr"] == lopt.param_groups[0]["lr"]
    if not same:
        raise AssertionError("11c: parameters, moments, steps or lr not bitwise equal after load")
    low, high = (t.to(dev) for t in _train_batch(43))
    det = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    try:
        for m, o in ((model, opt), (loaded, lopt)):
            train_step(m, o, low, high, 1.0, vgg, cfg)
    finally:
        torch.use_deterministic_algorithms(det[0])
        torch.backends.cudnn.deterministic = det[1]
    a, b = _state(model), _state(loaded)
    if all(torch.equal(a[k], b[k]) for k in a):
        held = "bitwise equal (torch.use_deterministic_algorithms + cudnn.deterministic)"
    else:
        held = ("not bitwise under torch.use_deterministic_algorithms; within the bar: "
                + lr_units("11c one step after the round trip", a, b, cfg.lr))
    log(f"11c save -> load of a base model 3 steps into training: parameters, Adam moments, "
        f"steps and lr bitwise equal; one more bf16 step from each on one batch: {held}")
    del model, loaded, opt, lopt
    record_c, _, _ = _train_cli(train_cli.main, argv_b + ["--nEpochs", "1", "--start_epoch", "2"],
                                kernels, 6, TRAIN_STEP["base"], "11c CLI resume")
    with np.load("weights/train/epoch_3.npz") as z:
        if int(z["opt::6"]) != 18 or int(z["meta::epoch"]) != 3:
            raise AssertionError(f"11c: resumed epoch_3.npz at Adam count {int(z['opt::6'])}")
    log(f"11c cli/train.py --start_epoch 2 from 11b's epoch_2.npz: one epoch, losses "
        f"{', '.join(f'{x:.4f}' for x in record_c['losses'][0])}, epoch_3.npz at Adam count 18")
    torch.cuda.empty_cache()

    # d. the training data pipeline with in-loop eval: a LOLv1 layout
    rng = np.random.default_rng(12)
    for sub, n in (("train/low", 16), ("eval/low", 4)):
        os.makedirs(f"lol/{sub}")
        os.makedirs(f"lol/{sub.replace('low', 'high')}")
        for i in range(n):
            img = synthetic_png(rng, H, W)
            png.write(f"lol/{sub}/{i:03d}.png", img)
            png.write(f"lol/{sub.replace('low', 'high')}/{i:03d}.png",
                      np.clip(img.astype(np.int32) * 3, 0, 255).astype(np.uint8))
    argv_d = ["--lol_v1", "true", "--lmot", "false", "--nEpochs", "1", "--snapshots", "1",
              "--batchSize", str(TRAIN_BATCH), "--cropSize", str(TRAIN_CROP),
              "--allow_random_vgg", "true", "--seed", "2", "--start_warmup", "false",
              "--variant", "base", "--data_train_lol_v1", "lol/train", "--data_val_lol_v1",
              "lol/eval/low", "--data_valgt_lol_v1", "lol/eval/high", "--val_folder", "results_d/"]
    reset(kernels)
    t0 = time.perf_counter()
    record_d, out = call_cli(train_cli.main, argv_d)
    seconds = time.perf_counter() - t0
    steps_d = sum(len(x) for x in record_d["losses"])
    written = sorted(os.listdir("results_d/LOLv1"))
    if steps_d != 485 // TRAIN_BATCH or len(written) != 4 or "Avg.PSNR" not in out:
        raise AssertionError(f"11d: {steps_d} steps, {len(written)} eval PNGs")
    if not all(p.dtype == torch.float32 for p in record_d["model"].parameters()):
        raise AssertionError("11d: the in-loop eval changed the trained model's dtype")
    log(f"11d LOLv1 layout (16 pairs at {W} x {H}, PNG), one epoch of the reference's 485 "
        f"samples: {steps_d} steps at crop {TRAIN_CROP} batch {TRAIN_BATCH} in {seconds:.2f} s "
        f"(in-loop eval of 4 images and scoring included); PSNR {record_d['psnr'][0]:.4f} dB, "
        f"SSIM {record_d['ssim'][0]:.4f}; the trained parameters still fp32")

    # e. cli/train_tnsm.py: two epochs of synthetic steps
    argv_e = ["--synthetic_steps", "3", "--nEpochs", "2", "--snapshots", "2", "--batchSize",
              str(TRAIN_BATCH), "--cropSize", str(TRAIN_CROP), "--allow_random_vgg", "true",
              "--start_warmup", "false", "--seed", "3", "--val_folder", "results_e/"]
    record_e, _, seconds = _train_cli(train_tnsm.main, argv_e, kernels, 6, TRAIN_STEP["tnsm"],
                                      "11e")
    tnsm_model = record_e["model"]
    low, high = (t.to(dev) for t in _train_batch(50, n=2))
    with torch.no_grad():
        tcfg = TrainConfig(model=tnsm_model.config, use_perceptual=False)
        with_noise = composite_loss(tnsm_model, low, high, 1.0, None, tcfg)[0].item()
        without = composite_loss(tnsm_model, low, high, 1.0, None,
                                 TrainConfig(model=tnsm_model.config, use_perceptual=False,
                                             tnsm_weight=0.0))[0].item()
    if tnsm_model.config.variant != "tnsm" or not with_noise > without:
        raise AssertionError(f"11e: TNSM loss {with_noise} vs {without} without the noise terms")
    log(f"11e cli/train_tnsm.py bf16 crop {TRAIN_CROP} batch {TRAIN_BATCH}: 6 steps in "
        f"{seconds:.2f} s; the noise terms add {with_noise - without:.4f} to the loss "
        f"({without:.4f} without); launches a step {TRAIN_STEP['tnsm']}")
    del record_e, tnsm_model
    torch.cuda.empty_cache()

    # f. remat and grad_accum 2 against the plain step, one step each from
    # one state on one batch (fp32, TF32 off)
    cfg_f = TrainConfig(model=CIDNetConfig(), use_perceptual=True, compute_dtype="float32")
    init = CIDNet(cfg_f.model, generator=torch.Generator().manual_seed(60))
    low, high = (t.to(dev) for t in _train_batch(61))
    results = {}
    for arm, kw in (("plain", {}), ("remat", {"remat": True}), ("grad_accum 2", {"grad_accum": 2})):
        c = TrainConfig(model=cfg_f.model, use_perceptual=True, compute_dtype="float32", **kw)
        m = copy.deepcopy(init).to(dev)
        o = make_optimizer(m, c)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = train_step(m, o, low, high, 1.0, vgg, c)
        torch.cuda.synchronize()
        results[arm] = (loss.item(), _state(m), torch.cuda.max_memory_allocated() / 2**30)
        del m, o
    base_loss, base_state, base_mem = results["plain"]
    lines = []
    for arm, tol in (("remat", TOL_REMAT_LOSS), ("grad_accum 2", TOL_ACCUM_LOSS)):
        loss, state, mem = results[arm]
        rel = abs(loss - base_loss) / abs(base_loss)
        if not rel <= tol:
            raise AssertionError(f"11f {arm}: loss {loss} vs {base_loss}, rel {rel:.2e}")
        lines.append(f"{arm}: loss rel {rel:.2e}, parameters "
                     f"{lr_units('11f ' + arm, state, base_state, cfg_f.lr)}, peak {mem:.2f} GiB")
    log(f"11f base fp32 batch {TRAIN_BATCH} crop {TRAIN_CROP}, one step from one state: plain peak "
        f"{base_mem:.2f} GiB; " + "; ".join(lines))
    del results, init
    torch.cuda.empty_cache()

    # g. information: the base train step's time and where it goes
    _train_step_info(dev, vgg, [attention_cuda, hvi_cuda, iel_cuda, norm_cuda, resize_cuda])
    return launched


def _twin_key(module: str, plain, inputs) -> str:
    """Which kernel a ``twin_backward`` call belongs to."""
    if module == "resize_cuda":
        return "K3" if plain.__name__ == "half_prelu_plain" else "K4"
    if module == "hvi_cuda":
        return "K1" if inputs[0].shape[-1] == 3 else "K2"  # K1 takes NHWC RGB
    return {"attention_cuda": "K5", "norm_cuda": "K6", "iel_cuda": "K7"}[module]


def _profile_step(dev, step, kernel_modules, step_ms: float) -> None:
    """Where a train step's time goes, as shares of ``step_ms`` (the step
    without instrumentation): CUDA-event spans around each kernel's
    ``twin_backward`` (its backward through the plain version's autograd:
    the stream's time from its first op to its last, device work and any
    wait for the host's launches) over 3 steps, then the profiler's device
    time by kernel over 3 more (the profiler slows the host, so the spans
    are taken without it)."""
    import re

    n_steps = 3
    spans = {k: [] for k in KERNEL_NAMES}
    originals = {m: m.twin_backward for m in kernel_modules}

    def timed(module):
        original, name = originals[module], module.__name__.rsplit(".", 1)[-1]

        def wrapper(plain, inputs, grad_output, needs_grad):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = original(plain, inputs, grad_output, needs_grad)
            end.record()
            spans[_twin_key(name, plain, inputs)].append((start, end))
            return out
        return wrapper

    for m in kernel_modules:
        m.twin_backward = timed(m)
    try:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    finally:
        for m in kernel_modules:
            m.twin_backward = originals[m]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    twin = {k: sum(s.elapsed_time(e) for s, e in v) / n_steps for k, v in spans.items()}
    by_kernel, busy = {}, 0.0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
        busy += t
        for key, pattern in KERNEL_NAMES.items():
            if re.search(pattern, ev.key):
                by_kernel[key] = by_kernel.get(key, 0.0) + t
    busy_ms = busy / 1000 / n_steps
    twin_ms = sum(twin.values())
    share = lambda ms: f"{ms:.2f} ms ({100 * ms / step_ms:.1f}%)"
    log(f"11g a base bf16 step at crop {TRAIN_CROP} batch {TRAIN_BATCH} ({step_ms:.2f} ms): "
        f"device kernels {share(busy_ms)} (profiler, 3 steps; "
        + ("no device time in the trace" if busy == 0 else "the rest idle")
        + f"); twin_backward (CUDA-event spans, 3 steps without the profiler) {share(twin_ms)}: "
        + ", ".join(f"{k} {share(v)}" for k, v in sorted(twin.items(), key=lambda kv: -kv[1]))
        + "; the forward kernels' device time: "
        + ", ".join(f"{k} {share(by_kernel.get(k, 0.0) / 1000 / n_steps)}" for k in KERNEL_NAMES))
    log("11g the profiler's table, the 15 longest by device time over the 3 steps:")
    log(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15,
                                  max_name_column_width=60))


def _train_step_info(dev, vgg, kernel_modules) -> None:
    """11g (information): the base train step's ms and images/s at crop 256,
    batch 8 and 16, with and without the perceptual term; peak memory; the
    perceptual term alone with TF32 off and on; where the step's time goes."""
    from hvi_cidnet_torch.losses.perceptual import perceptual_loss
    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig
    from hvi_cidnet_torch.ops.conv import exact_fp32
    from hvi_cidnet_torch.train.trainer import (
        PERCEPTUAL_LAYERS, TrainConfig, make_optimizer, train_step,
    )

    smi = nvidia_smi()
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, as a user's step runs
    try:
        step_ms = {}
        for batch in (8, 16):
            for perc in (True, False):
                cfg = TrainConfig(model=CIDNetConfig(), use_perceptual=perc)
                model = CIDNet(cfg.model, generator=torch.Generator().manual_seed(70)).to(dev)
                opt = make_optimizer(model, cfg)
                low, high = (t.to(dev) for t in _train_batch(71, n=batch))
                step = lambda: train_step(model, opt, low, high, 1.0, vgg if perc else None, cfg)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                ms = time_ms(step, iters=10, warmup=2)
                step_ms[batch, perc] = ms
                peak = torch.cuda.max_memory_allocated() / 2**30
                log(f"11g base train step bf16 crop {TRAIN_CROP} batch {batch}, perceptual "
                    f"{'on' if perc else 'off'}: {ms:.2f} ms ({ms / 1000:.4f} s), "
                    f"{1000 * batch / ms:.1f} images/s, peak {peak:.2f} GiB (first step "
                    f"{first:.2f} s); card {smi}")
                if (batch, perc) == (TRAIN_BATCH, True):
                    _profile_step(dev, step, kernel_modules, ms)
                del model, opt, step
        # the perceptual term alone on one space's shapes, forward and
        # backward, TF32 off (as the step runs it) and on, in turns
        x = torch.rand((TRAIN_BATCH, 3, TRAIN_CROP, TRAIN_CROP), device=dev, requires_grad=True)
        gt = torch.rand((TRAIN_BATCH, 3, TRAIN_CROP, TRAIN_CROP), device=dev)
        perc_ms = {True: [], False: []}
        for exact in (True, False, False, True):
            def term(exact=exact):
                with exact_fp32() if exact else contextlib.nullcontext():
                    perceptual_loss(vgg, x, gt, PERCEPTUAL_LAYERS, exact=exact)[0].backward()
            perc_ms[exact].append(time_ms(term, iters=5, warmup=1))
        off, on = (sum(perc_ms[e]) / 2 for e in (True, False))
        log(f"11g perceptual term (VGG19 to conv4_4 on {TRAIN_BATCH} x 3 x {TRAIN_CROP} x "
            f"{TRAIN_CROP} and its detached ground truth, forward + backward; in turns off / on / "
            f"on / off {', '.join(f'{t:.2f}' for t in (perc_ms[True][0], perc_ms[False][0], perc_ms[False][1], perc_ms[True][1]))} ms): "
            f"TF32 off {off:.2f} ms, on {on:.2f} ms ({off / on:.2f}x); a step runs it twice (RGB "
            f"and HVI); step with it minus without at batch 8: "
            f"{step_ms[TRAIN_BATCH, True] - step_ms[TRAIN_BATCH, False]:.2f} ms; card {smi}")
    finally:
        torch.backends.cudnn.allow_tf32 = saved


# step 12: scale-out on the card. The machine the script is written for has
# one card, so the replicas and ranks share cuda:0 (two replicas one after the
# other; two ranks on gloo, which NCCL's one-rank-a-device rule refuses);
# with two cards or more they take cuda:0 and cuda:1 (ranks on nccl).
DP_BATCH = 8
DP_REPLICAS = 2
# two ranks of 8 rows against one process of 16 (the global batch), crop 256,
# 2 epochs of 3 steps, the perceptual term on a seeded VGG19
DP_TRAIN = ["--synthetic_steps", "3", "--nEpochs", "2", "--snapshots", "1", "--batchSize", "16",
            "--cropSize", str(TRAIN_CROP), "--allow_random_vgg", "true", "--start_warmup",
            "false", "--seed", "1", "--variant", "base", "--threads", "4"]
DP_STEPS = 6
# 12c's epoch losses, two ranks against one process (fp32, TF32 off): the mean
# of two 8-row means against one 16-row mean, in another order
TOL_DP_LOSS = 1e-5
# a child of step 12: the train CLI in a fresh process with jax, PIL and cv2
# unimportable, the TF32 flags off as in this script, deterministic
# algorithms for "fp32"; it prints one RESULT line (launches, step start
# times, the record's losses on rank 0)
RANK_CHILD = ("import sys; sys.modules.update(jax=None, PIL=None, cv2=None); "
              "sys.path.insert(0, {root!r}); import chip_smoke; sys.exit(chip_smoke.rank_entry())")


def kernel_table() -> dict:
    """Every kernel's wrapper object, by key (the kernels line's order)."""
    from hvi_cidnet_torch.ops import (
        attention_cuda, batched_qk_cuda, conv3x3_cuda, head_attention_cuda, hvi_cuda, iel_cuda,
        im2col_cuda, ln_iel_cuda, norm_cuda, relayout_cuda, resize_cuda,
    )
    return {"K1": hvi_cuda.RGB_TO_HVI, "K2": hvi_cuda.HVI_TO_RGB,
            "K3": resize_cuda.HALF_PRELU, "K4": resize_cuda.DOUBLE,
            "K5": attention_cuda.ATTENTION, "K6": norm_cuda.LAYER_NORM,
            "K7": iel_cuda.IEL_BRANCH, "P2/P3": ln_iel_cuda.LN_IEL,
            "P4": conv3x3_cuda.CONV3X3, "P5": conv3x3_cuda.CONV3X3_HALF_PRELU,
            "P1": head_attention_cuda.HEAD_ATTENTION, "P6": im2col_cuda.IM2COL_DOTS,
            "P10/P15": batched_qk_cuda.BATCHED_QK, **relayout_cuda.KERNELS}


def rank_entry() -> int:
    """A child process of step 12 (``RANK_CHILD``): ``cli/train.py``'s
    ``main(argv)`` with the launches counted from 0 and each step's start
    time taken; argv[1] the CLI's argv as JSON, argv[2] "fp32"
    (deterministic algorithms) or "bf16"."""
    argv, mode = json.loads(sys.argv[1]), sys.argv[2]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if mode == "fp32":
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
    from hvi_cidnet_torch.cli import train as train_cli

    kernels = kernel_table()
    reset(kernels)
    starts = []
    step = train_cli.train_step

    def timed(*args, **kw):
        starts.append(time.perf_counter())
        return step(*args, **kw)

    train_cli.train_step = timed
    record = train_cli.main(argv)
    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
    print("RESULT " + json.dumps({"launches": counts(kernels), "starts": starts,
                                  "losses": record["losses"] if record else None,
                                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30
                                  if on_card else None}))
    return 0


def _child(argv: list, mode: str, workdir: str, name: str):
    """Start one train CLI process (``RANK_CHILD``) in ``workdir``."""
    os.makedirs(workdir, exist_ok=True)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    log_path = os.path.join(workdir, "stdout.txt")
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-c", RANK_CHILD.format(root=ROOT), json.dumps(argv), mode],
            cwd=workdir, env=env, stdout=out, stderr=subprocess.STDOUT, text=True)
    proc.name, proc.log_path = name, log_path
    return proc


def _wait(procs: list, timeout: float = 600) -> dict:
    """Wait for every child; any failure stops the others and raises. Returns
    name -> (stdout, RESULT dict)."""
    out = {}
    try:
        for p in procs:
            p.wait(timeout=timeout)
            with open(p.log_path) as f:
                text = f.read()
            if p.returncode != 0:
                raise AssertionError(f"12 {p.name}: exit {p.returncode}\n{text[-4000:]}")
            result = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
            out[p.name] = (text, json.loads(result[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _ranks(argv: list, mode: str, dirs: list, name: str) -> list:
    """``cli/train.py --multihost true`` as one child a directory."""
    from hvi_cidnet_torch.parallel.multihost import free_port

    port = free_port()
    return [_child(argv + ["--multihost", "true", "--coordinator_address", f"127.0.0.1:{port}",
                           "--num_processes", str(len(dirs)), "--process_id", str(r)],
                   mode, d, f"{name} rank {r}") for r, d in enumerate(dirs)]


def _digest_lines(text: str, what: str = "") -> list:
    return re.findall(rf"rank \d+: {what}.*state sha256 ([0-9a-f]+)", text)


def _step_ms(result: dict) -> float:
    """The median interval between consecutive step starts within an
    epoch (each step ends in the CLI's one host read of the loss)."""
    s = result["starts"]
    per = len(s) // 2
    gaps = [b - a for e in range(2) for a, b in zip(s[e * per:(e + 1) * per],
                                                    s[e * per + 1:(e + 1) * per])]
    return 1000 * float(np.median(gaps))


def _npz_params(path: str) -> dict:
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files if k.startswith("param::")}


def _file_digest(path: str) -> str:
    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig
    from hvi_cidnet_torch.train import checkpoint as ckpt
    from hvi_cidnet_torch.train.trainer import TrainConfig, make_optimizer

    model = CIDNet(CIDNetConfig(variant="base"))
    opt = make_optimizer(model, TrainConfig(model=model.config))
    ckpt.load_checkpoint(path, model, opt)
    return ckpt.state_digest(model, opt)


def scale_out_path(dev, kernels, smi: str) -> dict:
    """Step 12, with PIL, cv2 and jax unimportable, in a temporary
    directory. Returns the launches of 12a's base bf16 DP forward and of a
    DP train step per rank."""
    t0 = time.perf_counter()
    with without_modules("PIL", "cv2", "jax"), tempfile.TemporaryDirectory() as tmp, cwd(tmp):
        out = _scale_out_path(dev, kernels, smi, tmp)
    log(f"step 12 (scale-out) took {time.perf_counter() - t0:.1f} s; card {smi}")
    return out


def _scale_out_path(dev, kernels, smi: str, tmp: str) -> dict:
    from hvi_cidnet_torch.parallel.mesh import make_mesh

    cards = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(DP_REPLICAS)] if cards >= DP_REPLICAS
               else [dev] * DP_REPLICAS)
    mesh = make_mesh(devices=devices)
    where = "separate cards" if cards >= DP_REPLICAS else f"one card ({dev}, in turns)"
    serving = _dp_serving(dev, kernels, smi, mesh, where)
    # 12c's two fp32 ranks and its one process start next (a child takes
    # ~8 s to reach the card) and train while 12b and 12e's check run here;
    # the other children follow in waves small enough for the card's memory
    # (fp32 peaks: 15.2 GiB a rank of 8 rows, 22.3 a process of 16)
    fp32 = DP_TRAIN + ["--compute_dtype", "float32"]
    first = (_ranks(fp32, "fp32", [os.path.join(tmp, "r0"), os.path.join(tmp, "r1")], "12c")
             + [_child(fp32, "fp32", os.path.join(tmp, "single"), "12c one process")])
    try:
        _dp_eval(kernels, smi, mesh, where, cards, tmp)
        _async_checkpoints(dev)
        res = _wait(first)
    finally:
        for p in first:
            if p.poll() is None:
                p.kill()
                p.wait()
    per_step = _dp_training(res, smi, cards, where, tmp)
    return {"serving": serving, "train_step": per_step}


def _dp_serving(dev, kernels, smi: str, mesh, where: str) -> dict:
    """12a: dp_enhance_fn against Enhancer.enhance_batch on one replica.
    Returns the launches of base's bf16 batch."""
    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, HVIGates
    from hvi_cidnet_torch.parallel.inference import dp_enhance_fn
    from hvi_cidnet_torch.serve import Enhancer

    gates = HVIGates(gated=True, gated2=True, alpha=0.95, alpha_s=1.1)
    x = np.random.default_rng(12).uniform(0, 0.4, (DP_BATCH, H, W, 3)).astype(np.float32)
    launches = {}
    for variant in ("base", "tnsm"):
        tol_max, tol_mean, tol_bf16 = (
            (TOL_TNSM["max"], TOL_TNSM["mean"], TOL_TNSM["bf16_mean"]) if variant == "tnsm"
            else (TOL_FORWARD_MAX, TOL_FORWARD_MEAN, TOL_BF16_FORWARD_MEAN))
        model = CIDNet(CIDNetConfig(variant=variant), generator=torch.Generator().manual_seed(5))
        for dtype in (torch.float32, torch.bfloat16):
            one = Enhancer(copy.deepcopy(model), gates, gamma=0.8, compute_dtype=dtype,
                           device=dev)
            ref = one.enhance_batch(x)
            fn = dp_enhance_fn(mesh, model, gates, gamma=0.8, compute_dtype=dtype)
            fn(x)  # warm-up at the replicas' batch
            torch.cuda.synchronize()
            reset(kernels)
            got = fn(x)
            torch.cuda.synchronize()
            launched = counts(kernels)
            # the batch from host memory to its output on the card, in turns
            ms = {"one": [], "dp": []}
            for arm in ("one", "dp", "dp", "one"):
                run = (lambda: fn(x)) if arm == "dp" else (lambda: one._forward(x))
                ms[arm].append(time_ms(run, 3, 1))
            want = {k: DP_REPLICAS * v for k, v in PER_FORWARD[variant].items()}
            if launched != want:
                raise AssertionError(f"12a {variant} {dtype}: launches {launched} != {want}")
            got = got.cpu().numpy()
            if got.shape != x.shape or not np.isfinite(got).all():
                raise AssertionError(f"12a {variant} {dtype}: output {got.shape} bad")
            err, mean = float(np.abs(got - ref).max()), float(np.abs(got - ref).mean())
            if dtype == torch.float32:
                check(f"12a {variant} DP fp32 vs one replica", err, tol_max)
                check(f"12a {variant} DP fp32 vs one replica (mean)", mean, tol_mean)
            else:
                check(f"12a {variant} DP bf16 vs one replica (mean)", mean, tol_bf16)
            launches[variant, dtype] = launched
            log(f"12a {variant} dp_enhance_fn {str(dtype)[6:]} {DP_BATCH} x {H} x {W} over "
                f"{DP_REPLICAS} replicas on {where}: against Enhancer.enhance_batch on one "
                f"replica max_abs_err {err:.3e}, mean {mean:.3e}"
                f"{' (bitwise)' if np.array_equal(got, ref) else ''}; launches "
                f"{ {k: v for k, v in launched.items() if v} } (two batch-4 forwards); "
                f"{DP_BATCH} images from host memory to the card's output, in turns one / dp / "
                f"dp / one: {' / '.join(f'{t:.2f}' for t in (ms['one'][0], *ms['dp'], ms['one'][1]))}"
                f" ms (information); card {smi}")
        try:
            fn(x[:7])
        except ValueError as e:
            if "global batch 7 must be divisible by the 2-device mesh" not in str(e):
                raise
        else:
            raise AssertionError("12a: a batch of 7 over 2 replicas did not raise")
        del model, fn, one
    log("12a a batch of 7 over 2 replicas raises the JAX ValueError")
    torch.cuda.empty_cache()
    return launches["base", torch.bfloat16]


def _dp_eval(kernels, smi: str, mesh, where: str, cards: int, tmp: str) -> None:
    """12b: Evaluator(mesh=) over step 9's folder against the single-device
    eval CLI's fp32 PNGs (step 9's run, made again here)."""
    from hvi_cidnet_torch.cli import eval as eval_cli
    from hvi_cidnet_torch.compat.checkpoint import save_checkpoint
    from hvi_cidnet_torch.data import png
    from hvi_cidnet_torch.data.datasets import EvalDataset
    from hvi_cidnet_torch.eval.evaluator import Evaluator, gates_for_dataset
    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig

    rng = np.random.default_rng(9)
    src = os.path.join(tmp, "in")
    os.makedirs(src)
    for i, (h, w) in enumerate(EVAL_SIZES):
        png.write(os.path.join(src, f"{i:02d}_{w}x{h}.png"), synthetic_png(rng, h, w))
    npz = os.path.join(tmp, "base.npz")
    save_checkpoint(npz, CIDNet(CIDNetConfig(), generator=torch.Generator().manual_seed(0))
                    .state_dict())
    argv = ["--unpaired", "--custome", "--custome_path", src, "--weights", npz, "--variant",
            "base", "--eval_batch", str(EVAL_BATCH), "--dp"]
    os.makedirs("cli")
    with cwd("cli"):
        reset(kernels)
        text = run_cli(eval_cli.main, argv)
        chunks = counts(kernels)["K1"]  # one forward a chunk on one device
    if cards < 2 and "dp serving: single device, flag is a no-op" not in text:
        raise AssertionError("12b: cli/eval.py --dp on one card did not print the no-op line")
    ev = Evaluator(npz, CIDNetConfig(variant="base"), gates_for_dataset(unpaired=True),
                   compute_dtype=torch.float32, mesh=mesh)
    reset(kernels)
    t0 = time.perf_counter()
    n = ev.run_dataset(EvalDataset(src, pad=True), os.path.join(tmp, "dp_out"),
                       batch_size=EVAL_BATCH, verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counts(kernels)
    want = {k: DP_REPLICAS * chunks * v for k, v in PER_FORWARD["base"].items()}
    if n != len(EVAL_SIZES) or launched != want:
        raise AssertionError(f"12b: {n} images, launches {launched} != {want}")
    worst, equal, total = 0, 0, 0
    for name in sorted(os.listdir(src)):
        a = png.read(os.path.join("cli/output/custome", name)).astype(np.int16)
        b = png.read(os.path.join(tmp, "dp_out", name)).astype(np.int16)
        if a.shape != b.shape:
            raise AssertionError(f"12b {name}: {b.shape} against {a.shape}")
        worst = max(worst, int(np.abs(a - b).max()))
        equal, total = equal + int((a == b).sum()), total + a.size
    if worst > 1 or equal / total < 0.999:
        raise AssertionError(f"12b: DP eval PNGs {worst} levels off, {equal / total:.5f} equal")
    log(f"12b Evaluator(mesh=) fp32 over {DP_REPLICAS} replicas on {where}, step 9's folder "
        f"({len(EVAL_SIZES)} PNGs, {chunks} chunks, the sliver and a partial chunk among them): "
        f"within {worst} uint8 level of cli/eval.py's single-device PNGs, {equal / total:.5f} "
        f"of values equal; {seconds:.2f} s; launches two replicas' forwards a chunk; "
        f"cli/eval.py --dp on {cards} card(s) printed "
        f"{'the no-op line' if cards < 2 else 'its mesh'}; card {smi}")
    del ev
    torch.cuda.empty_cache()


def _async_checkpoints(dev) -> None:
    """12e, in this process: AsyncCheckpoints against the synchronous .npz."""
    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig
    from hvi_cidnet_torch.train import checkpoint as ckpt
    from hvi_cidnet_torch.train.async_ckpt import AsyncCheckpoints
    from hvi_cidnet_torch.train.trainer import TrainConfig, make_optimizer, train_step

    cfg = TrainConfig(model=CIDNetConfig(), use_perceptual=False)
    model = CIDNet(cfg.model, generator=torch.Generator().manual_seed(41)).to(dev)
    opt = make_optimizer(model, cfg)
    low, high = (t.to(dev) for t in _train_batch(44, n=2, hw=64))
    train_step(model, opt, low, high, 1.0, None, cfg)
    ckpt.save_checkpoint("sync.npz", model, opt, epoch=4)
    with AsyncCheckpoints("async", max_to_keep=1) as ck:
        ck.save(3, model, opt)
        ck.save(4, model, opt)
        ck.wait()
        kept = ck.epochs()
    with np.load("sync.npz") as a, np.load(os.path.join("async", "4", "checkpoint.npz")) as b:
        same = sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) for k in a.files)
    if not same or kept != [4]:
        raise AssertionError(f"12e: async checkpoint bitwise the synchronous one: {same}; "
                             f"kept {kept}")
    log("12e AsyncCheckpoints (max_to_keep 1) on the card: async/4/checkpoint.npz bitwise the "
        "synchronous .npz after wait(); epoch 3 dropped")


def _dp_training(res: dict, smi: str, cards: int, where: str, tmp: str) -> dict:
    """12c-12f from the children: ``res`` holds 12c's two ranks. Returns
    the launches of one step in a rank."""
    from hvi_cidnet_torch.parallel.multihost import free_port

    fp32 = DP_TRAIN + ["--compute_dtype", "float32"]
    # 12d's one-process nccl world beside 12e's resume over two ranks (rank
    # 1 in a directory without epoch_2.npz: both take rank 0's)
    torch.cuda.empty_cache()
    second = [_child(fp32 + ["--multihost", "true", "--coordinator_address",
                             f"127.0.0.1:{free_port()}", "--num_processes", "1",
                             "--process_id", "0"], "fp32", os.path.join(tmp, "nccl1"), "12d")]
    second += _ranks(fp32 + ["--start_epoch", "2", "--nEpochs", "1"], "fp32",
                     [os.path.join(tmp, "r0"), os.path.join(tmp, "resume1")], "12e")
    both = _wait(second)
    res["12d"] = both.pop("12d")
    resume = both
    r0, r1 = res["12c rank 0"], res["12c rank 1"]
    single, nccl1 = res["12c one process"], res["12d"]
    backends = re.findall(r"backend (\w+) \(rule", r0[0] + r1[0])
    want_backend = "nccl" if cards >= 2 else "gloo"
    if backends != [want_backend] * 2:
        raise AssertionError(f"12c: backends {backends}, expected {want_backend} on both ranks")
    want = TRAIN_STEP["base"]
    for name, (_, result) in res.items():
        if result["launches"] != {k: DP_STEPS * v for k, v in want.items()}:
            raise AssertionError(f"12f {name}: launches {result['launches']} != {DP_STEPS} x "
                                 f"{want}")
    # a step's launches in rank 0, as this run counted them
    per_step = {k: v // DP_STEPS for k, v in r0[1]["launches"].items()}
    got_losses = [float(np.mean(e)) for e in r0[1]["losses"]]
    ref_losses = [float(np.mean(e)) for e in single[1]["losses"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got_losses, ref_losses))
    check("12c two ranks' epoch losses vs one process (relative)", rel, TOL_DP_LOSS)
    digests = _digest_lines(r0[0]) + _digest_lines(r1[0])
    if len(digests) != 2 or digests[0] != digests[1]:
        raise AssertionError(f"12c: the ranks' final states differ: {digests}")
    got = _npz_params(os.path.join(tmp, "r0/weights/train/epoch_2.npz"))
    ref = _npz_params(os.path.join(tmp, "single/weights/train/epoch_2.npz"))
    lr = 1e-4  # the CLI's default --lr
    diff = torch.cat([(got[k].double() - ref[k].double()).abs().flatten() for k in ref]) / lr
    mean, share, worst = diff.mean().item(), (diff > 0.1).double().mean().item(), diff.max().item()
    if not (mean <= LR_BARS["mean"] and share <= LR_BARS["share_past_0.1"]
            and worst <= LR_BARS["max"] * DP_STEPS):
        raise AssertionError(f"12c: final parameters mean {mean:.3e} lr, share past 0.1 lr "
                             f"{share:.3e}, max {worst:.3e} lr past {LR_BARS} a step")
    if os.path.exists(os.path.join(tmp, "r1/weights")):
        raise AssertionError("12c: rank 1 wrote checkpoints")
    log(f"12c cli/train.py --multihost true, 2 ranks ({backends[0]}) x 8 rows against one "
        f"process of 16, base fp32 (TF32 off, deterministic algorithms) crop {TRAIN_CROP}, 2 "
        f"epochs x 3 steps, perceptual on a seeded VGG19: epoch losses "
        f"{', '.join(f'{v:.7f}' for v in got_losses)} against "
        f"{', '.join(f'{v:.7f}' for v in ref_losses)} (worst relative {rel:.2e}); the ranks' "
        f"final states bitwise equal (sha256 {digests[0]}); final parameters against one "
        f"process: mean {mean:.3e} lr, share past 0.1 lr {share:.3e}, max {worst:.3e} lr; card "
        f"{smi}")
    nccl_backend = re.findall(r"backend (\w+) \(rule", nccl1[0])
    if nccl_backend != ["nccl"]:
        raise AssertionError(f"12d: the one-process world took {nccl_backend}, not nccl")
    if nccl1[1]["losses"] != single[1]["losses"]:
        raise AssertionError(f"12d: nccl world-of-one losses {nccl1[1]['losses']} != one "
                             f"process's {single[1]['losses']}")
    log(f"12d --multihost true --num_processes 1: backend nccl, loss and gradients all-reduced; "
        f"its {DP_STEPS} step losses bitwise those of the run without --multihost; card {smi}")
    if cards >= 2:
        two = _wait(_ranks(fp32, "fp32", [os.path.join(tmp, "n0"), os.path.join(tmp, "n1")],
                           "12d nccl"))
        both = re.findall(r"backend (\w+) \(rule", "".join(t for t, _ in two.values()))
        d2 = [d for t, _ in two.values() for d in _digest_lines(t)]
        if both != ["nccl"] * 2 or len(d2) != 2 or len(set(d2)) != 1:
            raise AssertionError(f"12d: two ranks on two cards: {both}, digests {d2}")
        log(f"12d two ranks on two cards with nccl: final states bitwise equal ({d2[0]})")
    else:
        log("12d two ranks on nccl need two cards: this machine has one (not run)")

    # 12e. the resume
    file_digest = _file_digest(os.path.join(tmp, "r0/weights/train/epoch_2.npz"))
    resumed = [_digest_lines(t, "resumed from") for t, _ in resume.values()]
    if resumed != [[file_digest]] * 2:
        raise AssertionError(f"12e: resumed states {resumed} != the file's {file_digest}")
    for name, (_, result) in resume.items():
        if result["launches"] != {k: 3 * v for k, v in per_step.items()}:
            raise AssertionError(f"12f {name}: launches {result['launches']} != 3 x {per_step}")
    log(f"12e --start_epoch 2 over 2 ranks, rank 1 in a directory without epoch_2.npz: both "
        f"resumed bitwise the file's state (sha256 {file_digest}) from rank 0's broadcast")

    # the bf16 step (information: with one card both ranks share it), the
    # async backend through the CLI, then one process
    bf16 = DP_TRAIN + ["--compute_dtype", "bfloat16"]
    timing = _wait(_ranks(bf16 + ["--ckpt_backend", "orbax", "--ckpt_keep", "1"], "bf16",
                          [os.path.join(tmp, "b0"), os.path.join(tmp, "b1")], "bf16"))
    one = _wait([_child(bf16, "bf16", os.path.join(tmp, "b_single"), "bf16 one process")])
    kept = sorted(os.listdir(os.path.join(tmp, "b0/weights/train/orbax")))
    async_digest = _file_digest(os.path.join(tmp, "b0/weights/train/orbax/2/checkpoint.npz"))
    ranks_digest = {d for t, _ in timing.values() for d in _digest_lines(t)}
    if kept != ["2"] or ranks_digest != {async_digest}:
        raise AssertionError(f"12e --ckpt_backend orbax: kept {kept}, file {async_digest}, "
                             f"ranks {ranks_digest}")
    for name, (_, result) in {**timing, **one}.items():
        if result["launches"] != {k: DP_STEPS * v for k, v in per_step.items()}:
            raise AssertionError(f"12f {name}: launches {result['launches']}")
    two_ms = [_step_ms(r) for _, r in timing.values()]
    one_ms = _step_ms(one["bf16 one process"][1])
    log(f"12e --ckpt_backend orbax --ckpt_keep 1 over 2 ranks: rank 0 wrote orbax/2/"
        f"checkpoint.npz in the background, bitwise the ranks' final state ({async_digest})")
    log(f"12c bf16 step (information; both ranks on {where}, so not a scaling figure): 2 ranks x "
        f"8 rows {two_ms[0]:.1f} / {two_ms[1]:.1f} ms a step, one process x 16 rows "
        f"{one_ms:.1f} ms (medians of the step intervals, crop {TRAIN_CROP}, perceptual on); "
        f"card {smi}")
    peaks = {name: round(r["peak_gib"], 1) for name, (_, r) in
             {**res, **resume, **timing, **one}.items()}
    log(f"12f launches a step in every rank and process of 12c-12e: {per_step}; peak GiB "
        f"{peaks}")
    return per_step


# step 13: spatial row sharding on the card. A LOL-Blur frame (1280 x 720)
# over 2 row shards (720 divides 16) and 4 (720 pads to 736), a (2, 2) mesh
# at 4 x 400 x 600; the card's devices repeated where there is one card
SPATIAL_FRAME = (720, 1280)
SPATIAL_DP_BATCH = 4
TNSM_ULP_FACTOR = 10  # TOL_TNSM sits at 9-12x its measured sensitivities
CLI_DEVICE: list = []  # the demo's device flags (none: the card)


@contextlib.contextmanager
def patched(module, name: str, wrap):
    """``module.name`` replaced by ``wrap(original)`` inside the block."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def plain_versions_forbidden():
    """Every kernel's plain version raises when it is handed a CUDA tensor
    inside the block (the spatial path must launch the kernels). Yields the
    plain versions themselves by name, for the checks."""
    from hvi_cidnet_torch.ops import (
        attention, attention_cuda, hvi_cuda, iel_cuda, norm_cuda, resize_cuda,
    )

    def forbid(name):
        def wrap(fn):
            def guarded(*args, **kw):
                if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                    raise AssertionError(f"{name} ran on the card")
                return fn(*args, **kw)
            return guarded
        return wrap

    sites = [(hvi_cuda, "rgb_to_hvi_plain"), (hvi_cuda, "hvi_to_rgb_plain"),
             (resize_cuda, "half_prelu_plain"), (resize_cuda, "double_bilinear_plain"),
             (attention_cuda, "channel_attention_plain"), (attention, "attention_partials"),
             (attention, "attention_from_partials"), (norm_cuda, "layer_norm_plain"),
             (iel_cuda, "iel_branch_plain")]
    plain = {name: getattr(module, name) for module, name in sites}
    with contextlib.ExitStack() as stack:
        for module, name in sites:
            stack.enter_context(patched(module, name, forbid(f"{module.__name__}.{name}")))
        yield plain


@contextlib.contextmanager
def band_capture(record: dict):
    """Record, by rank, in call order, what a sharded forward hands the
    kernels: ``record[key][rank]`` lists (args, output) of every K3, K4 and
    K7 launch on a band ("K3", "K4", "K7"), of every call of the layers'
    dispatchers ("K3 site", "K4 site", "K7 site": the shard's own rows),
    of K5's split ("K5": q, k, v, temperature, heads, normalize_qk, w_proj
    and the output; "K5 scores": its partials; "K5 A": the rows pass's A)
    and TNSM's pools ("pools": x and the (mean, max) every shard uses)."""
    from hvi_cidnet_torch.models import layers, tnsm
    from hvi_cidnet_torch.ops import attention_cuda, iel_cuda, resize_cuda
    from hvi_cidnet_torch.parallel import rows

    def keep(key, pick=lambda args, kw, out: (args, out)):
        def wrap(fn):
            def recorded(*args, **kw):
                out = fn(*args, **kw)
                shard = rows.current()
                if shard is not None:
                    record.setdefault(key, {}).setdefault(shard.rank, []).append(
                        pick(args, kw, out))
                return out
            return recorded
        return wrap

    def k5(args, kw, out):
        q, k, v, temp, heads = args[1:6]
        return (q, k, v, temp, heads, kw.get("normalize_qk", True), kw.get("w_proj")), out

    with patched(layers, "half_prelu", keep("K3 site")), \
            patched(layers, "double_bilinear", keep("K4 site")), \
            patched(layers, "iel_branch", keep("K7 site")), \
            patched(resize_cuda, "half_prelu_kernel", keep("K3")), \
            patched(resize_cuda, "double_bilinear_kernel", keep("K4")), \
            patched(iel_cuda, "iel_branch_kernel", keep("K7")), \
            patched(attention_cuda, "channel_attention_rows", keep("K5", k5)), \
            patched(attention_cuda, "attention_scores_kernel",
                    keep("K5 scores", lambda a, kw, out: out)), \
            patched(attention_cuda, "attention_rows_apply_kernel",
                    keep("K5 A", lambda a, kw, out: out[1])), \
            patched(tnsm, "global_pools",
                    keep("pools", lambda a, kw, out: (a[0], out))):
        yield


# K5's scores pass against its plain version: each entry of a shard's
# partial sums (its splits added in float64) within TOL_K5_PARTIALS of the
# Cauchy-Schwarz bound of that entry (|q_r| |k_c| for a score, the entry
# itself for a squared norm): an fp32 sum over up to 460,800 pixels in
# another order than the plain bmm's
TOL_K5_PARTIALS = 1e-5
# TNSM's pools: the mean over the whole frame within TOL_POOL of the mean of
# |x| (fp32: sums over the shards' rows in another order), in bf16 one ulp
# of the bf16 mean more; the max bitwise
TOL_POOL = 1e-6


def check_bands(record: dict, n: int, what: str, plain: dict) -> dict:
    """(d) on one sharded forward's ``record`` (``band_capture``):

    * K5's A bitwise equal on every shard at each site; the scores pass's
      partial sums against ``attention_partials`` on the shard's q and k
      (TOL_K5_PARTIALS); the rows and apply passes' output against
      ``attention_from_partials`` over the shards' plain partials on the
      CPU in fp32, at K5's bars (fp32 TOL_FP32["K5"], bf16 TOL_BF16_REL
      relative), and in fp32 A itself against ``partials_matrix``;
    * every K3, K4 and K7 launch on a band bitwise its plain version on the
      same band (K3 and K4 with the band's slice of the whole image's H
      taps), and each site's band outputs, stacked, bitwise the whole-plane
      kernel's on the shards' rows stacked;
    * TNSM's pools on every shard against the whole frame's;
    * planted faults, at the first site: a K5 gather that misses a shard, a
      score partial met one column off, a halo row of K4 and K7 one row
      off, K3's taps the band's own, a mean over one shard's rows: each
      must fail its check.

    Returns the sites checked by kernel and the largest errors."""
    from hvi_cidnet_torch.models import layers
    from hvi_cidnet_torch.models.tnsm import global_pools
    from hvi_cidnet_torch.ops import attention
    from hvi_cidnet_torch.ops.resize import axis_weights

    sites, worst = {}, {"K5 partials": 0.0, "K5 out": 0.0, "K5 A": 0.0, "pool mean": 0.0}
    a = record["K5 A"]
    for i in range(len(a[0])):
        for r in range(1, n):
            if not torch.equal(a[0][i], a[r][i]):
                raise AssertionError(f"{what}: K5 site {i}: shard {r}'s A differs from shard 0's")

    def partials_err(got, want, c, heads):
        """max over entries of |got - want| / the entry's Cauchy-Schwarz
        bound; ``got`` (B, S, stride) added over S in float64, ``want`` (B,
        1, stride)."""
        b, cp = want.shape[0], c // heads
        got, want = got.double().sum(1), want.double()[:, 0]
        sq_q, sq_k = want[:, c * cp:c * cp + c], want[:, c * cp + c:]
        bound = (sq_q.reshape(b, heads, cp, 1) * sq_k.reshape(b, heads, 1, cp)).sqrt()
        scale = torch.cat([bound.reshape(b, c * cp), sq_q, sq_k], dim=1).clamp_min(1e-30)
        return ((got - want).abs() / scale).max().item()

    for i in range(len(record["K5"][0])):
        calls = [record["K5"][r][i][0] for r in range(n)]
        q0, _, v0, temp, heads, norm, wp = calls[0]
        dt, c = v0.dtype, v0.shape[1]
        cpu = lambda t: None if t is None else t.cpu()
        parts = [plain["attention_partials"](cpu(q), cpu(k), heads) for q, k, *_ in calls]
        whole = torch.cat(parts, dim=1)
        for r in range(n):
            err = partials_err(record["K5 scores"][r][i].cpu(), parts[r], c, heads)
            worst["K5 partials"] = max(worst["K5 partials"], err)
            check(f"{what}: K5 site {i} shard {r} scores pass vs plain (relative to "
                  f"|q_r| |k_c|)", err, TOL_K5_PARTIALS)
            want = plain["attention_from_partials"](whole, cpu(calls[r][2]), cpu(temp), heads,
                                                    normalize_qk=norm, w_proj=cpu(wp))
            got = record["K5"][r][i][1].cpu()
            if dt == torch.float32:
                err = max_err(got, want)
                check(f"{what}: K5 site {i} shard {r} rows+apply vs the plain split", err,
                      TOL_FP32["K5"])
                mat = attention.partials_matrix(whole, cpu(temp), heads, normalize_qk=norm,
                                                w_proj=cpu(wp))
                got_a = a[r][i].view(torch.float32)[:mat.numel()].reshape(mat.shape).cpu()
                a_err = max_err(got_a, mat)
                check(f"{what}: K5 site {i} shard {r} A vs the plain split", a_err,
                      TOL_FP32["K5"])
                worst["K5 A"] = max(worst["K5 A"], a_err)
            else:
                err = rel_err(got, want)
                if not err <= TOL_BF16_REL:
                    raise AssertionError(f"{what}: K5 site {i} shard {r} rows+apply vs the plain "
                                         f"split: rel err {err:.3e} > {TOL_BF16_REL:.1e}")
            worst["K5 out"] = max(worst["K5 out"], err)
        if i == 0:  # planted faults: each must fail the check that holds the kernel
            missing = torch.cat([parts[0]] * n, dim=1)
            off = parts[1].clone()
            off[..., :c * c // heads] = off[..., :c * c // heads].roll(1, dims=-1)
            if partials_err(record["K5 scores"][1][0].cpu(), off, c, heads) <= TOL_K5_PARTIALS:
                raise AssertionError(f"{what}: K5 scores check passes a column-off partial")
            got = record["K5"][0][0][1].cpu()
            bar = TOL_FP32["K5"] if dt == torch.float32 else TOL_BF16_REL
            errors = {}
            for fault, (p, rows_v) in {"a gather missing shard 1": (missing, calls[0][2]),
                                       "the apply on shard 1's rows": (whole, calls[1][2])}.items():
                bad = plain["attention_from_partials"](p, cpu(rows_v), cpu(temp), heads,
                                                       normalize_qk=norm, w_proj=cpu(wp))
                errors[fault] = max_err(got, bad) if dt == torch.float32 else rel_err(got, bad)
            # a bf16 A rounds away what a missing shard changes in a near-uniform softmax
            # (random weights, q and k normalised): there it is information only
            must = [f for f in errors if dt == torch.float32 or not norm or "apply" in f]
            passed = [f for f in must if errors[f] <= bar]
            if passed:
                raise AssertionError(f"{what}: K5 rows+apply check passes a planted fault: "
                                     f"{passed[0]} ({errors[passed[0]]:.3e})")
            worst["K5 faults"] = errors
    sites["K5"] = len(a[0])

    # K3, K4, K7 launches on bands against their plain versions, bitwise
    for key, fn in (("K3", "half_prelu_plain"), ("K4", "double_bilinear_plain"),
                    ("K7", "iel_branch_plain")):
        for r in range(n):
            for j, (args, out) in enumerate(record[key][r]):
                check_equal(f"{what}: {key} launch {j} shard {r} on its band vs its plain "
                            f"version", out, plain[fn](*args))
        args, out = record[key][n - 1][0]
        band = args[0]
        if key == "K3":  # the band's own taps in place of the image's: the drift shows
            wrong = plain[fn](band, args[1], axis_weights("half", 2 * out.shape[-2], band.device))
        else:  # the first halo row one row off
            shifted = torch.cat([band[..., 1:2, :], band[..., 1:, :]], dim=-2)
            wrong = plain[fn](shifted, *args[1:])
        if torch.equal(wrong, out):
            raise AssertionError(f"{what}: {key}'s band check passes a planted fault")
    whole = {"K3": layers.half_prelu, "K4": layers.double_bilinear, "K7": layers.iel_branch}
    for key, fn in whole.items():
        calls = record[f"{key} site"]
        for i in range(len(calls[0])):
            args = [calls[r][i][0] for r in range(n)]
            planes = torch.cat([x[0] for x in args], dim=-2)
            got = torch.cat([calls[r][i][1] for r in range(n)], dim=-2)
            check_equal(f"{what}: {key} site {i}, bands vs the whole plane",
                        got, fn(planes, *args[0][1:]))
        sites[key] = len(calls[0])

    # TNSM's pools against the whole frame's
    pools = record.get("pools", {})
    for i in range(len(pools.get(0, []))):
        x = torch.cat([pools[r][i][0] for r in range(n)], dim=-2)
        avg, mx = global_pools(x)
        scale = x.float().abs().mean(dim=(2, 3), keepdim=True)
        for r in range(n):
            got_avg, got_mx = pools[r][i][1]
            err = (got_avg.float() - avg.float()).abs()
            bar = TOL_POOL * scale + (avg.float().abs() * 2.0**-7 if x.dtype == torch.bfloat16
                                      else 0.0)
            if not (err <= bar).all():
                raise AssertionError(f"{what}: TNSM pools site {i} shard {r}: mean off the whole "
                                     f"frame's by {err.max().item():.3e}")
            worst["pool mean"] = max(worst["pool mean"], (err / scale).max().item())
            check_equal(f"{what}: TNSM pools site {i} shard {r}: max vs the whole frame's",
                        got_mx, mx)
        if i == 0:  # the mean over one shard's rows only
            one = pools[0][i][0].float().mean(dim=(2, 3), keepdim=True)
            if ((one - avg.float()).abs() <= TOL_POOL * scale).all():
                raise AssertionError(f"{what}: the pools check passes a one-shard mean")
    sites["pools"] = len(pools.get(0, []))
    return sites, worst


def split_line(worst: dict) -> str:
    return (f"K5's split vs its plain split on the CPU: scores pass {worst['K5 partials']:.3e} "
            f"(relative to |q_r| |k_c|, bar {TOL_K5_PARTIALS:.0e}), rows+apply output "
            f"{worst['K5 out']:.3e}" + (f", A {worst['K5 A']:.3e}" if worst["K5 A"] else "")
            + "; planted faults at site 0: " + ", ".join(
                f"{k} {v:.3e}" for k, v in worst["K5 faults"].items()))


def pools_line(sites: dict, worst: dict) -> str:
    if not sites["pools"]:
        return ""
    return (f"; TNSM's pools at {sites['pools']} sites: max bitwise the whole frame's, mean "
            f"within {worst['pool mean']:.3e} of it (relative to the mean |x|)")


def spatial_path(dev, kernels, smi: str) -> dict:
    """Step 13, with PIL, cv2 and jax unimportable, in a temporary
    directory. Returns the launches of base's bf16 frame over 2 shards (K5:
    its split entries)."""
    t0 = time.perf_counter()
    with without_modules("PIL", "cv2", "jax"), tempfile.TemporaryDirectory() as tmp, cwd(tmp):
        out = _spatial_path(dev, kernels, smi, tmp)
    log(f"step 13 (spatial) took {time.perf_counter() - t0:.1f} s; card {smi}")
    return out


def _spatial_path(dev, kernels, smi: str, tmp: str) -> dict:
    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, HVIGates
    from hvi_cidnet_torch.ops import attention_cuda
    from hvi_cidnet_torch.parallel.inference import (
        dp_spatial_enhance_fn, pad_to_mesh, spatial_enhance_fn,
    )
    from hvi_cidnet_torch.parallel.mesh import make_mesh
    from hvi_cidnet_torch.serve import Enhancer

    cards = torch.cuda.device_count()

    def mesh(n, shape=None, axes=("spatial",)):
        devices = [torch.device("cuda", i) for i in range(n)] if cards >= n else [dev] * n
        return make_mesh(shape, axes, devices)

    where = lambda n: "separate cards" if cards >= n else f"one card ({dev}, in turns)"
    gates = HVIGates(gated=True, gated2=True, alpha=0.95, alpha_s=1.1)
    gamma = 0.8
    h, w = SPATIAL_FRAME
    x = np.random.default_rng(13).uniform(0, 0.4, (1, h, w, 3)).astype(np.float32)
    models = {v: CIDNet(CIDNetConfig(variant=v), generator=torch.Generator().manual_seed(13))
              for v in VARIANTS}
    split = {"scores": attention_cuda.ATTENTION_SCORES,
             "rows_apply": attention_cuda.ATTENTION_ROWS_APPLY}

    sensitivity = {}

    def bars(variant, n):
        if variant != "tnsm":
            return TOL_FORWARD_MAX, TOL_FORWARD_MEAN, TOL_BF16_FORWARD_MEAN
        # TNSM's softmax rows sum raw products over the level's pixels (230,400
        # at level 1 of this frame, 4x TOL_TNSM's largest frame): its bars at this frame
        # are TNSM_ULP_FACTOR x its own forward's change under a one-ulp input
        # change (tests/tnsm_sensitivity.py's measure), never below TOL_TNSM
        if n not in sensitivity:
            sensitivity[n] = ulp_sensitivity(models["tnsm"], n)
        s_max, s_mean = sensitivity[n]
        return (max(TOL_TNSM["max"], TNSM_ULP_FACTOR * s_max),
                max(TOL_TNSM["mean"], TNSM_ULP_FACTOR * s_mean), TOL_TNSM["bf16_mean"])

    def single(model, dtype, n, xs=x):
        """One device's forward of ``xs`` padded as n row shards pad it."""
        one = Enhancer(copy.deepcopy(model), gates, gamma=gamma, compute_dtype=dtype, device=dev)
        xp = pad_to_mesh(torch.from_numpy(xs), n)
        return torch.from_numpy(one.enhance_batch(xp.numpy())[:, :xs.shape[1], :xs.shape[2]])

    def ulp_sensitivity(model, n):
        """(max, mean) change of one device's fp32 forward of the frame when
        each input value moves one fp32 ulp, up or down at random."""
        flip = np.where(np.random.default_rng(16).random(x.shape) < 0.5, -1, 1).astype(np.float32)
        moved = (x + flip * np.spacing(x)).astype(np.float32)
        d = (single(model, torch.float32, n, moved) - single(model, torch.float32, n)).abs()
        log(f"13a/b tnsm fp32 frame padded for {n} shards, one device, input moved one ulp: "
            f"output max {d.max().item():.3e}, mean {d.mean().item():.3e}; card {smi}")
        return d.max().item(), d.mean().item()

    def compare(what, got, ref, variant, dtype, n):
        got = got.cpu()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{what}: {tuple(got.shape)} != {tuple(ref.shape)} or not finite")
        tol_max, tol_mean, tol_bf16 = bars(variant, n)
        err = (got - ref).abs()
        if dtype == torch.float32:
            check(f"{what} (max)", err.max().item(), tol_max)
            check(f"{what} (mean)", err.mean().item(), tol_mean)
            bar = f"bars {tol_max:.1e} / {tol_mean:.1e}"
        else:
            check(f"{what} (mean)", err.mean().item(), tol_bf16)
            bar = f"mean bar {tol_bf16:.1e}"
        return err.max().item(), err.mean().item(), bar

    launches = {}
    with plain_versions_forbidden() as plain:
        # (a) 2 shards, fp32 and bf16, each variant; (d) and (e) on each run
        for variant, model in models.items():
            for dtype in (torch.float32, torch.bfloat16):
                fn = spatial_enhance_fn(mesh(2), model, gates, gamma=gamma, compute_dtype=dtype)
                ref = single(model, dtype, 2)
                fn(x)  # warm-up
                torch.cuda.synchronize()
                reset(kernels)
                reset(split)
                record = {}
                with band_capture(record):
                    got = fn(x)
                torch.cuda.synchronize()
                count, count_split = counts(kernels), counts(split)
                errs = compare(f"13a {variant} {dtype} 2 shards vs one device", got, ref, variant,
                               dtype, 2)
                sites, worst = check_bands(record, 2, f"13d {variant} {dtype}", plain)
                del record
                want = {k: 2 * v for k, v in PER_FORWARD[variant].items()}
                want_split = want.pop("K5")
                if count != dict(want, K5=0) or count_split != {"scores": want_split,
                                                                 "rows_apply": want_split}:
                    raise AssertionError(f"13e {variant} {dtype}: launches {count}, K5 split "
                                         f"{count_split}; want two shards of {PER_FORWARD[variant]}"
                                         f" with K5 split")
                if variant == "base" and dtype == torch.bfloat16:
                    launches = dict(count, K5=count_split["scores"])
                log(f"13a {variant} {str(dtype)[6:]} 1x{h}x{w} over 2 shards ({where(2)}) vs one "
                    f"device: max {errs[0]:.3e}, mean {errs[1]:.3e} ({errs[2]}); 13d K5's A bitwise equal "
                    f"on both shards at {sites['K5']} sites, {split_line(worst)}; K3/K4/K7 "
                    f"launches bitwise their plain versions on their bands and the bands the "
                    f"whole plane at {sites['K3']}/{sites['K4']}/{sites['K7']} sites"
                    f"{pools_line(sites, worst)}; planted faults rejected; 13e launches a "
                    f"shard K1 {count['K1'] // 2}, K2 {count['K2'] // 2}, K3 {count['K3'] // 2}, "
                    f"K4 {count['K4'] // 2}, K5 {count_split['scores'] // 2} (split; one-call "
                    f"{count['K5']}), K6 {count['K6'] // 2}, K7 {count['K7'] // 2}; card {smi}")
        # (b) 4 shards: 720 pads to 736 and is cropped back
        for variant, model in models.items():
            fn = spatial_enhance_fn(mesh(4), model, gates, gamma=gamma)
            record = {}
            with band_capture(record):
                got = fn(x)
            errs = compare(f"13b {variant} fp32 4 shards vs one device", got,
                           single(model, torch.float32, 4), variant, torch.float32, 4)
            sites, worst = check_bands(record, 4, f"13b/d {variant} fp32 4 shards", plain)
            del record
            log(f"13b {variant} fp32 1x{h}x{w} (padded to {-(-h // 32) * 32} rows) "
                f"over 4 shards ({where(4)}) vs one device: max {errs[0]:.3e}, mean {errs[1]:.3e} ({errs[2]}); "
                f"A equal on 4 shards at {sites['K5']} sites, {split_line(worst)}; bands bitwise"
                f"{pools_line(sites, worst)}; card {smi}")
        # (c) a (2, 2) mesh at 4 x 400 x 600, base
        xb = np.random.default_rng(14).uniform(0, 0.4, (SPATIAL_DP_BATCH, H, W, 3)).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            fn = dp_spatial_enhance_fn(mesh(4, (2, 2), ("data", "spatial")), models["base"], gates,
                                       gamma=gamma, compute_dtype=dtype)
            errs = compare(f"13c base {dtype} (2, 2) mesh vs one device", fn(xb),
                           single(models["base"], dtype, 2, xb), "base", dtype, 2)
            log(f"13c dp_spatial_enhance_fn base {str(dtype)[6:]} {SPATIAL_DP_BATCH}x{H}x{W} on a "
                f"(2, 2) mesh ({where(4)}) vs one device: max {errs[0]:.3e}, mean {errs[1]:.3e} ({errs[2]}); "
                f"card {smi}")
        try:
            fn(xb[:3])
            raise AssertionError("13c: a batch of 3 on the (2, 2) mesh did not raise")
        except ValueError as e:
            if "must be divisible by the 2-way 'data' axis" not in str(e):
                raise
        # (f) demo --spatial on the visible cards
        _spatial_demo(cards, smi, tmp)
    # (g) times in turns (information)
    _spatial_times(dev, models["base"], mesh, gates, gamma, x, smi, where)
    return launches


def _spatial_demo(cards: int, smi: str, tmp: str) -> None:
    """13f: ``cli/demo.py --spatial --random_init`` against the same call
    without ``--spatial``: on one card the same PNG bytes (no effect), on
    several within one uint8 level."""
    from hvi_cidnet_torch.cli import demo
    from hvi_cidnet_torch.data import png

    img = (np.random.default_rng(15).uniform(0, 0.4, (H, W, 3)) * 255).astype(np.uint8)
    src = os.path.join(tmp, "frame.png")
    png.write(src, img)
    argv = ["--random_init", "--input", src] + CLI_DEVICE
    plain = run_cli(demo.main, argv + ["--output_dir", os.path.join(tmp, "plain")])
    out = run_cli(demo.main, argv + ["--spatial", "--output_dir", os.path.join(tmp, "spatial")])
    a, b = (png.read(os.path.join(tmp, d, "enhanced_frame.png")).astype(int)
            for d in ("plain", "spatial"))
    said = "spatial serving: rows sharded over" in out
    if cards == 1:
        if said or not np.array_equal(a, b):
            raise AssertionError("13f: --spatial on one card changed the output or sharded")
    elif not said or np.abs(a - b).max() > 1:
        raise AssertionError("13f: --spatial over the cards: not sharded, or off by > 1 level")
    log(f"13f cli/demo.py --spatial --random_init on {cards} card(s): "
        f"{'no effect, the same PNG' if cards == 1 else 'sharded, within one uint8 level'}; "
        f"plain run printed {len(plain.splitlines())} lines; card {smi}")


def _spatial_times(dev, model, mesh, gates, gamma, x, smi: str, where) -> None:
    """13g: ms of the frame over 2 and 4 shards against one device's forward
    of the same padded frame (720 rows for 2 shards, 736 for 4), bf16, in
    turns; where the host's time goes over 1, 2 and 4 shards and one
    device (``_host_split``); the device time of the concatenation kernels
    (the halo bands) beside one device's."""
    from hvi_cidnet_torch.parallel.inference import pad_to_mesh, spatial_enhance_fn
    from hvi_cidnet_torch.serve import Enhancer

    bf = torch.bfloat16
    one = Enhancer(copy.deepcopy(model), gates, gamma=gamma, compute_dtype=bf, device=dev)
    frame = {n: spatial_enhance_fn(mesh(n), model, gates, gamma=gamma, compute_dtype=bf)
             for n in (2, 4)}
    padded = {n: pad_to_mesh(torch.from_numpy(x), n) for n in (2, 4)}
    fns = {"one 720": lambda: one._forward(padded[2]), "2 shards": lambda: frame[2](x),
           "one 736": lambda: one._forward(padded[4]), "4 shards": lambda: frame[4](x)}
    ms = {k: [] for k in fns}
    with torch.no_grad():
        for k in ("one 720", "2 shards", "one 736", "4 shards", "4 shards", "one 736", "2 shards",
                  "one 720"):
            ms[k].append(time_ms(fns[k], iters=5, warmup=2))
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"13g base bf16 frame {SPATIAL_FRAME[1]}x{SPATIAL_FRAME[0]}: 2 shards "
        f"{mean['2 shards']:.3f} ms against one device {mean['one 720']:.3f} ms ({where(2)}), "
        f"4 shards {mean['4 shards']:.3f} ms against one device at 736 rows "
        f"{mean['one 736']:.3f} ms ({where(4)}); in turns {ms}; card {smi}")
    # the shards' threads hand the interpreter lock to each other at every
    # exchange: the same frames with the lock's switch interval at 10 us
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with torch.no_grad():
            fast = {k: time_ms(fns[k], iters=5, warmup=2) for k in ("2 shards", "4 shards")}
    finally:
        sys.setswitchinterval(interval)
    log(f"13g the same with the interpreter's switch interval at 10 us (default "
        f"{interval * 1e3:g} ms): 2 shards {fast['2 shards']:.3f} ms, 4 shards "
        f"{fast['4 shards']:.3f} ms; card {smi}")
    frames = {"1 shard": spatial_enhance_fn(mesh(1), model, gates, gamma=gamma, compute_dtype=bf),
              "2 shards": frame[2], "4 shards": frame[4]}
    with torch.no_grad():
        host = {k: _host_split(f, x) for k, f in frames.items()}
        host["one device"] = _host_split(fns["one 720"], None)
        # the same forward on a new host thread each frame, as the row
        # group's shards run (cuDNN keeps its execution plans per thread)
        host["one device, a new thread a frame"] = _host_split(
            lambda: in_new_thread(fns["one 720"]), None)
    for k, v in host.items():
        per = v["threads"]
        log(f"13g host, base bf16 frame, {k}: {v['wall']:.3f} ms a frame on the host's clock; "
            f"each of its {per} thread(s) in the forward {v['forward']:.3f} ms, of it on the "
            f"CPU {v['cpu']:.3f} ms, in {v['exchanges']:.0f} row-group exchanges {v['exchange']:.3f}"
            f" ms (barrier waits), in halo assembly {v['extend']:.3f} ms (its exchanges "
            f"included), blocked otherwise (waiting for the interpreter lock or on the card) "
            f"{v['forward'] - v['cpu'] - v['exchange']:.3f} ms; profiler: the ops' own CPU time "
            f"{v['ops_ms']:.3f} ms over {v['op_calls']} op calls on {v['op_threads']} thread(s); "
            f"{', '.join(v['top'])}; card {smi}")
    cat_ms = {}
    for k in fns:
        torch.cuda.synchronize()
        with torch.no_grad(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fns[k]()
            torch.cuda.synchronize()
        total = cat = 0.0
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            t = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
            total += t
            cat += t if "cat" in ev.key.lower() else 0.0
        cat_ms[k] = (cat / 1000, total / 1000)
    if not cat_ms["one 720"][1]:
        log(f"13g device shares: not measured (the profiler saw no device time); card {smi}")
        return
    log("13g device time of one frame (profiler, kernels summed): " + "; ".join(
        f"{k} {t:.3f} ms, of it concatenation {c:.3f} ms ({100 * c / t:.1f}%)"
        for k, (c, t) in cat_ms.items()) + f"; card {smi}")


def in_new_thread(fn):
    """``fn()`` on a new host thread, joined."""
    out = []
    th = threading.Thread(target=lambda: out.append(fn()))
    th.start()
    th.join()
    return out[0]


def _host_split(fn, x) -> dict:
    """Where the host time of ``fn(x)`` (a sharded frame, or with ``x`` None
    one device's forward) goes, over 3 frames after one warm-up: the wall
    time a frame; each forward's thread: its wall and CPU time
    (``time.thread_time``), its row-group exchanges (count, time) and its
    halo assembly (``Shard.extend``); and one frame under
    ``torch.profiler`` (CPU activity): the ops' own CPU time summed, their
    calls, the threads they ran on, the three costliest ops."""
    from hvi_cidnet_torch.parallel import rows
    from hvi_cidnet_torch.serve import Enhancer

    run = (lambda: fn(x)) if x is not None else fn
    spent = {"forward": 0.0, "cpu": 0.0, "exchange": 0.0, "exchanges": 0, "extend": 0.0}
    forwards = []
    lock = threading.Lock()
    exchange, extend, forward = rows.RowGroup.exchange, rows.Shard.extend, Enhancer._forward

    def timed(fn, key, cpu=False):
        def call(*a, **kw):
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return fn(*a, **kw)
            finally:
                with lock:
                    spent[key] += time.perf_counter() - t0
                    if cpu:
                        spent["cpu"] += time.thread_time() - c0
                        forwards.append(1)
                    if key == "exchange":
                        spent["exchanges"] += 1
        return call

    run()
    torch.cuda.synchronize()
    frames = 3
    rows.RowGroup.exchange = timed(exchange, "exchange")
    rows.Shard.extend = timed(extend, "extend")
    Enhancer._forward = timed(forward, "forward", cpu=True)
    try:
        t0 = time.perf_counter()
        for _ in range(frames):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / frames
    finally:
        rows.RowGroup.exchange, rows.Shard.extend, Enhancer._forward = exchange, extend, forward
    calls = len(forwards)  # the threads' forwards over the frames
    per = {k: 1000 * v / calls if k != "exchanges" else v / calls for k, v in spent.items()}
    try:  # every thread's ops, where this torch can (else the caller's thread's)
        config = {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except (AttributeError, TypeError):
        config = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], **config) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if getattr(e, "device_type", None)
              == torch.autograd.DeviceType.CPU]
    own = {}
    for e in events:
        own[e.name] = own.get(e.name, 0.0) + e.self_cpu_time_total / 1000
    top = sorted(own.items(), key=lambda kv: -kv[1])[:3]
    return dict(per, wall=1000 * wall, threads=calls // frames, ops_ms=sum(own.values()),
                op_calls=len(events), op_threads=len({e.thread for e in events}),
                top=[f"{name} {ms:.3f} ms" for name, ms in top])


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

    kernels = kernel_table()
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
    compare_f2(dev, bf_models["base"])
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

    # requests through the serving entry point, each variant, on the
    # default route, the fused one and the probe one
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

    # batches packed as (H, W, 3, B) through the HWCB serving contract, each
    # variant (the default route)
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

    # the eval path: a dataset folder through the eval CLIs (K1-K7's
    # launches_eval in the kernels line are its bf16 runs', base, MSSA and TNSM)
    torch.cuda.empty_cache()
    served["eval"] = eval_path(dev, kernels)

    # the scoring path: the parity loop's eval on the default route (K1-K7's
    # launches in the kernels line are its; the eval path's beside them)
    torch.cuda.empty_cache()
    scoring = scoring_path(dev, kernels)

    # training (K1-K7's launches_train are 11b's)
    torch.cuda.empty_cache()
    trained = training_path(dev, kernels)

    # this slice's path: scale-out (launches_dp_serving: 12a's base bf16
    # batch over two replicas; launches_dp_train_step: a rank's step)
    torch.cuda.empty_cache()
    scaled = scale_out_path(dev, kernels, smi)

    # this slice's path: spatial row sharding (launches_spatial: 13a's base
    # bf16 frame over two shards, K5 its split entries)
    torch.cuda.empty_cache()
    spatial = spatial_path(dev, kernels, smi)

    path_of = lambda key: ("fused" if key in FUSED else "probe" if key in PROBE else
                           "hwcb" if key in RELAYOUTS else "eval")
    summary = [(summarise_relayout if key in RELAYOUTS else summarise)(
        key, results[key], served[path_of(key)]) for key in kernels]
    for key, line in zip(kernels, summary):
        if path_of(key) == "eval":
            line["launches_eval"] = line["launches"]
            line["launches"] = scoring[key]
        line["launches_train"] = trained[key]
        line["launches_dp_serving"] = scaled["serving"][key]
        line["launches_dp_train_step"] = scaled["train_step"][key]
        line["launches_spatial"] = spatial[key]
    log(smi)  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
