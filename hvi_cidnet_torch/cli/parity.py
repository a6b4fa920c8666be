"""Released-weights parity harness: convert -> eval -> measure -> diff.

The counterpart of ``cli/parity.py``. The reference's de-facto regression
test is re-running ``eval.py`` + ``measure.py`` against its released
``.pth`` files and comparing to the README metric table (reference
Readme.md:376-452, measure.py:73-163). The released weights and the
datasets are not part of the repository; this harness makes the proof one
command once a user supplies them:

    python -m hvi_cidnet_torch.cli.parity --weights_root /path/to/weights \\
        --datasets_root /path/to/datasets [--lpips_weights alex_lpips.pth] [--cpu]

For every case whose weight file AND dataset directory exist, it loads the
torch checkpoint, runs the port's evaluator with the case's published
gates (the ``cli/eval.py`` route table), scores the PNGs with the port's
measure harness, and diffs PSNR/SSIM (and LPIPS when weights are given)
against the BASELINE.md rows — pass/fail at +-0.1 dB PSNR (the
BASELINE.json north-star tolerance). The eval and LPIPS run on the card
unless ``--cpu`` is given.

``--dry_run`` exercises the ENTIRE loop on synthetic weights + a synthetic
2-image LOLv1 layout, then proves the gate fails on a perturbed expectation —
so the harness itself is verified end-to-end without the released files.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Dict, Optional, Tuple

PSNR_TOL = 0.1  # dB, BASELINE.json north star
SSIM_TOL = 0.005  # informational secondary gate
LPIPS_TOL = 0.005  # only gated when --lpips_weights is supplied


@dataclasses.dataclass(frozen=True)
class Case:
    """One README metric row family: a weight file evaluated on a dataset."""

    name: str
    eval_flags: Tuple[str, ...]  # cli/eval.py selector flags
    weights_rel: str  # under --weights_root (reference repo layout)
    eval_dir_rel: str  # under --datasets_root
    label_dir_rel: str
    # (gt_mean -> (psnr, ssim, lpips)); README rows, BASELINE.md
    expect: Dict[bool, Tuple[float, float, float]]


# Source for every expected tuple: BASELINE.md (extracted from the
# reference Readme.md:130-151). Keys of ``expect``: use_GT_mean.
CASES = [
    Case(
        "LOLv1 w_perc", ("lol", "perc"), "LOLv1/w_perc.pth",
        "LOLdataset/eval15/low", "LOLdataset/eval15/high",
        {False: (23.8091, 0.8574, 0.0856), True: (27.7146, 0.8760, 0.0791)},
    ),
    Case(
        "LOLv1 wo_perc", ("lol",), "LOLv1/wo_perc.pth",
        "LOLdataset/eval15/low", "LOLdataset/eval15/high",
        {False: (23.5000, 0.8703, 0.1053), True: (28.1405, 0.8887, 0.0988)},
    ),
    Case(
        "LOLv2-real best_GT_mean", ("lol_v2_real", "best_GT_mean"),
        "LOLv2_real/w_perc.pth",
        "LOLv2/Real_captured/Test/Low", "LOLv2/Real_captured/Test/Normal",
        {True: (28.1387, 0.8920, 0.1008)},
    ),
    Case(
        "LOLv2-real best_PSNR", ("lol_v2_real", "best_PSNR"),
        "LOLv2_real/best_PSNR.pth",
        "LOLv2/Real_captured/Test/Low", "LOLv2/Real_captured/Test/Normal",
        {False: (23.9040, 0.8656, 0.1219)},
    ),
    Case(
        "LOLv2-real best_SSIM", ("lol_v2_real", "best_SSIM"),
        "LOLv2_real/best_SSIM.pth",
        "LOLv2/Real_captured/Test/Low", "LOLv2/Real_captured/Test/Normal",
        {False: (23.8975, 0.8705, 0.1185), True: (28.3926, 0.8873, 0.1136)},
    ),
    Case(
        "LOLv2-syn w_perc", ("lol_v2_syn", "perc"), "LOLv2_syn/w_perc.pth",
        "LOLv2/Synthetic/Test/Low", "LOLv2/Synthetic/Test/Normal",
        {False: (25.1294, 0.9388, 0.0450), True: (29.3666, 0.9500, 0.0403)},
    ),
    Case(
        "LOLv2-syn wo_perc", ("lol_v2_syn",), "LOLv2_syn/wo_perc.pth",
        "LOLv2/Synthetic/Test/Low", "LOLv2/Synthetic/Test/Normal",
        {False: (25.7048, 0.9419, 0.0471), True: (29.5663, 0.9497, 0.0437)},
    ),
    Case(
        "SICE-Mix", ("SICE_mix",), "SICE.pth",
        "SICE/SICE_Mix", "SICE/SICE_Reshape",
        {True: (13.4235, 0.6360, 0.3624)},
    ),
    Case(
        "SICE-Grad", ("SICE_grad",), "SICE.pth",
        "SICE/SICE_Grad", "SICE/SICE_Reshape",
        {True: (13.4453, 0.6477, 0.3181)},
    ),
]


def run_case(
    case: Case,
    weights_path: str,
    eval_dir: str,
    label_dir: str,
    out_dir: str,
    *,
    lpips=None,
    expect_override: Optional[Dict[bool, Tuple[float, float, float]]] = None,
    tol: float = PSNR_TOL,
    eval_batch: int = 8,
    device="cuda",
):
    """Eval + measure one case; returns a list of per-row result dicts.
    ``lpips``: a ``metrics.lpips.LPIPS`` or None."""
    import torch

    from hvi_cidnet_torch.cli.eval import gates_of, parser as eval_parser, route
    from hvi_cidnet_torch.data.datasets import EvalDataset
    from hvi_cidnet_torch.eval.evaluator import Evaluator
    from hvi_cidnet_torch.eval.measure import metrics
    from hvi_cidnet_torch.models.cidnet import CIDNetConfig

    # drive the port's routing table (cli/eval.py), not a private copy:
    # the parity run must exercise the same gates/alpha the user's eval does
    ep = eval_parser().parse_args([f"--{f}" for f in case.eval_flags])
    _, _, _, alpha, pad = route(ep)
    # released .pth weights are the BASE graph (reference eval_SID_blur.py:7,
    # Readme.md released checkpoints)
    ev = Evaluator(
        weights_path, CIDNetConfig(variant="base"), gates_of(ep, alpha),
        gamma=ep.gamma, compute_dtype=torch.float32, device=device,
    )
    n = ev.run_dataset(EvalDataset(eval_dir, pad=pad), out_dir, verbose=False,
                       batch_size=eval_batch)
    rows = []
    expect = case.expect if expect_override is None else expect_override
    for gt_mean, (e_psnr, e_ssim, e_lpips) in sorted(expect.items()):
        psnr, ssim, lp = metrics(
            os.path.join(out_dir, "*.png"), label_dir, gt_mean, lpips=lpips, device=device,
        )
        ok = abs(psnr - e_psnr) <= tol
        rows.append({
            "case": case.name, "gt_mean": gt_mean, "images": n,
            "psnr": psnr, "ssim": ssim, "lpips": lp,
            "e_psnr": e_psnr, "e_ssim": e_ssim, "e_lpips": e_lpips,
            "d_psnr": psnr - e_psnr, "d_ssim": ssim - e_ssim,
            "pass": ok,
            "ssim_ok": abs(ssim - e_ssim) <= SSIM_TOL,
            "lpips_ok": (None if lp != lp or lpips is None
                         else abs(lp - e_lpips) <= LPIPS_TOL),
        })
    return rows


def render_report(rows, skipped) -> str:
    lines = [
        "# Released-weights parity report",
        "",
        f"PSNR gate: +-{PSNR_TOL} dB (BASELINE.json). SSIM/LPIPS columns are "
        f"informational (+-{SSIM_TOL}/{LPIPS_TOL}).",
        "",
        "| case | GT-mean | PSNR (got / ref / d) | SSIM (got / ref) | "
        "LPIPS (got / ref) | verdict |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        lp = "n/a" if r["lpips"] != r["lpips"] else f"{r['lpips']:.4f}"
        lines.append(
            f"| {r['case']} | {'yes' if r['gt_mean'] else 'no'} "
            f"| {r['psnr']:.4f} / {r['e_psnr']:.4f} / {r['d_psnr']:+.4f} "
            f"| {r['ssim']:.4f} / {r['e_ssim']:.4f} "
            f"| {lp} / {r['e_lpips']:.4f} "
            f"| {'PASS' if r['pass'] else 'FAIL'} |"
        )
    if skipped:
        lines += ["", "Skipped (missing weights or dataset):"]
        lines += [f"- {name}: {why}" for name, why in skipped]
    n_fail = sum(not r["pass"] for r in rows)
    lines += ["", f"{len(rows)} row(s) measured, {n_fail} FAILED, "
                  f"{len(skipped)} case(s) skipped."]
    return "\n".join(lines)


def gate_check(case: Case, weights_path: str, eval_dir: str, label_dir: str, out_dir: str,
               *, tol: float = PSNR_TOL, **kw):
    """The gate is live, not vacuously green: the case's measured values,
    adopted as its expectations, must PASS, and the same perturbed by 1 dB
    must FAIL. ``kw``: ``run_case``'s keywords. Returns the adopted rows."""
    rows = run_case(case, weights_path, eval_dir, label_dir, out_dir, tol=tol, **kw)
    adopted = {r["gt_mean"]: (r["psnr"], r["ssim"], 0.0) for r in rows}
    rows = run_case(case, weights_path, eval_dir, label_dir, out_dir,
                    expect_override=adopted, tol=tol, **kw)
    if not all(r["pass"] for r in rows):
        raise AssertionError(f"self-consistent rows must pass: {rows}")
    bad = {g: (p + 1.0, s, lp) for g, (p, s, lp) in adopted.items()}
    rows_bad = run_case(case, weights_path, eval_dir, label_dir, out_dir,
                        expect_override=bad, tol=tol, **kw)
    if any(r["pass"] for r in rows_bad):
        raise AssertionError(f"rows perturbed by 1 dB must fail: {rows_bad}")
    return rows


def dry_run(tol: float, device="cuda") -> int:
    """Prove the harness end-to-end on synthetic weights + data.

    1. Random base-CIDNet weights (a generator seeded 0) written as a torch
       ``.pth`` (``compat/checkpoint.export_pth``), a 2-image synthetic
       LOLv1 layout written by ``data/png.py``.
    2. ``gate_check``: the full convert->eval->measure loop; expectations
       set to the measured values -> every row must PASS; perturbed by
       1 dB -> every row must FAIL.
    """
    import numpy as np
    import torch

    from hvi_cidnet_torch.compat.checkpoint import export_pth
    from hvi_cidnet_torch.data import png
    from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig

    case = next(c for c in CASES if c.name == "LOLv1 wo_perc")
    with tempfile.TemporaryDirectory() as root:
        wpath = os.path.join(root, "weights", case.weights_rel)
        model = CIDNet(CIDNetConfig(variant="base"), generator=torch.Generator().manual_seed(0))
        export_pth(wpath, model.state_dict())
        low_dir = os.path.join(root, "datasets", case.eval_dir_rel)
        high_dir = os.path.join(root, "datasets", case.label_dir_rel)
        os.makedirs(low_dir), os.makedirs(high_dir)
        rng = np.random.default_rng(0)
        for i in range(2):
            lo = (rng.uniform(0, 0.3, (48, 64, 3)) * 255).astype(np.uint8)
            hi = np.clip(lo.astype(np.int32) * 3, 0, 255).astype(np.uint8)
            png.write(os.path.join(low_dir, f"{i}.png"), lo)
            png.write(os.path.join(high_dir, f"{i}.png"), hi)
        gate_check(case, wpath, low_dir, high_dir, os.path.join(root, "output"), tol=tol,
                   device=device)
    print("dry run OK: convert->eval->measure->diff loop verified; the "
          "PSNR gate passes on self-consistent values and fails at +1 dB")
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights_root", default="./weights",
                    help="reference-layout weights dir (LOLv1/w_perc.pth ...)")
    ap.add_argument("--datasets_root", default="./datasets")
    ap.add_argument("--out_root", default="./output/parity")
    ap.add_argument("--report", default="parity_report.md")
    ap.add_argument("--lpips_weights", default=None,
                    help="alexnet+lin LPIPS torch weights (optional; LPIPS "
                         "reports n/a without them)")
    ap.add_argument("--cases", default=None,
                    help="comma-separated case-name substrings to run")
    ap.add_argument("--tolerance", type=float, default=PSNR_TOL)
    ap.add_argument("--eval_batch", type=int, default=8)
    ap.add_argument("--dry_run", action="store_true",
                    help="verify the harness itself on synthetic weights+data")
    ap.add_argument("--cpu", action="store_true",
                    help="run the eval and LPIPS on the CPU instead of the GPU")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.dry_run:
        return dry_run(args.tolerance, device)

    lpips = None
    if args.lpips_weights:
        from hvi_cidnet_torch.metrics.lpips import load_lpips_torch

        lpips = load_lpips_torch(args.lpips_weights)

    rows, skipped = [], []
    for case in CASES:
        if args.cases and not any(
            s.strip().lower() in case.name.lower() for s in args.cases.split(",")
        ):
            continue
        wpath = os.path.join(args.weights_root, case.weights_rel)
        eval_dir = os.path.join(args.datasets_root, case.eval_dir_rel)
        label_dir = os.path.join(args.datasets_root, case.label_dir_rel)
        missing = [p for p in (wpath, eval_dir, label_dir) if not os.path.exists(p)]
        if missing:
            skipped.append((case.name, f"missing {', '.join(missing)}"))
            continue
        out_dir = os.path.join(
            args.out_root, case.name.replace(" ", "_").replace("/", "-")
        )
        print(f"== {case.name}: eval {eval_dir} with {wpath}")
        rows += run_case(
            case, wpath, eval_dir, label_dir, out_dir,
            lpips=lpips, tol=args.tolerance, eval_batch=args.eval_batch, device=device,
        )

    report = render_report(rows, skipped)
    with open(args.report, "w") as f:
        f.write(report + "\n")
    print(report)
    if not rows:
        print("\nno case was runnable — supply --weights_root/--datasets_root "
              "with the reference layout (see Readme.md:376-452)")
        return 2
    return 1 if any(not r["pass"] for r in rows) else 0


if __name__ == "__main__":
    raise SystemExit(main())
