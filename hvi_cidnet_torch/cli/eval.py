"""Batch inference over an eval set — the counterpart of ``cli/eval.py``
(reference eval.py).

    python -m hvi_cidnet_torch.cli.eval --lol [--perc] | --lol_v2_real
        [--best_GT_mean | --best_PSNR | --best_SSIM] | --lol_v2_syn |
        --SICE_grad | --SICE_mix | --lmot | --unpaired [--DICM | --LIME |
        --MEF | --NPE | --VV | --custome --custome_path DIR]
        [--weights FILE] [--variant base|mssa|tnsm] [--dtype float32|bfloat16]
        [--eval_batch 8] [--max_programs N] [--alpha 1.0] [--gamma 1.0] [--cpu]

The same flags and per-dataset weight, alpha and gate routing as the JAX
CLI (``route``, eval.py:85-171, with its deliberate ``--lol_v2_real``
default). Weights may be a ``.pth``, ``.npz`` (a bare state dict or the JAX
trainer's checkpoint), ``.safetensors`` or an HF folder. Runs on the card
unless ``--cpu`` is given. ``--compile_cache`` is accepted for the JAX
CLI's flag surface and does nothing: the port compiles nothing per shape.
``--dp`` serves each batch over every visible card (``make_mesh()``: one
replica a card, the rows split between them, ``Evaluator(mesh=)``); on
one card, or with ``--cpu``, it is a no-op and says so.
"""

from __future__ import annotations

import argparse
from typing import Union

import torch

from hvi_cidnet_torch.data.datasets import EvalDataset
from hvi_cidnet_torch.eval.evaluator import Evaluator, gates_for_dataset
from hvi_cidnet_torch.models.cidnet import VARIANTS, CIDNetConfig
from hvi_cidnet_torch.parallel.mesh import Mesh, make_mesh

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Eval")
    p.add_argument("--perc", action="store_true", help="use w_perc weights")
    p.add_argument("--lol", action="store_true")
    p.add_argument("--lol_v2_real", action="store_true")
    p.add_argument("--lol_v2_syn", action="store_true")
    p.add_argument("--SICE_grad", action="store_true")
    p.add_argument("--SICE_mix", action="store_true")
    p.add_argument("--lmot", action="store_true")
    p.add_argument("--best_GT_mean", action="store_true")
    p.add_argument("--best_PSNR", action="store_true")
    p.add_argument("--best_SSIM", action="store_true")
    p.add_argument("--custome", action="store_true")
    p.add_argument("--custome_path", type=str, default="./YOLO")
    p.add_argument("--unpaired", action="store_true")
    for d in ("DICM", "LIME", "MEF", "NPE", "VV"):
        p.add_argument(f"--{d}", action="store_true")
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--unpaired_weights", type=str, default="./weights/LOLv2_syn/w_perc.pth")
    p.add_argument("--weights", type=str, default=None, help="override weight path")
    p.add_argument("--variant", type=str, default="mssa", choices=list(VARIANTS))
    p.add_argument("--dtype", type=str, default="float32", choices=list(DTYPES))
    p.add_argument("--eval_batch", type=int, default=8, help="images per device batch")
    p.add_argument("--max_programs", type=int, default=None,
                   help="OPT-IN bound on distinct padded shapes for arbitrary-size "
                        "(unpaired/custom) sets. Default off: exact pad-to-x8, "
                        "reference-faithful values. A bound escalates the pad quantum, "
                        "which perturbs outputs inside the crop (channel attention "
                        "sees the padded pixels)")
    p.add_argument("--dp", action="store_true",
                   help="data-parallel eval: each batch split over every CUDA device "
                        "(a no-op on one)")
    p.add_argument("--compile_cache", type=str, default=None, metavar="DIR",
                   help="accepted for the JAX CLI's flag surface; does nothing here")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    return p


def route(ep):
    """Dataset -> (eval_dir, output_folder, weight_path, alpha, pad) table."""
    alpha, pad = None, False
    if ep.lol:
        eval_dir, out = "./datasets/LOLdataset/eval15/low", "./output/LOLv1/"
        weights = "./weights/LOLv1/w_perc.pth" if ep.perc else "./weights/LOLv1/wo_perc.pth"
    elif ep.lol_v2_real:
        eval_dir, out = "./datasets/LOLv2/Real_captured/Test/Low", "./output/LOLv2_real/"
        if ep.best_GT_mean:
            weights, alpha = "./weights/LOLv2_real/w_perc.pth", 0.84
        elif ep.best_PSNR:
            weights, alpha = "./weights/LOLv2_real/best_PSNR.pth", 0.8
        else:
            # DELIBERATE deviation: the reference crashes on --lol_v2_real
            # without a best_* flag (eval.py:107-117 leaves weight_path
            # undefined); the best_SSIM weights are the default instead
            if not ep.best_SSIM:
                print("note: --lol_v2_real without --best_GT_mean/--best_PSNR/"
                      "--best_SSIM defaults to the best_SSIM weights "
                      "(the reference errors here)")
            weights, alpha = "./weights/LOLv2_real/best_SSIM.pth", 0.82
    elif ep.lol_v2_syn:
        eval_dir, out = "./datasets/LOLv2/Synthetic/Test/Low", "./output/LOLv2_syn/"
        weights = "./weights/LOLv2_syn/w_perc.pth" if ep.perc else "./weights/LOLv2_syn/wo_perc.pth"
    elif ep.SICE_grad:
        eval_dir, out, weights, pad = "./datasets/SICE/SICE_Grad", "./output/SICE_grad/", "./weights/SICE.pth", True
    elif ep.SICE_mix:
        eval_dir, out, weights, pad = "./datasets/SICE/SICE_Mix", "./output/SICE_mix/", "./weights/SICE.pth", True
    elif ep.lmot:
        eval_dir, out = "./datasets/lmot_lol_val/img_dark_rgb", "./output/LMOT/"
        weights = "./weights/LMOT/w_perc.pth" if ep.perc else "./weights/LMOT/wo_perc.pth"
    elif ep.unpaired:
        pad = True
        for d in ("DICM", "LIME", "MEF", "NPE", "VV"):
            if getattr(ep, d):
                eval_dir, out = f"./datasets/{d}", f"./output/{d}/"
                break
        else:
            eval_dir, out = ep.custome_path, "./output/custome/"
        weights, alpha = ep.unpaired_weights, ep.alpha
    else:
        raise SystemExit("choose a dataset flag (--lol, --lol_v2_real, ... or --unpaired --DICM)")
    return eval_dir, out, weights, alpha, pad


def device_of(ep) -> Union[str, Mesh]:
    """The CLIs' device: the card unless ``--cpu``; with ``--dp`` and more
    than one CUDA device, the mesh of every visible card."""
    if ep.compile_cache:
        print("--compile_cache: no effect in the PyTorch port (nothing is compiled per shape)")
    device = "cpu" if ep.cpu else "cuda"
    if ep.dp:
        n = 0 if ep.cpu else torch.cuda.device_count()
        if n > 1:
            mesh = make_mesh()
            print(f"dp serving: batch sharded over {mesh.size} devices")
            return mesh
        print("dp serving: single device, flag is a no-op")
    return device


def placement(where: Union[str, Mesh]) -> dict:
    """``Evaluator``'s keywords for ``device_of``'s answer."""
    if isinstance(where, Mesh):
        return {"mesh": where}
    return {"device": where}


def gates_of(ep, alpha):
    return gates_for_dataset(
        lol=ep.lol, v2=ep.lol_v2_real, unpaired=ep.unpaired, lmot=ep.lmot,
        alpha=alpha if alpha is not None else 1.0,
    )


def main(argv=None) -> int:
    ep = parser().parse_args(argv)
    where = device_of(ep)
    eval_dir, out, weights, alpha, pad = route(ep)
    if ep.weights:
        weights = ep.weights
    gates = gates_of(ep, alpha)
    print(f"weights: {weights}\ngates: {gates}\noutput: {out}")
    ev = Evaluator(
        weights,
        CIDNetConfig(variant=ep.variant),
        gates,
        gamma=ep.gamma,
        compute_dtype=DTYPES[ep.dtype],
        **placement(where),
        # the bound is opt-in and only for arbitrary-size sets; paired sets
        # always keep the exact x8 pad, whatever the flag
        max_programs=ep.max_programs if (ep.unpaired or ep.custome) else None,
    )
    n = ev.run_dataset(EvalDataset(eval_dir, pad=pad), out, batch_size=ep.eval_batch)
    print(f"===> End evaluation ({n} images)")
    return n


if __name__ == "__main__":
    main()
