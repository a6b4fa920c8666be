"""Training configuration flags.

This package's own copy of ``hvi_cidnet_tpu/utils/config.py`` (that package
is not importable without jax): the reference's argparse config
(``data/options.py:3-81``), same flag names and defaults so commands
translate 1:1, with the JAX package's two fixes (boolean flags take
true/false strings; the dataset selector is validated up front) and its
additions (compute dtype, remat, gradient accumulation, synthetic smoke
mode, ...). Flags with no meaning here stay parseable, so a reference or
JAX command line runs unchanged: ``--gpu_mode`` and ``--compile_cache``
do nothing; ``--multihost true`` trains as one process of a
``torch.distributed`` group and ``--ckpt_backend orbax`` writes the
``.npz`` per epoch in the background (``train/async_ckpt.py``: the card has
no orbax). ``--cpu`` runs on the CPU; the default is the card.
"""

from __future__ import annotations

import argparse


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("yes", "true", "t", "1"):
        return True
    if str(v).lower() in ("no", "false", "f", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


DATASET_FLAGS = [
    "lol_v1",
    "lolv2_real",
    "lolv2_syn",
    "lol_blur",
    "SID",
    "SICE_mix",
    "SICE_grad",
    "lmot",
]


def option() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CIDNet (PyTorch, H100)")
    p.add_argument("--batchSize", type=int, default=16, help="training batch size")
    p.add_argument("--cropSize", type=int, default=256, help="image crop size (patch size)")
    p.add_argument("--nEpochs", type=int, default=1000)
    p.add_argument("--start_epoch", type=int, default=0, help=">0 resumes from weights/train/epoch_N")
    p.add_argument("--snapshots", type=int, default=10, help="checkpoint every N epochs")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--gpu_mode", type=str2bool, default=True)  # accepted, no effect
    p.add_argument("--shuffle", type=str2bool, default=True)
    p.add_argument("--threads", type=int, default=16, help="host data-pipeline threads")

    p.add_argument("--cos_restart_cyclic", type=str2bool, default=False)
    p.add_argument("--cos_restart", type=str2bool, default=True)
    p.add_argument("--warmup_epochs", type=int, default=3)
    p.add_argument("--start_warmup", type=str2bool, default=True)

    # train datasets
    p.add_argument("--data_train_lol_blur", type=str, default="./datasets/LOL_blur/train")
    p.add_argument("--data_train_lol_v1", type=str, default="./datasets/LOLdataset/our485")
    p.add_argument("--data_train_lolv2_real", type=str, default="./datasets/LOLv2/Real_captured/Train")
    p.add_argument("--data_train_lolv2_syn", type=str, default="./datasets/LOLv2/Synthetic/Train")
    p.add_argument("--data_train_SID", type=str, default="./datasets/Sony_total_dark/train")
    p.add_argument("--data_train_SICE", type=str, default="./datasets/SICE/Dataset/train")
    p.add_argument("--data_train_lmot_low", type=str, default="./datasets/LMOT_DARK_YOLO/images/train")
    p.add_argument("--data_train_lmot_high", type=str, default="./datasets/LMOT_YOLO/images/train")

    # validation input
    p.add_argument("--data_val_lol_blur", type=str, default="./datasets/LOL_blur/eval/low_blur")
    p.add_argument("--data_val_lol_v1", type=str, default="./datasets/LOLdataset/eval15/low")
    p.add_argument("--data_val_lolv2_real", type=str, default="./datasets/LOLv2/Real_captured/Test/Low")
    p.add_argument("--data_val_lolv2_syn", type=str, default="./datasets/LOLv2/Synthetic/Test/Low")
    p.add_argument("--data_val_SID", type=str, default="./datasets/Sony_total_dark/eval/short")
    p.add_argument("--data_val_SICE_mix", type=str, default="./datasets/SICE/Dataset/eval/test")
    p.add_argument("--data_val_SICE_grad", type=str, default="./datasets/SICE/Dataset/eval/test")
    p.add_argument("--data_val_lmot", type=str, default="./datasets/lmot_lol_val/img_dark_rgb")

    # validation ground truth
    p.add_argument("--data_valgt_lol_blur", type=str, default="./datasets/LOL_blur/eval/high_sharp_scaled/")
    p.add_argument("--data_valgt_lol_v1", type=str, default="./datasets/LOLdataset/eval15/high/")
    p.add_argument("--data_valgt_lolv2_real", type=str, default="./datasets/LOLv2/Real_captured/Test/Normal/")
    p.add_argument("--data_valgt_lolv2_syn", type=str, default="./datasets/LOLv2/Synthetic/Test/Normal/")
    p.add_argument("--data_valgt_SID", type=str, default="./datasets/Sony_total_dark/eval/long/")
    p.add_argument("--data_valgt_SICE_mix", type=str, default="./datasets/SICE/Dataset/eval/target/")
    p.add_argument("--data_valgt_SICE_grad", type=str, default="./datasets/SICE/Dataset/eval/target/")
    p.add_argument("--data_valgt_lmot", type=str, default="./datasets/lmot_lol_val/img_light_rgb/")

    p.add_argument("--val_folder", default="./results/", help="validation output location")

    # loss weights (options.py:56-61)
    p.add_argument("--HVI_weight", type=float, default=1.0)
    p.add_argument("--L1_weight", type=float, default=1.0)
    p.add_argument("--D_weight", type=float, default=0.5)
    p.add_argument("--E_weight", type=float, default=50.0)
    p.add_argument("--P_weight", type=float, default=1e-2)
    p.add_argument("--tnsm_weight", type=float, default=1.0)

    # random gamma augmentation (options.py:64-66)
    p.add_argument("--gamma", type=str2bool, default=False)
    p.add_argument("--start_gamma", type=int, default=60)
    p.add_argument("--end_gamma", type=int, default=120)

    # numeric failure detectors (options.py:69-70)
    p.add_argument("--grad_detect", type=str2bool, default=False, help="torch.autograd.set_detect_anomaly")
    p.add_argument("--grad_clip", type=str2bool, default=True)
    p.add_argument(
        "--grad_clip_faithful",
        type=str2bool,
        default=True,
        help="replicate the reference's clip-before-backward ordering (a no-op "
        "on applied gradients, train.py:68-73); false = real clipping",
    )

    # dataset selector (options.py:73-80; fork default --lmot=True)
    for name in DATASET_FLAGS:
        p.add_argument(f"--{name}", type=str2bool, default=(name == "lmot"))

    # --- the JAX package's additions ---
    p.add_argument("--variant", type=str, default="mssa", choices=["base", "mssa", "tnsm"],
                   help="model variant (the fork trains MSSA by default, train.py:10)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--remat", type=str2bool, default=False,
                   help="recompute the forward in the backward "
                        "(torch.utils.checkpoint): ~1 extra forward of FLOPs "
                        "for a much smaller live-activation footprint")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="split each batch into N equal microbatches, "
                        "sum their gradients, apply one optimizer update "
                        "on their mean: exact (all loss terms are batch "
                        "means), so the effective batch stays --batchSize "
                        "while live activations shrink by N; composes with "
                        "--remat")
    p.add_argument("--use_perceptual", type=str2bool, default=True)
    p.add_argument("--vgg_weights", type=str, default="experiments/pretrained_models/vgg19.pth",
                   help="local torchvision-format VGG19 weights for P_loss")
    p.add_argument("--allow_random_vgg", type=str2bool, default=False,
                   help="opt-in: train the perceptual loss against seeded-init "
                        "VGG19 when --vgg_weights is missing (smoke/tests only; "
                        "otherwise the perceptual term auto-disables loudly)")
    p.add_argument("--seed", type=int, default=-1, help="-1 = random (reference behavior)")
    p.add_argument("--synthetic_steps", type=int, default=0,
                   help=">0: train on synthetic data for N steps/epoch (smoke mode)")

    # ---- multi-process launch (the JAX package's; no reference twin: the
    # reference is single-GPU, train.py:34) ----
    p.add_argument("--multihost", type=str2bool, default=False,
                   help="train as one process of a torch.distributed group "
                        "(flags below or torchrun's environment); requires --seed")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0 (multihost)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="total process count (multihost; omit to autodetect)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's index (multihost; omit to autodetect)")

    p.add_argument("--ckpt_backend", type=str, default="npz", choices=["npz", "orbax"],
                   help="checkpoint format: npz (single file, the default); "
                        "orbax: the same .npz per epoch under weights/train/orbax/<epoch>/, "
                        "written in the background (the port has no orbax)")
    p.add_argument("--ckpt_keep", type=int, default=None,
                   help="orbax only: keep at most N checkpoints (default all)")

    p.add_argument("--compile_cache", type=str, default=None, metavar="DIR",
                   help="accepted for the JAX CLI's flag surface; does nothing here")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    return p


def selected_dataset(opt) -> str:
    """Validate exactly-one-selected and return its name."""
    chosen = [n for n in DATASET_FLAGS if getattr(opt, n)]
    if len(chosen) != 1:
        raise SystemExit(
            f"choose exactly one dataset flag, got {chosen or 'none'} "
            f"(pass e.g. --lol_v1 true --lmot false)"
        )
    return chosen[0]
