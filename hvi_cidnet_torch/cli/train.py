"""Training entry point: the counterpart of ``cli/train.py`` (reference
train.py / train_tnsm.py; ``--variant tnsm``, or ``cli/train_tnsm.py``,
for the TNSM trainer).

    python -m hvi_cidnet_torch.cli.train --lol_v1 true --lmot false --nEpochs 300 --batchSize 8
    python -m hvi_cidnet_torch.cli.train --synthetic_steps 4 --nEpochs 2 --snapshots 1 \\
        --variant base --allow_random_vgg true           # smoke; add --cpu off the card

One bf16 train step a batch on the card (``train/trainer.py``), the lr of
each epoch from the warmup + cosine-restart schedule, the gamma draws from
``random.Random(seed)``, a checkpoint every ``--snapshots`` epochs
(``./weights/train/epoch_N.npz``, the JAX trainer's format: ``--start_epoch
N`` resumes from it, or from a JAX trainer's file) with in-loop eval + PSNR
/ SSIM / LPIPS, the last batch's canary PNGs and a final markdown metrics
report (train.py:218-290). The in-loop eval gets a copy of the model:
``Evaluator`` takes over the model it is given and casts its conv weights.

Runs on the card unless ``--cpu``. ``--vgg_weights`` must name a local
torchvision ``vgg19.pth`` for the perceptual term; without one the term is
disabled loudly, or trained against a seeded VGG19 with
``--allow_random_vgg true`` (smoke runs only). Nothing is downloaded.

Data-parallel training (``parallel/multihost.py``; the JAX CLI's mesh and
``--multihost``): on a machine with several cards the command starts one
process per card (``launch``, through ``spawn_local``; ``main`` trains in
its own process); ``--multihost true`` makes this
process one rank of a ``torch.distributed`` group, from
``--coordinator_address`` / ``--num_processes`` / ``--process_id`` or from
torchrun's environment, and needs an explicit ``--seed`` when there is
more than one. Each rank decodes its rows of every global batch
(``--batchSize`` is global), the step mean-reduces the loss and the
gradients over the group (``train_step(group=)``), and process 0 alone
logs, writes the canaries, the checkpoints and the report and runs the
in-loop eval; a resume is read by process 0 and broadcast. Every rank
prints a digest of its final state. For example, two CPU ranks:

    python -m hvi_cidnet_torch.cli.train --cpu --multihost true --coordinator_address \\
        127.0.0.1:29500 --num_processes 2 --process_id {0,1} --seed 1 --synthetic_steps 2 ...
    torchrun --nproc_per_node 2 -m hvi_cidnet_torch.cli.train --multihost true --seed 1 ...
"""

from __future__ import annotations

import copy
import dataclasses
import os
import random
import sys
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from hvi_cidnet_torch.data import png
from hvi_cidnet_torch.data.datasets import EvalDataset, PairedFolderDataset, SceneFolderDataset
from hvi_cidnet_torch.data.pipeline import TrainLoader
from hvi_cidnet_torch.eval.evaluator import Evaluator, gates_for_dataset
from hvi_cidnet_torch.eval.measure import fmt_metric, metrics
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig
from hvi_cidnet_torch.parallel.multihost import (
    MultiHostTrainLoader,
    initialize_distributed,
    spawn_local,
)
from hvi_cidnet_torch.train.async_ckpt import AsyncCheckpoints
from hvi_cidnet_torch.train.checkpoint import (
    broadcast_state_,
    load_checkpoint,
    save_checkpoint,
    state_digest,
)
from hvi_cidnet_torch.train.schedule import build_reference_schedule
from hvi_cidnet_torch.train.trainer import (
    DTYPES,
    TrainConfig,
    check_dp_batch,
    make_optimizer,
    nonfinite_guard,
    set_learning_rate,
    train_step,
)
from hvi_cidnet_torch.utils.config import option, selected_dataset


class SyntheticDataset:
    """Random low/high pairs for smoke-training without corpora on disk."""

    def __init__(self, crop: int, steps: int, batch: int):
        self.crop = crop
        self._len = steps * batch

    def __len__(self):
        return self._len

    def sample(self, index, rng):
        low = rng.uniform(0, 0.3, (self.crop, self.crop, 3)).astype(np.float32)
        high = np.clip(low * 3.0 + rng.normal(0, 0.02, low.shape), 0, 1).astype(np.float32)
        return low, high


def build_train_dataset(opt, name: str):
    crop = opt.cropSize
    if name == "lol_v1":
        return PairedFolderDataset(opt.data_train_lol_v1 + "/low", opt.data_train_lol_v1 + "/high", crop, length=485)
    if name == "lolv2_real":
        return PairedFolderDataset(opt.data_train_lolv2_real + "/Low", opt.data_train_lolv2_real + "/Normal", crop, length=685)
    if name == "lolv2_syn":
        return PairedFolderDataset(opt.data_train_lolv2_syn + "/Low", opt.data_train_lolv2_syn + "/Normal", crop, length=900)
    if name == "lmot":
        return PairedFolderDataset(opt.data_train_lmot_low, opt.data_train_lmot_high, crop)
    if name == "lol_blur":
        return SceneFolderDataset(opt.data_train_lol_blur, "blur", crop)
    if name == "SID":
        return SceneFolderDataset(opt.data_train_SID, "sid", crop)
    return SceneFolderDataset(opt.data_train_SICE, "sice", crop)  # SICE_mix / SICE_grad


def build_val(opt, name: str):
    table = {
        "lol_v1": (opt.data_val_lol_v1, opt.data_valgt_lol_v1, "LOLv1/", False),
        "lolv2_real": (opt.data_val_lolv2_real, opt.data_valgt_lolv2_real, "LOLv2_real/", False),
        "lolv2_syn": (opt.data_val_lolv2_syn, opt.data_valgt_lolv2_syn, "LOLv2_syn/", False),
        "lol_blur": (opt.data_val_lol_blur, opt.data_valgt_lol_blur, "LOL_blur/", False),
        "SID": (opt.data_val_SID, opt.data_valgt_SID, "SID/", False),
        "SICE_mix": (opt.data_val_SICE_mix, opt.data_valgt_SICE_mix, "SICE_mix/", True),
        "SICE_grad": (opt.data_val_SICE_grad, opt.data_valgt_SICE_grad, "SICE_grad/", True),
        "lmot": (opt.data_val_lmot, opt.data_valgt_lmot, "LMOT/", False),
    }
    val_dir, gt_dir, folder, pad = table[name]
    return EvalDataset(val_dir, pad=pad), gt_dir, folder


def train_config(opt) -> TrainConfig:
    """The flags' ``TrainConfig`` (cli/train.py's mapping, grad-clip modes
    included)."""
    return TrainConfig(
        model=CIDNetConfig(variant=opt.variant),
        lr=opt.lr,
        hvi_weight=opt.HVI_weight,
        l1_weight=opt.L1_weight,
        d_weight=opt.D_weight,
        e_weight=opt.E_weight,
        p_weight=opt.P_weight,
        tnsm_weight=opt.tnsm_weight,
        use_perceptual=opt.use_perceptual,
        grad_clip_mode=("faithful" if (opt.grad_clip and opt.grad_clip_faithful)
                        else "clip" if opt.grad_clip else "none"),
        compute_dtype=opt.compute_dtype,
        gamma_aug=opt.gamma,
        start_gamma=opt.start_gamma,
        end_gamma=opt.end_gamma,
        remat=opt.remat,
        grad_accum=opt.grad_accum,
    )


def load_vgg(opt, tcfg: TrainConfig, device):
    """(VGG features or None, config): the local file, else the seeded
    stand-in when allowed, else the term disabled loudly (cli/train.py:226-242)."""
    if not opt.use_perceptual:
        return None, tcfg
    from hvi_cidnet_torch.losses.vgg import VGGFeatures, load_vgg_torch

    if os.path.exists(opt.vgg_weights):
        vgg = load_vgg_torch(opt.vgg_weights)
        print(f"perceptual loss: VGG19 weights from {opt.vgg_weights}")
    elif opt.allow_random_vgg:
        vgg = VGGFeatures(generator=torch.Generator().manual_seed(0))
        print("perceptual loss: WARNING — no local VGG19 weights found; "
              "using seeded init because --allow_random_vgg=true "
              "(NOT reference-comparable)")
    else:
        # a run that silently optimizes features of a random network
        # "succeeds" while training against noise
        print(f"perceptual loss: DISABLED — no VGG19 weights at "
              f"{opt.vgg_weights}; pass --vgg_weights or set "
              f"--allow_random_vgg=true to override")
        return None, dataclasses.replace(tcfg, use_perceptual=False)
    return vgg.to(device).eval().requires_grad_(False), tcfg


def _canary(path: str, img: torch.Tensor) -> None:
    png.write(path, (np.clip(img.float().cpu().numpy(), 0, 1) * 255).astype(np.uint8))


def _rank_main(rank: int, argv: list) -> None:
    """One process of ``spawn_local``'s group (torchrun's environment set)."""
    main(argv)


def _resume(opt, model, optimizer, ckpts, primary: bool, group) -> None:
    """Load ``--start_epoch``'s checkpoint on process 0 and, in a group, hand
    it to every rank (``broadcast_state_``): a rank whose working directory
    lacks the file resumes from the same bytes."""
    if ckpts is not None:
        path = ckpts.path(opt.start_epoch)
        if primary:
            ckpts.restore(opt.start_epoch, model, optimizer)
    else:
        path = f"./weights/train/epoch_{opt.start_epoch}.npz"
        if primary:
            load_checkpoint(path, model, optimizer)
    if group is None:
        print(f"resumed from {path}")
        return
    broadcast_state_(model, optimizer, src=0, group=group)
    print(f"===> rank {dist.get_rank()}: resumed from {path} (read by rank 0, broadcast): "
          f"state sha256 {state_digest(model, optimizer)}")


def launch(argv=None) -> Optional[dict]:
    """The command line's entry: ``main(argv)``, except that without
    ``--multihost`` and ``--cpu`` a machine with several cards trains in
    one process per card (``spawn_local``), as the JAX CLI uses every local
    chip; that returns None."""
    argv = list(sys.argv[1:] if argv is None else argv)
    opt = option().parse_args(argv)
    cards = 0 if opt.cpu else torch.cuda.device_count()
    if opt.multihost or cards <= 1:
        return main(argv)
    # the seed is drawn here so that every process draws the same
    seed = opt.seed if opt.seed >= 0 else random.randint(1, 1_000_000)
    print(f"===> data-parallel over {cards} devices: one process per card")
    spawn_local(cards, _rank_main, argv + ["--multihost", "true", "--seed", str(seed)])
    return None


def main(argv=None) -> Optional[dict]:
    """Train in this process (one rank with ``--multihost``); returns the
    run's record (on process 0 of a group; None on the others):
    ``losses`` (per epoch, per step; a group's mean), ``epochs``, ``psnr``
    / ``ssim`` / ``lpips`` per snapshot and ``model``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    opt = option().parse_args(argv)
    if opt.compile_cache:
        print("--compile_cache: no effect in the PyTorch port (nothing is compiled per shape)")

    group = info = None
    if opt.multihost:
        info = initialize_distributed(coordinator_address=opt.coordinator_address,
                                      num_processes=opt.num_processes,
                                      process_id=opt.process_id, cpu=opt.cpu)
        group = dist.group.WORLD
        device = info.device
    else:
        device = torch.device("cpu" if opt.cpu else "cuda")
    world = info.world if info is not None else 1
    multiproc = world > 1
    primary = info is None or info.rank == 0

    def log(*a, **k):
        if primary:
            print(*a, **k)

    seed = opt.seed if opt.seed >= 0 else random.randint(1, 1_000_000)
    if multiproc and opt.seed < 0:
        raise SystemExit(
            "multihost training requires an explicit --seed: every process "
            "must draw the same global batch order and augmentation stream"
        )
    log(f"===> seed {seed}")
    if multiproc:
        log(f"===> multihost: {world} processes, backend {info.backend}")

    synthetic = opt.synthetic_steps > 0
    ds_name = "synthetic" if synthetic else selected_dataset(opt)
    tcfg = train_config(opt)
    model_cfg = tcfg.model
    if group is not None:
        check_dp_batch(opt.batchSize, max(opt.grad_accum, 1), world)

    log("===> Loading datasets")
    if synthetic:
        train_set = SyntheticDataset(opt.cropSize, opt.synthetic_steps, opt.batchSize)
        val_set = gt_dir = out_folder = None
    else:
        train_set = build_train_dataset(opt, ds_name)
        val_set, gt_dir, out_folder = build_val(opt, ds_name)

    log("===> Building model")
    model = CIDNet(model_cfg, generator=torch.Generator().manual_seed(seed)).to(device)
    optimizer = make_optimizer(model, tcfg)
    ckpts = None
    if opt.ckpt_backend == "orbax":
        ckpts = AsyncCheckpoints("./weights/train/orbax", max_to_keep=opt.ckpt_keep)
        log("--ckpt_backend orbax: the card has no orbax; the port writes the JAX trainer's "
            ".npz per epoch, ./weights/train/orbax/<epoch>/checkpoint.npz, in the background "
            "(not an orbax tree)")
    start_epoch = 0
    if opt.start_epoch > 0:
        _resume(opt, model, optimizer, ckpts, primary, group if multiproc else None)
        start_epoch = opt.start_epoch

    vgg, tcfg = load_vgg(opt, tcfg, device)
    sched = build_reference_schedule(
        opt.lr,
        opt.nEpochs,
        start_epoch=start_epoch,
        warmup_epochs=opt.warmup_epochs,
        start_warmup=opt.start_warmup,
        cos_restart=opt.cos_restart,
        cos_restart_cyclic=opt.cos_restart_cyclic,
    )
    if group is not None:
        # every rank draws the same global batches and decodes its own rows
        loader = MultiHostTrainLoader(train_set, opt.batchSize, seed=seed,
                                      num_threads=opt.threads, shuffle=opt.shuffle, device=device)
    else:
        loader = TrainLoader(train_set, opt.batchSize, seed=seed, num_threads=opt.threads,
                             shuffle=opt.shuffle, device=device)

    host_rng = random.Random(seed)
    psnrs, ssims, lpipss = [], [], []
    record = {"losses": [], "epochs": []}
    if primary:
        os.makedirs(opt.val_folder, exist_ok=True)

    with torch.autograd.set_detect_anomaly(opt.grad_detect):
        for epoch in range(start_epoch + 1, opt.nEpochs + start_epoch + 1):
            set_learning_rate(optimizer, sched(epoch - 1))
            epoch_loss, n_batches, losses = 0.0, 0, []
            t0 = time.time()
            last_out = last_gt = None
            for low, high in loader.epoch():
                g = host_rng.randint(opt.start_gamma, opt.end_gamma) / 100.0 if opt.gamma else 1.0
                loss, out = train_step(model, optimizer, low, high, np.float32(g), vgg, tcfg,
                                       group=group)
                loss = float(loss)  # the step's one host read
                nonfinite_guard(loss, epoch, n_batches)
                losses.append(loss)
                epoch_loss += loss
                n_batches += 1
                last_out, last_gt = out, high
            dt = time.time() - t0
            record["losses"].append(losses)
            record["epochs"].append(epoch)
            log(
                f"===> Epoch[{epoch}]: Loss: {epoch_loss / max(n_batches, 1):.4f} || "
                f"lr={sched(epoch - 1):.3e} || {n_batches} steps in {dt:.1f}s"
            )
            # gradient-explosion canary images (train.py:84-89); process 0's
            # first row is the global batch's
            if last_out is not None and primary:
                canary_dir = os.path.join(opt.val_folder, "training")
                os.makedirs(canary_dir, exist_ok=True)
                _canary(os.path.join(canary_dir, "test.png"), last_out[0])
                _canary(os.path.join(canary_dir, "gt.png"), last_gt[0])

            snapshot = epoch % opt.snapshots == 0
            if snapshot and ckpts is not None:
                # every rank calls save (rank 0 writes, in the background)
                ckpts.save(epoch, model, optimizer)
                log(f"Checkpoint queued ({ckpts.path(epoch)})")
            if snapshot and primary:
                if ckpts is None:
                    ckpt = save_checkpoint(f"./weights/train/epoch_{epoch}.npz", model,
                                           optimizer, epoch)
                    log(f"Checkpoint saved to {ckpt}")
                if val_set is not None:
                    # the other ranks wait in the next step's all-reduce
                    gates = gates_for_dataset(
                        lol=opt.lol_v1, v2=opt.lolv2_real, lmot=opt.lmot, alpha=0.8
                    )
                    # a copy: Evaluator takes over the model it is given
                    # and casts its conv weights to the serving dtype
                    ev = Evaluator(copy.deepcopy(model), model_cfg, gates,
                                   compute_dtype=DTYPES[opt.compute_dtype], device=device)
                    out_dir = os.path.join(opt.val_folder, out_folder)
                    ev.run_dataset(val_set, out_dir)
                    del ev
                    avg_psnr, avg_ssim, avg_lpips = metrics(os.path.join(out_dir, "*.png"), gt_dir,
                                                            device=device)
                    log(f"===> Avg.PSNR: {avg_psnr:.4f} dB  SSIM: {avg_ssim:.4f}  "
                        f"LPIPS: {fmt_metric(avg_lpips)}")
                    psnrs.append(avg_psnr)
                    ssims.append(avg_ssim)
                    lpipss.append(avg_lpips)
    loader.close()
    if ckpts is not None:
        # every rank waits until the background writes are on disk
        ckpts.close()
        log("async checkpoints on disk")
    if group is not None:
        print(f"===> rank {info.rank}: state sha256 {state_digest(model, optimizer)}")
        if info.created:
            dist.destroy_process_group()
    if not primary:
        return None

    # final markdown report (train.py:276-290)
    report_dir = os.path.join(opt.val_folder, "training")
    os.makedirs(report_dir, exist_ok=True)
    now = datetime.now().strftime("%Y-%m-%d-%H%M%S")
    report = os.path.join(report_dir, f"metrics{now}.md")
    with open(report, "w") as f:
        f.write(f"dataset: {ds_name}\n")
        for k in ("lr", "batchSize", "cropSize", "HVI_weight", "L1_weight", "D_weight", "E_weight", "P_weight"):
            f.write(f"{k}: {getattr(opt, k)}\n")
        f.write("| Epochs | PSNR | SSIM | LPIPS |\n|---|---|---|---|\n")
        for i in range(len(psnrs)):
            f.write(f"| {start_epoch + (i + 1) * opt.snapshots} | {psnrs[i]:.4f} | {ssims[i]:.4f} | {fmt_metric(lpipss[i])} |\n")
    print("===> training done")
    record.update(psnr=psnrs, ssim=ssims, lpips=lpipss, model=model, report=report)
    return record


if __name__ == "__main__":
    launch()
