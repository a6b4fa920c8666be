"""The training step for the CIDNet family: composite loss, backward, Adam.

Counterpart of ``hvi_cidnet_tpu/train/trainer.py`` (reference
train.py:39-90, train_tnsm.py:37-103). One step: the forward (K1-K7 on the
card), both HVI re-projections of the output and the ground truth (K1, in
fp32), the composite loss, the backward, an Adam update. The step reads
nothing back to the host; the caller's one ``float(loss)`` a step is the
only sync (``cli/train.py``).

Loss recipe (train.py:63-65, options.py:56-61):
  loss = [L1 + SSIM(D_w) + Edge(E_w) + P_w * VGG-perc] on RGB
       + HVI_w * [same on HVI]
TNSM adds noise consistency + smoothing terms (train_tnsm.py:68-72).

Grad-clip fidelity note: the reference "clips" the *previous* step's
gradients before ``zero_grad``/``backward`` (train.py:68-73), a no-op on
what the optimizer applies. ``grad_clip_mode='faithful'`` reproduces that
(no clipping); ``'clip'`` applies real global-norm-0.01 clipping, optax's
``clip_by_global_norm`` written out (``torch.nn.utils.clip_grad_norm_``
scales by ``max_norm / (norm + 1e-6)``, 1e-4 relative off at this bound).

Precision: the master weights stay fp32; every conv casts its weight to
the activation dtype (``ops/conv.py``), so a bf16 forward needs no cast of
the model (``cast_conv_weights`` is for serving copies only). The step runs
inside ``exact_fp32`` (TF32 off, forward and backward): the loss's fp32
convs (blurs, VGG) are then the function the CPU tests pin, and the flags
do not touch the bf16 model's convs.

The kernels' backward is their plain versions' autograd (``twin_backward``
in ``ops/_build.py``), as the JAX ``custom_vjp``s run their XLA twins' VJPs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from hvi_cidnet_torch.losses.basic import edge_loss, l1_loss, ssim_loss
from hvi_cidnet_torch.losses.perceptual import perceptual_loss
from hvi_cidnet_torch.losses.vgg import VGGFeatures
from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, cidnet_forward
from hvi_cidnet_torch.ops.conv import exact_fp32
from hvi_cidnet_torch.ops.hvi_cuda import rgb_to_hvi

PERCEPTUAL_LAYERS = {"conv1_2": 1.0, "conv2_2": 1.0, "conv3_4": 1.0, "conv4_4": 1.0}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
CLIP_MODES = ("faithful", "clip", "none")
CLIP_NORM = 0.01  # train.py:69 max_norm
# optax.adam's defaults (b1, b2, eps, eps_root)
ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Mirrors the loss/optimizer flags of data/options.py:6-70."""

    model: CIDNetConfig = CIDNetConfig()
    lr: float = 1e-4
    hvi_weight: float = 1.0
    l1_weight: float = 1.0
    d_weight: float = 0.5
    e_weight: float = 50.0
    p_weight: float = 0.01
    tnsm_weight: float = 1.0
    use_perceptual: bool = True
    grad_clip_mode: str = "faithful"  # 'faithful' | 'clip' | 'none'
    compute_dtype: str = "bfloat16"
    # random-gamma augmentation (options.py:64-66)
    gamma_aug: bool = False
    start_gamma: int = 60
    end_gamma: int = 120
    # recompute the forward in the backward (torch.utils.checkpoint around
    # the model forward only, as jax.checkpoint wraps it): one more forward
    # of work for not keeping the UNet's activations live through the loss
    remat: bool = False
    # split the batch into this many equal microbatches, sum their
    # gradients, divide by the count and make one update: every loss term
    # is a batch mean, so this is the full batch's gradient up to float
    # reassociation, with live activations divided by the count
    grad_accum: int = 1


def f32(value: float) -> float:
    """``value`` as the float32 the JAX optimizer state holds (its
    hyperparameters are float32 arrays; set_learning_rate injects
    ``np.float32(lr)``): then torch's ``1 - beta2`` is optax's, bit for bit,
    and a checkpoint's lr reloads bit for bit."""
    return float(np.float32(value))


def make_optimizer(model: CIDNet, config: TrainConfig) -> torch.optim.Adam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, each as float32):
    ``torch.optim.Adam`` over every parameter, ``fused`` on the card (one
    multi-tensor kernel a step in place of a loop of small ones; the update
    is the same function) and the single-tensor loop on the CPU.

    Every parameter is given a zero gradient now, so one that a forward
    does not reach (base's ``I_LCA5``) is stepped with a zero gradient, as
    optax steps it: its moments decay and its count advances with the
    others', and a checkpoint holds moments for every parameter."""
    if config.grad_clip_mode not in CLIP_MODES:
        raise ValueError(f"grad_clip_mode {config.grad_clip_mode!r} is not one of {CLIP_MODES}")
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    on_card = all(p.is_cuda for p in params)
    return torch.optim.Adam(params, lr=f32(config.lr), betas=(f32(ADAM["b1"]), f32(ADAM["b2"])),
                            eps=f32(ADAM["eps"]), fused=on_card)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Per-epoch lr injection (the reference steps its scheduler per epoch)."""
    for group in optimizer.param_groups:
        group["lr"] = f32(lr)


def clip_by_global_norm_(grads, max_norm: float = CLIP_NORM) -> None:
    """optax ``clip_by_global_norm``: g <- g when ||g|| < max_norm, else
    (g / ||g||) * max_norm, over all gradients together; no host sync."""
    grads = list(grads)
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def composite_loss(
    model: CIDNet,
    low: torch.Tensor,
    high: torch.Tensor,
    gamma,
    vgg: Optional[VGGFeatures],
    config: TrainConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward + both-space composite loss of NHWC ``low`` / ``high``
    batches on the model's device. Returns (loss, aux)."""
    cdt = DTYPES[config.compute_dtype]
    tnsm = config.model.variant == "tnsm"
    x = (low ** gamma if config.gamma_aug else low).to(cdt)

    def fwd(x):
        return cidnet_forward(model, x, compute_dtype=cdt, training=True)

    out = checkpoint(fwd, x, use_reentrant=False) if config.remat else fwd(x)
    noise_map = None
    if tnsm:
        output_rgb, noise_map = out
    else:
        output_rgb = out
    with exact_fp32():
        output_rgb = output_rgb.float()
        gt_rgb = high.float()

        # Both HVI projections use the live density_k, like model.HVIT
        # (train.py:61-62): the gradient reaches k through both. K1, NCHW.
        k = model.trans.density_k
        output_hvi = rgb_to_hvi(output_rgb, k, torch.float32)
        gt_hvi = rgb_to_hvi(gt_rgb, k, torch.float32)

        def space_loss(a, b):
            loss = (
                l1_loss(a, b, loss_weight=config.l1_weight)
                + ssim_loss(a, b, weight=config.d_weight)
                + edge_loss(a, b, loss_weight=config.e_weight)
            )
            if config.use_perceptual and vgg is not None:
                loss = loss + config.p_weight * perceptual_loss(
                    vgg, a, b, PERCEPTUAL_LAYERS, criterion="mse")[0]
            return loss

        loss_hvi = space_loss(output_hvi, gt_hvi)
        loss_rgb = space_loss(output_rgb.permute(0, 3, 1, 2), gt_rgb.permute(0, 3, 1, 2))
        loss = loss_rgb + config.hvi_weight * loss_hvi

        if tnsm and noise_map is not None:
            # noise_consistency + TV smoothing (train_tnsm.py:68-72), NHWC
            resid = (output_rgb - low.float()).abs().mean(dim=-1, keepdim=True)
            target = 1.0 - torch.sigmoid(resid)
            nm = noise_map.float()
            consistency = (nm - target).abs().mean()
            smoothing = ((nm[:, :, :-1] - nm[:, :, 1:]).abs().mean()
                         + (nm[:, :-1] - nm[:, 1:]).abs().mean())
            loss = loss + config.tnsm_weight * (consistency + smoothing)

    aux = {"loss_rgb": loss_rgb, "loss_hvi": loss_hvi, "output_rgb": output_rgb}
    return loss, aux


def accumulate_gradients(model, low, high, gamma, vgg, config) -> Tuple[torch.Tensor, torch.Tensor]:
    """The step's loss and gradients, without the update: the batch's
    ``composite_loss`` backward into the parameters' ``.grad`` (zeroed
    first), or with ``grad_accum`` a, the sum over a equal microbatches,
    divided by a. Returns (loss, output_rgb), both detached."""
    accum = max(int(config.grad_accum), 1)
    if accum > 1 and low.shape[0] % accum:
        raise ValueError(
            f"batch {low.shape[0]} must be divisible by "
            f"--grad_accum {accum}"
        )
    for p in model.parameters():
        if p.grad is not None:
            p.grad.zero_()
    with exact_fp32():
        if accum == 1:
            loss, aux = composite_loss(model, low, high, gamma, vgg, config)
            loss.backward()
            return loss.detach(), aux["output_rgb"].detach()
        losses, outs = [], []
        for lo, hi in zip(low.chunk(accum), high.chunk(accum)):
            loss_i, aux = composite_loss(model, lo, hi, gamma, vgg, config)
            loss_i.backward()
            losses.append(loss_i.detach())
            outs.append(aux["output_rgb"].detach())
    for p in model.parameters():
        if p.grad is not None:
            p.grad.div_(accum)
    return sum(losses) / accum, torch.cat(outs)


def check_dp_batch(batch: int, accum: int, world: int) -> None:
    """The JAX step's checks on the global batch: it must split into
    ``accum`` microbatches, and each microbatch over the ``world`` ranks."""
    if accum > 1 and batch % accum:
        raise ValueError(f"batch {batch} must be divisible by --grad_accum {accum}")
    if (batch // accum) % world:
        raise ValueError(
            f"microbatch {batch // accum} (batch {batch} / grad_accum {accum}) must be "
            f"divisible by the {world}-process group for the data-parallel train step — "
            "choose --batchSize as a multiple of devices * grad_accum"
        )


def all_reduce_mean_(loss: torch.Tensor, params, group=None) -> torch.Tensor:
    """``jax.lax.pmean`` of the loss and the gradients over ``group``: one
    flat fp32 buffer (the loss, then each parameter's gradient in order),
    one ``all_reduce(SUM)``, a division by the world size, the gradients
    written back. Returns the group's mean loss."""
    grads = [p.grad for p in params]
    flat = torch.cat([loss.detach().float().reshape(1)] + [g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(dist.get_world_size(group))
    offset = 1
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[0]


def train_step(
    model: CIDNet,
    optimizer: torch.optim.Optimizer,
    low: torch.Tensor,
    high: torch.Tensor,
    gamma,
    vgg: Optional[VGGFeatures],
    config: TrainConfig,
    group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update on the batch (NHWC fp32 on the model's device). Returns
    (loss, output_rgb) as device tensors: nothing is read back here.

    ``group``: a ``torch.distributed`` group (``dist.group.WORLD`` for all
    processes) whose ranks each hold their rows of one global batch. The
    loss and gradients of the local microbatches are mean-reduced over it
    before the clip and the update (``all_reduce_mean_``), so every rank
    makes the same update: the JAX step's per-microbatch ``pmean``, taken
    once after the microbatches (the mean is linear: equal up to
    rounding). The returned loss is the group's mean; the output is this
    rank's rows. Not ``DistributedDataParallel``: it reduces inside each
    microbatch's backward, and base's ``I_LCA5`` gets no autograd gradient
    (it only holds the zero one ``make_optimizer`` gives it), which DDP
    would have to search for."""
    if group is not None:
        check_dp_batch(low.shape[0] * dist.get_world_size(group),
                       max(int(config.grad_accum), 1), dist.get_world_size(group))
    loss, out = accumulate_gradients(model, low, high, gamma, vgg, config)
    if group is not None:
        loss = all_reduce_mean_(loss, model.parameters(), group)
    if config.grad_clip_mode == "clip":
        clip_by_global_norm_(p.grad for p in model.parameters())
    optimizer.step()
    return loss, out


def nonfinite_guard(loss: float, epoch: int, step: int) -> None:
    """Failure detector: the reference's ``set_detect_anomaly`` toggle +
    visual canary (train.py:47,84-89). Takes the step's one host read."""
    if not math.isfinite(loss):
        raise FloatingPointError(
            f"non-finite loss {loss} at epoch {epoch} step {step}; "
            "enable --grad_detect (torch.autograd.set_detect_anomaly) or lower lr / "
            "enable grad clipping"
        )
