"""The port's trainer learns (CPU, fp32, the tiny CIDNet).

A seeded low-light inversion task built here: smooth random images (a 4 x 4
grid of colours, bilinearly upsampled to 32 x 32) as the ground truth, and
low = 0.2 * high ** 1.3 plus noise as the input. ``train_step`` (the
composite loss without the perceptual term, Adam at a fixed lr) on 32
training pairs must raise the held-out PSNR over the identity's (the dark
input scored against its ground truth) by MARGIN_DB, a margin set before
the first run. Deterministic: fixed seeds, one torch thread.
"""

import numpy as np
import torch
import torch.nn.functional as F

from hvi_cidnet_torch.models.cidnet import CIDNet, CIDNetConfig, cidnet_forward
from hvi_cidnet_torch.train import trainer as pt
from _torch_port import one_torch_thread  # noqa: F401 (autouse)

TINY = CIDNetConfig(channels=(8, 8, 16, 32), heads=(1, 2, 4, 8))
MARGIN_DB = 5.0
STEPS, BATCH, LR = 25, 4, 2e-3


def _task(n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    grid = torch.rand((n, 3, 4, 4), generator=g) * 0.8 + 0.1
    high = F.interpolate(grid, size=(32, 32), mode="bilinear", align_corners=False)
    high = high.permute(0, 2, 3, 1).contiguous()
    low = (0.2 * high**1.3 + 0.01 * torch.randn(high.shape, generator=g)).clamp(0, 1)
    return low, high


def _psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = ((a.clamp(0, 1) - b) ** 2).mean(dim=(1, 2, 3))
    return float((10 * torch.log10(1.0 / mse)).mean())


def test_trainer_learns_low_light_inversion():
    low, high = _task(32, seed=0)
    test_low, test_high = _task(8, seed=1)
    cfg = pt.TrainConfig(model=TINY, lr=LR, use_perceptual=False, compute_dtype="float32")
    model = CIDNet(TINY, generator=torch.Generator().manual_seed(0))
    opt = pt.make_optimizer(model, cfg)
    order = np.random.default_rng(0)
    losses = []
    for step in range(STEPS):
        idx = torch.from_numpy(order.choice(32, BATCH, replace=False))
        loss, _ = pt.train_step(model, opt, low[idx], high[idx], 1.0, None, cfg)
        losses.append(float(loss))
        pt.nonfinite_guard(losses[-1], 1, step)
    with torch.no_grad():
        out = cidnet_forward(model, test_low)
    identity, trained = _psnr(test_low, test_high), _psnr(out, test_high)
    print(f"held-out PSNR: identity {identity:.2f} dB, trained {trained:.2f} dB; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert trained >= identity + MARGIN_DB
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
