"""LPIPS (AlexNet flavor) as a PyTorch module.

The counterpart of ``hvi_cidnet_tpu/metrics/lpips.py``. The reference
scores LPIPS through the ``lpips`` pip package (measure.py:78-79,145-149):
AlexNet's feature stack, per-layer unit-normalised feature differences,
learned 1x1 "lin" weights, a spatial average and a sum over layers.

* ``LPIPS``: AlexNet ``features`` under torchvision's indices (convs at
  ``features.0/3/6/8/10``, ``MaxPool2d(3, 2)`` with no padding, the JAX
  ``reduce_window`` VALID), the lpips ``ScalingLayer`` constants, and
  ``lin0``-``lin4``, 1x1 convs without bias.
* The channel normalisation is the JAX package's ``a / sqrt(sum a^2 +
  1e-10)`` (``lpips.py:125-126``); the pip package puts its eps outside the
  square root, ``a / (sqrt(sum a^2) + 1e-10)``.
* ``lpips_distance`` runs its convs in fp32 with TF32 off, in a scope that
  restores the global flags (cuDNN's default allows TF32 on the card).

Pretrained AlexNet + lin weights are not part of the repository:
``load_lpips_torch`` reads a user-supplied combined state dict (the lpips
package's ``.pth`` merged with torchvision's alexnet ``features``),
``init_lpips`` makes seeded stand-in weights, and ``lpips_params_from_jax``
carries the JAX ``init_lpips`` tree (HWIO, as numpy) across.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# AlexNet 'features' (torchvision): (index, out channels, kernel, stride,
# pad) of each conv; a ReLU follows each conv, a 3x3 stride-2 max pool the
# first two ReLUs. The lpips taps are the five ReLU outputs.
_CONVS = [(0, 64, 11, 4, 2), (3, 192, 5, 1, 2), (6, 384, 3, 1, 1), (8, 256, 3, 1, 1),
          (10, 256, 3, 1, 1)]
_POOL_AFTER = (0, 3)
TAP_CH = [64, 192, 384, 256, 256]
# the JAX tree's conv names, in _CONVS order
_JAX_CONVS = ["conv1", "conv2", "conv3", "conv4", "conv5"]

# lpips input scaling layer constants (ScalingLayer shift/scale).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """AlexNet + lin LPIPS; ``forward(img1, img2)`` is ``lpips_distance``'s
    body: NCHW in [-1, 1] -> (B,)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for idx, cout, k, stride, pad in _CONVS:
            layers.append(nn.Conv2d(cin, cout, k, stride, pad))
            layers.append(nn.ReLU())
            if idx in _POOL_AFTER:
                layers.append(nn.MaxPool2d(3, 2))
            cin = cout
        self.features = nn.Sequential(*layers)
        for i, ch in enumerate(TAP_CH):
            setattr(self, f"lin{i}", nn.Conv2d(ch, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def taps(self, x: torch.Tensor):
        out = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                out.append(x)
        return out

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        def prep(x):
            return (x.float() - self.shift) / self.scale

        total = 0.0
        for i, (a, b) in enumerate(zip(self.taps(prep(img1)), self.taps(prep(img2)))):
            a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            proj = F.conv2d((a - b) ** 2, getattr(self, f"lin{i}").weight)
            total = total + proj.mean(dim=(1, 2, 3))
        return total


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN convolutions and cuBLAS products inside the
    block; the global flags are restored on exit."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def lpips_distance(model: LPIPS, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """LPIPS between NCHW images in [-1, 1] (lpips package convention), on
    the model's device, fp32 without TF32: a (B,) tensor."""
    dev = next(model.parameters()).device
    with no_tf32(), torch.no_grad():
        return model(img1.to(dev), img2.to(dev))


def im2tensor_range(img_uint8: np.ndarray) -> torch.Tensor:
    """[0,255] HWC -> [-1,1] (1, 3, H, W) float32 (lpips.im2tensor)."""
    x = np.asarray(img_uint8).astype(np.float32) / 127.5 - 1.0
    return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)[None]))


def init_lpips(generator: Optional[torch.Generator] = None) -> LPIPS:
    """Seeded stand-in weights (architecture-faithful, scores not
    calibrated), drawn as the JAX ``init_lpips`` draws its own: He-normal
    convs, zero biases, ``|normal| * 0.1`` lins."""
    model = LPIPS()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("lin"):
                p.copy_(torch.randn(p.shape, generator=generator).abs() * 0.1)
            elif name.endswith("weight"):
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=generator) * float(np.sqrt(2.0 / fan_in)))
            else:
                p.zero_()
    return model


def _lin_key(state: Mapping[str, torch.Tensor], i: int, where: str) -> str:
    for cand in (f"lin{i}.model.1.weight", f"lin{i}.weight"):
        if cand in state:
            return cand
    raise KeyError(f"lin{i} weight not found in {where}")


def load_lpips_state(state: Mapping[str, torch.Tensor], where: str = "the state dict") -> LPIPS:
    """An ``LPIPS`` from a combined state dict: alexnet ``features.N.*`` and
    lpips ``lin{i}.model.1.weight`` (or bare ``lin{i}.weight``) keys, all
    in torch layout. Strict: a missing or unexpected key raises."""
    own: Dict[str, torch.Tensor] = {}
    for idx, *_ in _CONVS:
        for kind in ("weight", "bias"):
            own[f"features.{idx}.{kind}"] = state[f"features.{idx}.{kind}"]
    lins = {i: _lin_key(state, i, where) for i in range(len(TAP_CH))}
    own.update({f"lin{i}.weight": state[k] for i, k in lins.items()})
    extra = set(state) - {k for k in own if k.startswith("features.")} - set(lins.values())
    if extra:
        raise KeyError(f"unexpected LPIPS keys in {where}: {sorted(extra)}")
    model = LPIPS()
    model.load_state_dict({k: torch.as_tensor(v).float() for k, v in own.items()}, strict=True)
    return model


def load_lpips_torch(path: str) -> LPIPS:
    """``load_lpips_state`` of a ``torch.save``d combined state dict (on
    the CPU; move the module where it should run)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    return load_lpips_state(state, path)


def lpips_params_from_jax(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``init_lpips`` / ``load_lpips_torch`` tree (HWIO convs and
    lins, as numpy) as this module's state dict (OIHW)."""
    state: Dict[str, torch.Tensor] = {}
    for (idx, *_), name in zip(_CONVS, _JAX_CONVS):
        w = np.asarray(params[name + ".weight"], np.float32)
        state[f"features.{idx}.weight"] = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
        state[f"features.{idx}.bias"] = torch.from_numpy(
            np.asarray(params[name + ".bias"], np.float32).copy())
    for i in range(len(TAP_CH)):
        w = np.asarray(params[f"lin{i}.weight"], np.float32)
        state[f"lin{i}.weight"] = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    return state
