"""VGG feature extractor (the perceptual loss's backbone).

Counterpart of ``hvi_cidnet_tpu/losses/vgg.py`` (reference
``loss/vgg_arch.py:87-239``): VGG19's ``features`` stack under torchvision's
indices (``features.0`` ... ``features.25`` up to ``conv4_4``), so a
torchvision ``vgg19.pth`` loads with strict keys. The taps are the conv
outputs *before* the ReLU, as the reference's ``conv{i}_{j}`` names are.

Weights come from a local torchvision-format state dict
(``load_vgg_torch``), from the JAX package's ``init_vgg`` tree
(``vgg_params_from_jax``) or, for tests and smoke runs, from a seeded
He-normal draw with the real network's shapes (and so its FLOPs).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


def _spec(cfg: Sequence) -> List[Tuple[str, str, int]]:
    """(name, kind, out channels) of each layer, in torchvision's order."""
    spec = []
    block, conv_idx = 1, 1
    for item in cfg:
        if item == "M":
            spec.append((f"pool{block}", "pool", 0))
            block += 1
            conv_idx = 1
        else:
            spec.append((f"conv{block}_{conv_idx}", "conv", item))
            spec.append((f"relu{block}_{conv_idx}", "relu", 0))
            conv_idx += 1
    return spec


VGG19 = _spec([64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
               512, 512, 512, 512, "M"])

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _index_of(name: str) -> int:
    for i, (n, _, _) in enumerate(VGG19):
        if n == name:
            return i
    raise KeyError(name)


class VGGFeatures(nn.Module):
    """VGG19 ``features`` up to and including ``up_to``; ``forward(x,
    names)`` returns the named taps of an NCHW batch.

    Without a state dict the convs are drawn from ``generator`` (a fresh
    one seeded 0 if None) as the JAX ``init_vgg`` draws its own: normal with
    std sqrt(2 / fan_in), zero biases."""

    def __init__(self, up_to: str = "conv4_4", *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.names = [n for n, _, _ in VGG19[: _index_of(up_to) + 1]]
        layers, cin = [], 3
        for _, kind, cout in VGG19[: _index_of(up_to) + 1]:
            if kind == "conv":
                layers.append(nn.Conv2d(cin, cout, 3, padding=1))
                cin = cout
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).view(1, 3, 1, 1), persistent=False)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for layer in self.features:
            if isinstance(layer, nn.Conv2d):
                fan_in = layer.weight[0].numel()
                draw = torch.randn(layer.weight.shape, generator=generator) * np.sqrt(2.0 / fan_in)
                layer.weight.copy_(draw)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor, names: Sequence[str], *, use_input_norm: bool = True,
                range_norm: bool = True) -> Dict[str, torch.Tensor]:
        """``range_norm`` applies ``(x + 1) / 2`` *before* the ImageNet
        normalisation: the reference passes [0, 1] images through this path
        anyway (vgg_arch.py:219-224 with train.py:192's range_norm=True),
        kept for parity with models trained by it."""
        x = x.float()
        if range_norm:
            x = (x + 1.0) / 2.0
        if use_input_norm:
            x = (x - self.mean) / self.std
        wanted = set(names)
        last = max(_index_of(n) for n in wanted)
        out: Dict[str, torch.Tensor] = {}
        for i, (name, layer) in enumerate(zip(self.names, self.features)):
            if i > last:
                break
            x = layer(x)
            if name in wanted:
                out[name] = x
        return out


def _feature_keys(up_to: str) -> List[Tuple[str, str]]:
    """(our conv name, torchvision ``features.N``) up to ``up_to``."""
    return [(name, f"features.{i}") for i, (name, kind, _) in enumerate(VGG19[: _index_of(up_to) + 1])
            if kind == "conv"]


def load_vgg_torch(path: str, up_to: str = "conv4_4") -> VGGFeatures:
    """Load a torchvision-format ``vgg19*.pth`` (``features.N.{weight,bias}``):
    every conv up to ``up_to`` must be there with its shape (a ``KeyError``
    or a ``RuntimeError`` otherwise); the rest of the network (deeper convs,
    the classifier) is not used."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    vgg = VGGFeatures(up_to)
    own = vgg.state_dict()
    missing = [k for k in own if k not in state]
    if missing:
        raise KeyError(f"{path}: not a torchvision VGG19 state dict, missing {missing[:4]}")
    vgg.load_state_dict({k: torch.as_tensor(state[k]).float() for k in own}, strict=True)
    return vgg


def vgg_params_from_jax(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The JAX ``init_vgg`` / ``load_vgg_torch`` tree (``conv{i}_{j}.weight``
    HWIO, ``.bias``) -> a ``VGGFeatures`` state dict (OIHW)."""
    up_to = max((k.split(".")[0] for k in params), key=_index_of)
    out: Dict[str, torch.Tensor] = {}
    for name, key in _feature_keys(up_to):
        w = np.asarray(params[name + ".weight"], np.float32).transpose(3, 2, 0, 1)
        out[key + ".weight"] = torch.from_numpy(np.ascontiguousarray(w))
        out[key + ".bias"] = torch.from_numpy(np.asarray(params[name + ".bias"], np.float32).copy())
    return out

