"""HF-hub ``config.json`` -> :class:`CIDNetConfig`.

This package's own copy of ``hvi_cidnet_tpu/utils/hf_config.py:18-47``
(that package is not importable without jax). The reference ``CIDNet``
inherits ``PyTorchModelHubMixin`` (net/CIDNet.py:6-8), so a hub folder's
``config.json`` holds the constructor's kwargs (``channels``, ``heads``,
``norm``); the JAX package's ``save_pretrained`` adds ``variant`` for MSSA
and TNSM.
"""

from __future__ import annotations

import json
from typing import Optional

from hvi_cidnet_torch.models.cidnet import VARIANTS, CIDNetConfig


def config_from_hf_json(path: Optional[str]) -> CIDNetConfig:
    """Build the model config from a hub config.json (defaults when absent).

    Recognized keys mirror CIDNet.__init__ (net/CIDNet.py:9-12); unknown
    keys are ignored like the mixin's kwargs filtering would.
    """
    if path is None:
        return CIDNetConfig(variant="base")
    with open(path) as f:
        raw = json.load(f)
    kwargs = {}
    if "channels" in raw:
        ch = raw["channels"]
        if not (isinstance(ch, (list, tuple)) and len(ch) == 4):
            raise ValueError(f"config.json channels must be a 4-list, got {ch!r}")
        kwargs["channels"] = tuple(int(c) for c in ch)
    if "heads" in raw:
        hd = raw["heads"]
        if not (isinstance(hd, (list, tuple)) and len(hd) == 4):
            raise ValueError(f"config.json heads must be a 4-list, got {hd!r}")
        kwargs["heads"] = tuple(int(h) for h in hd)
    if "norm" in raw:
        kwargs["norm"] = bool(raw["norm"])
    # reference-produced config.json files have no "variant" key (the mixin
    # serializes base kwargs only), so absence means "base"
    variant = raw.get("variant", "base")
    if variant not in VARIANTS:
        raise ValueError(f"config.json variant must be base/mssa/tnsm, got {variant!r}")
    return CIDNetConfig(variant=variant, **kwargs)
