"""Name -> object registry.

Counterpart of ``hvi_cidnet_tpu/utils/registry.py``: the generic registry
and its five instances (the reference's loss/vgg_arch.py:7-85 carries the
same five, of which only ``ARCH_REGISTRY`` is used). ``MODEL_REGISTRY``
holds the CIDNet variants, ``base``, ``mssa`` and ``tnsm``, as the port's
``CIDNetConfig``s, registered when this module is imported.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._objs: Dict[str, object] = {}

    def register(self, obj=None, *, name: str = None):
        """Use as ``@REG.register`` / ``@REG.register(name=...)`` or
        ``REG.register(obj, name=...)``."""
        if obj is None:
            return lambda o: self.register(o, name=name)
        key = name or getattr(obj, "__name__", str(obj))
        if key in self._objs:
            raise KeyError(f"{key!r} already registered in {self._name!r}")
        self._objs[key] = obj
        return obj

    def get(self, name: str):
        if name not in self._objs:
            raise KeyError(
                f"{name!r} not found in registry {self._name!r}; "
                f"available: {sorted(self._objs)}"
            )
        return self._objs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._objs

    def __iter__(self) -> Iterator[Tuple[str, object]]:
        return iter(self._objs.items())

    def keys(self):
        return self._objs.keys()


ARCH_REGISTRY = Registry("arch")
DATASET_REGISTRY = Registry("dataset")
MODEL_REGISTRY = Registry("model")
LOSS_REGISTRY = Registry("loss")
METRIC_REGISTRY = Registry("metric")


def _register_builtins() -> None:
    from hvi_cidnet_torch.models.cidnet import VARIANTS, CIDNetConfig

    for variant in VARIANTS:
        if variant not in MODEL_REGISTRY:
            MODEL_REGISTRY.register(CIDNetConfig(variant=variant), name=variant)


_register_builtins()
