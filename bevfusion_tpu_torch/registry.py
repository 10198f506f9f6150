"""Type-name registries for building the port's modules from YAML.

Same contract as ``bevfusion_tpu.registry`` (``type:`` key selects the
class, the remaining keys are keyword arguments). The port keeps its own
instances: the JAX package registers the same type names into its own.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._registry: Dict[str, Any] = {}

    def register(self, cls):
        """Class decorator: register ``cls`` under its own name."""
        if self._registry.setdefault(cls.__name__, cls) is not cls:
            raise KeyError(f"{cls.__name__} already registered in {self.name}")
        return cls

    def build(self, cfg: Mapping):
        """Instantiate ``cfg['type']`` with the remaining keys as kwargs."""
        if not isinstance(cfg, Mapping):
            raise TypeError(f"cfg must be a mapping, got {type(cfg)}")
        cfg = dict(cfg)
        name = cfg.pop("type")
        if name not in self._registry:
            raise KeyError(f"{name!r} is not registered in {self.name}; "
                           f"available: {sorted(self._registry)}")
        return self._registry[name](**cfg)


BACKBONES = Registry("backbones")
NECKS = Registry("necks")
HEADS = Registry("heads")
VTRANSFORMS = Registry("vtransforms")
FUSERS = Registry("fusers")
FUSIONMODELS = Registry("fusion_models")
