"""Architecture config registry: --arch <id> resolution.

The port serves `paper-demo` and the two recurrent archs
(`recurrentgemma-9b`, `rwkv6-1.6b`); the registry grows with each
architecture the port learns to run. Each module is a copy of the JAX
package's (tests/test_torch_recurrent.py holds the copies equal)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    MoEConfig,
    ParallelPlan,
    ShapeConfig,
    default_plan,
)

# arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    "paper-demo": "paper_demo",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}


ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()
