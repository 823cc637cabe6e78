"""Architecture config registry: --arch <id> resolution.

The port serves `paper-demo`, the four dense attention archs (`yi-9b`,
`granite-3-8b`, `qwen3-32b` with qk-norm, `qwen2-1.5b` with a qkv bias),
the two MoE archs (`grok-1-314b`, `llama4-scout-17b-a16e`) and the two
recurrent archs (`recurrentgemma-9b`, `rwkv6-1.6b`): every decoder-only
text arch of the JAX package's zoo; and the two modality archs, the VLM
`qwen2-vl-7b` (M-RoPE) and the encoder-decoder `whisper-small`, whose
front ends are stubs as there. Each module is a copy of the JAX
package's (tests/test_torch_recurrent.py, tests/test_torch_zoo.py and
tests/test_torch_modality.py hold the copies equal)."""
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
    "yi-9b": "yi_9b",
    "granite-3-8b": "granite_3_8b",
    "qwen3-32b": "qwen3_32b",
    "qwen2-1.5b": "qwen2_1_5b",
    "grok-1-314b": "grok_1_314b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "whisper-small": "whisper_small",
}


ARCH_IDS = tuple(_ARCH_MODULES)
# the JAX package's ARCH_IDS, in its order: the zoo the dry run's cells
# cover, without paper-demo (ARCH_IDS keeps it: it serves and trains too)
ZOO_ARCH_IDS = ("yi-9b", "granite-3-8b", "qwen3-32b", "qwen2-1.5b",
                "grok-1-314b", "llama4-scout-17b-a16e", "recurrentgemma-9b",
                "whisper-small", "rwkv6-1.6b", "qwen2-vl-7b")


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(include_long_skips: bool = False):
    """Yield every assigned (arch, shape, tag) cell of the zoo, in the JAX
    package's order (its configs/__init__.py cells): each zoo arch over
    SHAPES, tag "run". long_500k needs sub-quadratic attention: only the
    archs with no full-attention block run it; the others are skipped,
    or with include_long_skips yielded tagged "skip:full-attention"."""
    for arch in ZOO_ARCH_IDS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            if shape.long_context and not cfg.sub_quadratic:
                if include_long_skips:
                    yield arch, sname, "skip:full-attention"
                continue
            yield arch, sname, "run"
