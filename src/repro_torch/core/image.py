"""ClusterImage — the Docker image/Dockerfile analogue (paper §III-A).

The paper's remedy for HPC software-dependency hell is encapsulation: the
node environment is a content-addressed image built from a declarative spec
and shared through a hub. The analogue here: a frozen, hashable spec of
everything that determines a worker's behavior — model config digest,
parallelism plan, software pins, entrypoint — so any node that pulls the
same digest is bit-identical in behavior. Agents advertise their image
digest in the catalog; the head node refuses mixed-digest clusters (the
exact class of version-skew failure the paper motivates with).

Port of the JAX package's core/image.py: the software pins record torch
and its CUDA version in place of jax, so the port's digests differ from
the JAX package's for the same config (parity tests compare hostfiles and
timelines, never digests).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import sys
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ParallelPlan


def software_pins() -> Dict[str, str]:
    import numpy
    import torch

    return {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "numpy": numpy.__version__,
        "platform": platform.platform(),
    }


@dataclass(frozen=True)
class ClusterImage:
    """FROM repro:base / RUN pin deps / CMD entrypoint — as data."""
    name: str
    arch: str  # ModelConfig digest
    plan: str  # ParallelPlan repr
    entrypoint: str  # "train" | "serve" | custom
    pins: Tuple[Tuple[str, str], ...]  # sorted software pins
    labels: Tuple[Tuple[str, str], ...] = ()

    @staticmethod
    def build(name: str, cfg: ModelConfig, plan: ParallelPlan,
              entrypoint: str = "train",
              pins: Optional[Dict[str, str]] = None,
              labels: Optional[Dict[str, str]] = None) -> "ClusterImage":
        return ClusterImage(
            name=name,
            arch=cfg.digest(),
            plan=json.dumps(dataclasses.asdict(plan), sort_keys=True),
            entrypoint=entrypoint,
            pins=tuple(sorted((pins or software_pins()).items())),
            labels=tuple(sorted((labels or {}).items())),
        )

    @property
    def digest(self) -> str:
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return "sha256:" + hashlib.sha256(payload.encode()).hexdigest()[:24]

    def dockerfile(self) -> str:
        """Render the equivalent Dockerfile (paper Fig. 2), for humans."""
        lines = ["FROM repro:base",
                 f"LABEL image.name={self.name} arch={self.arch}"]
        for k, v in self.pins:
            lines.append(f"RUN pin {k}=={v}")
        lines.append(f"ADD plan.json /etc/repro/plan.json  # {self.plan[:48]}…")
        lines.append(f'CMD ["repro-launch", "{self.entrypoint}"]')
        return "\n".join(lines) + "\n"


class ImageHub:
    """Local Docker-Hub analogue: digest-addressed image store."""

    def __init__(self):
        self._by_digest: Dict[str, ClusterImage] = {}
        self._tags: Dict[str, str] = {}

    def push(self, image: ClusterImage, tag: Optional[str] = None) -> str:
        d = image.digest
        self._by_digest[d] = image
        self._tags[tag or image.name] = d
        return d

    def pull(self, ref: str) -> ClusterImage:
        digest = self._tags.get(ref, ref)
        if digest not in self._by_digest:
            raise KeyError(f"image {ref!r} not found in hub")
        return self._by_digest[digest]

    def tags(self) -> Dict[str, str]:
        return dict(self._tags)
