"""Production mesh constructors (port of the JAX package's launch/mesh.py).

The constructors are FUNCTIONS: importing this module touches no device and
no process group. Axis layout follows the "no-NAT" rule: "model" (TP) and
"data" (FSDP) ride the fast intra-pod links; only "pod" crosses the
slower fabric.

Each one makes a torch DeviceMesh over the first ranks of an initialised
process group (rank-major: rank r sits at row r // model, column
r % model), or with abstract=True a ShapeMesh: the axis names and sizes
alone, which is all the sharding rules (parallel/rules.py) read, so specs
resolve for the production layout on a machine without its ranks (the
JAX package's AbstractMesh). Building a DeviceMesh creates its axes'
process groups, which every rank of the world enters, ranks outside the
mesh included: every rank calls the constructor alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShapeMesh:
    """A mesh's axis names and sizes, with no devices (DeviceMesh's
    `mesh_dim_names`, `shape` and `size`)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self, mesh_dim: Optional[int] = None) -> int:
        if mesh_dim is not None:
            return self.shape[mesh_dim]
        n = 1
        for s in self.shape:
            n *= s
        return n


def _mesh(shape, axes, abstract: bool, device_type: str):
    if abstract:
        return ShapeMesh(tuple(shape), tuple(axes))
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, abstract: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, abstract, device_type)


def make_test_mesh(n_devices: Optional[int] = None, model: int = 2, *,
                   abstract: bool = False, device_type: str = "cuda"):
    """A (data, model) mesh over the first n_devices ranks (default: the
    process group's world size; gloo ranks on the CPU with
    device_type="cpu")."""
    if n_devices is None:
        import torch.distributed as dist
        n_devices = dist.get_world_size()
    n = n_devices
    model = max(1, min(model, n))
    while n % model:
        model -= 1
    return _mesh((n // model, model), ("data", "model"), abstract,
                 device_type)
