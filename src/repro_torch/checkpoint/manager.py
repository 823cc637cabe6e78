"""Checkpointing with restore onto a new rendering (port of the JAX
package's checkpoint/manager.py).

The substrate the elastic runtime (core/elastic.py) stands on: a
checkpoint written under one membership epoch restores onto the devices
of the next, each leaf placed on its target device (or, over a
DeviceMesh, distributed by the matching entry of `shardings`).

Format, the JAX package's byte for byte, so a checkpoint written by one
package restores in the other: <dir>/step_<k>/
  manifest.json  - {"step", "metadata", "leaves": {key: {file, shape,
                   dtype}}}, keys built from ['name'] for a dict key and
                   [i] for a tuple or list entry, joined by \\x1d, in the
                   JAX package's leaf order (dict keys sorted); dtypes
                   are numpy's names (bfloat16, float32, int32, int8)
  <file>.npy     - one file per leaf, named _safe(key); a bf16 leaf is
                   stored as its uint16 bits with a <file>.npy.dtype tag
                   file holding "bfloat16"
A None leaf (an int8 moment's scale on a 1-D parameter) is an empty
subtree, as jax.tree_util has it: it has no key and no file.

Features: atomic publish (tmp dir + rename), retention of the last K,
async save (a host copy taken before save_async returns, file IO on a
background thread, wait()), integrity checks on restore.

Under a process group (one process per rank) save, save_async and wait
are entered by every rank alike: the ranks that hold the state (a tree
of DTensors over a DeviceMesh; None on a rank outside it) gather each
leaf whole, the lowest of them writes, and save and wait end in a
barrier over the world, so every rank then reads the same directory.
restore is entered by the ranks of the target mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

Pytree = Any

_SEP = "\x1d"


def _map_with_keys(fn, tree: Pytree, prefix: str = "") -> Pytree:
    """fn(key, leaf) over `tree`'s leaves in the JAX package's order (dict
    keys sorted), in the same nest; a key is jax.tree_util.keystr of each
    path entry ("['name']", "[i]") joined by _SEP; None is an empty
    subtree."""
    if tree is None:
        return None
    join = lambda n: n if not prefix else prefix + _SEP + n
    if isinstance(tree, dict):
        out = {k: _map_with_keys(fn, tree[k], join(f"[{k!r}]"))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_keys(fn, v, join(f"[{i}]"))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _flatten_with_paths(tree: Pytree) -> Dict[str, Any]:
    out = {}
    _map_with_keys(out.__setitem__, tree)
    return out


def _host_copy(leaf: torch.Tensor) -> np.ndarray:
    """A C-ordered numpy array that owns its data (never a view of a live
    tensor, which an in-place optimizer step would change under a
    background write); bf16 as its uint16 bits. A DTensor is gathered
    whole first (a collective over its mesh)."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16)
    return t.to("cpu", copy=True).numpy()


def _np_save(path: str, a: np.ndarray, dtype: str) -> None:
    np.save(path, a)
    if dtype == "bfloat16":  # npy has no bf16: raw bits + tag
        with open(path + ".npy.dtype", "w") as f:
            f.write("bfloat16")


def _np_load(path: str) -> torch.Tensor:
    a = np.load(path + ".npy")
    if os.path.exists(path + ".npy.dtype"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _safe(key: str) -> str:
    return "".join(c if (c.isalnum() or c in "._-") else "_" for c in key)


def _distributed() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _writes(state: Pytree) -> bool:
    """Whether this process writes `state`: always without a process
    group; under one, the lowest rank of the mesh its DTensors span (a
    rank outside it holds None)."""
    if not _distributed():
        return True
    if state is None:
        return False
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    for leaf in _flatten_with_paths(state).values():
        if isinstance(leaf, DTensor):
            return dist.get_rank() == int(leaf.device_mesh.mesh.min())
    return True


def _barrier() -> None:
    if _distributed():
        import torch.distributed as dist
        dist.barrier()


def _host_leaves(state: Pytree) -> Dict[str, tuple]:
    """key -> (host copy, numpy dtype name) for every leaf of `state`
    (None: no leaves, a rank outside the state's mesh)."""
    out = {}
    if state is None:
        return out
    for k, v in _flatten_with_paths(state).items():
        a = _host_copy(v)
        out[k] = (a, "bfloat16" if v.dtype == torch.bfloat16
                  else a.dtype.name)
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()

    # ---- save ---------------------------------------------------------------
    def save(self, step: int, state: Pytree,
             metadata: Optional[Dict[str, Any]] = None) -> str:
        """Synchronous save; atomic publish via rename."""
        flat = _host_leaves(state)
        final = os.path.join(self.dir, f"step_{step:08d}")
        if _writes(state):
            final = self._write(step, flat, metadata)
        _barrier()
        return final

    def _write(self, step: int, flat: Dict[str, tuple],
               metadata: Optional[Dict[str, Any]]) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
        for key, (a, dtype) in flat.items():
            fname = _safe(key)
            manifest["leaves"][key] = {
                "file": fname,
                "shape": list(a.shape),
                "dtype": dtype,
            }
            _np_save(os.path.join(tmp, fname), a, dtype)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._retain()
        return final

    def save_async(self, step: int, state: Pytree,
                   metadata: Optional[Dict[str, Any]] = None) -> Future:
        """Device->host copy happens now (a copy the caller may update in
        place as soon as this returns); file IO in the background."""
        flat = _host_leaves(state)
        with self._lock:
            if _writes(state):
                self._pending = self._pool.submit(self._write, step, flat,
                                                  metadata)
            return self._pending

    def wait(self) -> None:
        with self._lock:
            pending = self._pending
        if pending is not None:
            pending.result()
        _barrier()

    def _retain(self) -> None:
        steps = self.available_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---- restore --------------------------------------------------------------
    def available_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, target_struct: Pytree, step: Optional[int] = None,
                shardings: Optional[Pytree] = None,
                device=None) -> Pytree:
        """Restore into target_struct's tree (values ignored: meta-device
        tensors do, as jax.eval_shape's structs do in the JAX package).

        Each leaf lands on `device`; without one, on its target leaf's
        device, and a meta target's leaf on the card ("cuda", the port's
        default device). Where `shardings` (parallel/rules.py
        to_shardings' tree: a Placed per leaf) has an entry, the leaf is
        distributed over that mesh instead."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        base = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        flat_target = _flatten_with_paths(target_struct)
        flat_shard = (_flatten_with_paths(shardings)
                      if shardings is not None else {})
        missing = set(flat_target) - set(manifest["leaves"])
        extra = set(manifest["leaves"]) - set(flat_target)
        if missing or extra:
            raise ValueError(
                f"checkpoint/target tree mismatch: missing={sorted(missing)[:3]}"
                f" extra={sorted(extra)[:3]}")
        out = {}
        for key, want in flat_target.items():
            info = manifest["leaves"][key]
            arr = _np_load(os.path.join(base, info["file"]))
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(arr.shape)} vs {tuple(want.shape)}")
            sh = flat_shard.get(key)
            if sh is not None:
                from torch.distributed.tensor import distribute_tensor
                out[key] = distribute_tensor(arr.to(sh.mesh.device_type),
                                             sh.mesh, sh.placements)
                continue
            dev = device
            if dev is None:
                dev = "cuda" if want.device.type == "meta" else want.device
            out[key] = arr.to(dev)
        return _map_with_keys(lambda k, _: out[k], target_struct)

    def metadata(self, step: Optional[int] = None) -> Dict[str, Any]:
        step = step if step is not None else self.latest_step()
        base = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(base, "manifest.json")) as f:
            return json.load(f)["metadata"]
