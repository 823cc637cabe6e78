"""Data pipeline: deterministic synthetic streams + memmap corpus, sharded
(port of the JAX package's data/pipeline.py).

Determinism contract: batch(seed, step) is a pure function, and distinct
data-parallel shards draw disjoint slices of it, so elastic resharding
replays identically regardless of cluster size, and a restarted run
resumes the exact stream from its checkpointed step. The batches are made
with numpy from the same Philox streams as the JAX package's, so they are
equal to its batches bit for bit; ShardedLoader hands them over as torch
tensors on the trainer's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.env import Env
from repro_torch.parallel import rules


def _philox(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.Generator(
        np.random.Philox(key=[seed * 0x9E3779B9 + step, shard]))


@dataclass(frozen=True)
class SyntheticLM:
    """Markov-ish synthetic token stream (not uniform noise: loss can drop)."""
    vocab_size: int
    seq_len: int
    seed: int = 0

    def batch_np(self, step: int, batch: int, shard: int = 0,
                 n_shards: int = 1) -> Dict[str, np.ndarray]:
        assert batch % n_shards == 0
        local = batch // n_shards
        g = _philox(self.seed, step, shard)
        # structured stream: tokens_t+1 = (a*tokens_t + drift) % V with noise
        base = g.integers(0, self.vocab_size, size=(local, 1))
        drift = g.integers(1, 7, size=(local, 1))
        idx = np.arange(self.seq_len + 1)[None, :]
        toks = (base + drift * idx) % self.vocab_size
        noise_mask = g.random((local, self.seq_len + 1)) < 0.1
        noise = g.integers(0, self.vocab_size, size=(local, self.seq_len + 1))
        toks = np.where(noise_mask, noise, toks).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class MemmapCorpus:
    """Flat token file + sampled windows (the 'real corpus' path)."""

    def __init__(self, path: str, seq_len: int, seed: int = 0):
        self.path = path
        self.seq_len = seq_len
        self.seed = seed
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        assert len(self.tokens) > seq_len + 1, "corpus too small"

    @staticmethod
    def write(path: str, tokens: np.ndarray) -> None:
        tokens.astype(np.int32).tofile(path)

    def batch_np(self, step: int, batch: int, shard: int = 0,
                 n_shards: int = 1) -> Dict[str, np.ndarray]:
        assert batch % n_shards == 0
        local = batch // n_shards
        g = _philox(self.seed, step, shard)
        starts = g.integers(0, len(self.tokens) - self.seq_len - 1, size=local)
        rows = np.stack([np.asarray(self.tokens[s:s + self.seq_len + 1])
                         for s in starts])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def add_modality_stubs(batch: Dict[str, np.ndarray], cfg: ModelConfig,
                       step: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Precomputed frame/patch embeddings (stub frontends)."""
    B, S = batch["tokens"].shape
    g = _philox(seed + 7, step, 0)
    if cfg.family == "vlm":
        batch["vision_embeds"] = g.standard_normal(
            (B, cfg.num_vision_embeds, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.is_encdec:
        batch["frames"] = g.standard_normal(
            (B, max(S // cfg.enc_downsample, 1), cfg.d_model)
        ).astype(np.float32) * 0.02
    return batch


class ShardedLoader:
    """Global batches as torch tensors on `device` (the trainer's).

    Without a mesh the batch is whole there. Over a DeviceMesh each rank
    takes its own rows of the global batch (its data coordinate's share,
    as parallel/rules.py batch_specs places them; every row where the dp
    degree does not divide the batch) and moves only those, as a DTensor
    over the mesh: the JAX package's ShardedLoader places slices of the
    same global batch, so a mesh of any shape trains on the same data."""

    def __init__(self, source, cfg: ModelConfig, shape: ShapeConfig, env: Env,
                 seed: int = 0, device="cuda"):
        from torch.distributed.device_mesh import DeviceMesh
        if env.mesh is not None and not isinstance(env.mesh, DeviceMesh):
            raise ValueError("ShardedLoader places batches over a "
                             "DeviceMesh; a shape-only mesh has no ranks")
        self.source = source
        self.cfg = cfg
        self.shape = shape
        self.env = env
        self.seed = seed
        self.device = torch.device(device)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        b = self.source.batch_np(step, self.shape.global_batch)
        b = add_modality_stubs(dict(b), self.cfg, step, self.seed)
        if self.env.mesh is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in b.items()}
        from torch.distributed.tensor import DTensor
        mesh = self.env.mesh
        specs = rules.batch_specs(b, self.cfg, self.shape, self.env)
        out = {}
        for k, v in b.items():
            n, i = 1, 0
            for a in rules.axes_of(specs[k][0]):  # its row block, major first
                n, i = (n * mesh.size(mesh.mesh_dim_names.index(a)),
                        i * mesh.size(mesh.mesh_dim_names.index(a))
                        + mesh.get_local_rank(a))
            rows = np.array_split(v, n)[i]
            t = torch.from_numpy(np.ascontiguousarray(rows)).to(self.device)
            out[k] = DTensor.from_local(t, mesh,
                                        rules.placements(specs[k], mesh),
                                        run_check=False)
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
