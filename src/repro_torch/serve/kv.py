"""KVBackend — the one KV-cache contract the serving plane talks to.

Port of the JAX package's serve/kv.py. A backend owns its device cache, its
bookkeeping, and its fused decode step; the engine schedules rows and
never learns what a block table is. The port has three backends: the
paged BlockManager (serve/blocks.py), its int8 variant QuantBlockManager
(`--kv quant`) and the contiguous SlotPool (serve/slots.py, `--kv slot`).
There is no counterpart of the JAX
package's shared_jit registry: PyTorch runs eagerly, so there is nothing
to compile once per config.

Lifecycle of one request through a backend:

    can_admit(gen_len, prompt=…)  reservation check (admission-time
                            backpressure; prompt makes it prefix-aware)
    admit(rid, gen_len, prompt=…) bind a slot + reserve worst-case
                            capacity; a prompt whose prefix the backend
                            already caches admits with shared blocks
    cached_prefix_len(slot) prompt positions admit() served from its
                            prefix cache — the engine starts prefill
                            lanes there
    insert(slot, …)         classic path: scatter a batch-1 prefill cache
      — or —
    ensure(slot, pos)       chunked path: grow capacity to cover position
                            (first write into a shared block = copy-on-write)
    finish_prefill(slot)    chunked path: the slot joins the decode batch
                            (registers full prompt blocks for reuse)
    decode(params, …)       one fused step over the whole row set
    advance(slot)           host bookkeeping per emitted token
    finished(slot)          declared gen budget consumed?
    evict(slot)             return capacity (double-free is an error;
                            refcounted backends drop one reference)

The host swap tier (paged and int8 pools, `swap=True`): preemption calls
swap_out(slot), which copies the slot's blocks (and recurrent state rows)
to a HostSwapPool and evicts it; re-admission calls swap_in(rid), which
scatters them into fresh blocks, and decoding resumes where it stopped.
The slot pool has no host tier: its swap_out returns False and the engine
restart-preempts.

Over a DeviceMesh (an engine built with `mesh=`, serve/scheduler.py)
every backend is per rank: the same host bookkeeping on every rank
(tables, slots, reservations, the prefix index), and a device cache of
the rank's KV heads and state channels (models/model.py
init_paged_cache, init_cache). The host swap tier works per rank too:
each rank's backend copies out, and back, its own share of a victim's
blocks and state rows into its own HostSwapPool (one per rank, shared by
that rank's replicas), and since the budget counts blocks, every rank
accepts or declines the same swap (serve/blocks.py).
"""
from __future__ import annotations

from typing import (Any, Dict, List, Optional, Protocol,
                    runtime_checkable)

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.models.env import Env

Pytree = Any


@runtime_checkable
class KVBackend(Protocol):
    kind: str                 # registry name ("paged", "quant", "slot")
    num_slots: int
    caches: Pytree            # the device cache the backend owns
    chunk_prefill_ok: bool    # can prompts stream through decode lane rows?

    # -- admission / reservation -------------------------------------------
    def can_admit(self, gen_len: int, *, prompt=None) -> bool: ...
    def preempt_frees(self, slot: int, gen_len: int, *,
                      prompt=None) -> bool:
        """Would evicting `slot` make can_admit(gen_len, prompt=...) true?
        The engine asks before acting on a preemption verdict."""
        ...
    def admit(self, rid: int, gen_len: int, *, prefilling: bool = False,
              prompt=None) -> int: ...
    def cached_prefix_len(self, slot: int) -> int: ...
    def release(self) -> None:
        """Retire the backend: verify the free-list accounting returns to
        empty (leaks raise), then drop the device cache."""
        ...
    def drop_prefix_cache(self) -> None:
        """Forget every cached prefix block (an idle backend whose weights
        are about to change: set_params)."""
        ...
    def insert(self, slot: int, rid: int, prefill_caches: Pytree,
               gen_len: int) -> None: ...
    def ensure(self, slot: int, pos: int) -> None: ...
    def finish_prefill(self, slot: int) -> Any: ...
    def truncate(self, slot: int, n: int) -> None:
        """Roll the slot's committed KV back to its first `n` positions."""
        ...

    # -- the fused step ----------------------------------------------------
    def decode(self, params: Pytree, prev_tok, meta_i: np.ndarray,
               meta_f: np.ndarray, row_slots: np.ndarray, *,
               sample: bool):
        """Run one fused decode step over T rows (launch/steps.py packed
        metadata; row_slots[t] names the slot whose KV row t addresses,
        -1: masked). Returns the [T] int32 device token vector."""
        ...

    # -- per-token bookkeeping / retirement --------------------------------
    def advance(self, slot: int) -> Any: ...
    def finished(self, slot: int) -> bool: ...
    def evict(self, slot: int, *, zero: bool = False) -> None: ...

    # -- host swap tier (the slot pool declines) -----------------------------
    def swap_out(self, slot: int) -> bool:
        """Copy the slot's live KV to the host pool and evict it. False
        means the backend cannot swap (no pool / budget full /
        mid-prefill): the caller restart-preempts instead."""
        ...
    def has_swapped(self, rid: int) -> bool: ...
    def can_resume(self, rid: int) -> bool: ...
    def plan_resume(self, rid: int) -> bool:
        """Take (or confirm) a standing reservation for `rid`'s swap-in
        footprint, so fresh admissions queue behind the victim. At most
        one backend fleet-wide holds the plan; swap_in consumes it."""
        ...
    def cancel_resume_plans(self) -> None:
        """Release every standing resume reservation (drain / release: the
        swapped records stay in the shared pool for a live peer)."""
        ...
    def swap_in(self, rid: int) -> int:
        """Restore a swapped request into a fresh slot (inverse of
        swap_out); decoding resumes from the swap point bit-identically."""
        ...
    def drop_swapped(self, rid: int) -> None: ...

    # -- introspection ------------------------------------------------------
    def info(self, slot: int) -> Any: ...
    def rid_of(self, slot: int) -> int: ...
    def active_slots(self) -> List[int]: ...
    def occupied_slots(self) -> List[int]: ...
    @property
    def free_slot_count(self) -> int: ...
    @property
    def occupancy(self) -> float: ...
    @property
    def free_capacity(self) -> int:
        """Admission capacity still available, in the backend's own units
        (paged: unreserved blocks). Absolute, not a fraction — the
        router's load key uses it to break occupancy ties across
        heterogeneous pool sizes."""
        ...
    def probe_prefix(self, prompt) -> int:
        """Prompt positions an admission would serve from the backend's
        prefix cache right now (read-only; the prefix-affine router)."""
        ...
    def metrics(self) -> Dict[str, float]: ...
    def describe(self) -> str: ...


def make_kv_backend(kind: str, cfg: ModelConfig, env: Env, *, num_slots: int,
                    prompt_len: int, max_gen: int, block_size: int = 16,
                    kv_blocks: Optional[int] = None,
                    prefix_cache: bool = True,
                    max_shared_fraction: float = 1.0,
                    swap: bool = False,
                    swap_budget_blocks: Optional[int] = None,
                    swap_pool=None,
                    device="cuda") -> KVBackend:
    """The one cache-kind dispatch in the serving plane: "paged" (bf16
    block pool), "quant" (int8 block pool + per-row scales) or "slot" (a
    contiguous worst-case slot per request).

    swap=True attaches a host swap tier (serve/blocks.py HostSwapPool):
    pass a prebuilt `swap_pool` to share one across a fleet's replicas
    (ReplicaSet does), else a private pool is made with
    `swap_budget_blocks` capacity (None = unbounded). Over a DeviceMesh
    (env.mesh) the rank's backend, and its host pool the rank's."""
    from repro_torch.serve.blocks import (BlockManager, HostSwapPool,
                                          QuantBlockManager)
    from repro_torch.serve.slots import SlotPool

    if swap and swap_pool is None:
        swap_pool = HostSwapPool(swap_budget_blocks)
    elif not swap:
        swap_pool = None
    if kind in ("paged", "quant"):
        cls = QuantBlockManager if kind == "quant" else BlockManager
        return cls(cfg, env, num_slots=num_slots, prompt_len=prompt_len,
                   max_gen=max_gen, block_size=block_size,
                   num_blocks=kv_blocks, prefix_cache=prefix_cache,
                   max_shared_fraction=max_shared_fraction,
                   swap_pool=swap_pool, device=device)
    if kind == "slot":
        return SlotPool(cfg, env, num_slots=num_slots, prompt_len=prompt_len,
                        max_gen=max_gen, device=device)
    raise ValueError(f"unknown KV backend {kind!r} "
                     "(expected 'paged', 'quant', or 'slot')")
