"""SlotPool — a fixed-capacity, slot-addressed KV-cache backend.

Port of the JAX package's serve/slots.py. The pool owns one init_cache()
cache whose batch axis is the slot axis ([L, num_slots, Hkv,
prompt_len + max_gen, hd]), plus host-side bookkeeping: which request
occupies which slot, and each slot's write position.

This is the `kind="slot"` KVBackend (serve/kv.py): a worst-case
prompt_len + max_gen reservation per slot, the measured baseline for the
paged BlockManager. It cannot stream prompts through decode lane rows
(chunk_prefill_ok=False: a contiguous cache has no per-row tables to alias
a chunk onto), so admission is always classic batch-1 prefill + insert.
Decode reads the contiguous cache through the paged-decode kernel with the
identity table (one block of prompt_len + max_gen tokens per slot), so a
slot row and a paged row attend with the same arithmetic. Recurrent archs
(rwkv) keep their state in the pool's rows, row == slot, written whole by
insert; sliding-window ('local') archs are refused, as the JAX package's
slot pool refuses them.

The cache ops work in place on the pool's tensors. A step of more or
fewer rows than slots (speculative verify rows stacked past the slots; a
draft model's one row) runs the row-indirected step, which reads each
row's slot through a one-entry table of the same kernel. The pool has no
host swap tier: swap_out declines, and the engine restart-preempts.

Over a DeviceMesh (an engine built with `mesh=`) the pool is the rank's:
every slot (an engine's rows are whole on every rank) and its recurrent
channels or heads (Mo.init_cache whole_rows=True). Under the replicated
layout it holds the KV heads the rank's query heads read at every
position; under a seq_sharded plan every KV head at the rank's share of
the positions (the JAX package's row-slot branch over its seq-sharded
cache). There each row writes its K/V on the rank whose positions hold
its depth, and kernel #5 attends each row over its own slot at its own
depth on every rank, the ranks' partials merged over tp
(models/model.py _attn_seq_sharded). Where tp does not divide
prompt_len + max_gen, the slot is padded to the next multiple of tp:
the positions past prompt_len + max_gen - 1 are never valid (no depth
reaches them; the last one is the masked rows' write place). A classic
admission's prefill caches (every KV head at every prompt position,
models/model.py _prefill_sharded) are grown to the slot and cut to the
rank's positions on insert (Mo.grow_caches).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps as St
from repro_torch.models import model as Mo
from repro_torch.models.env import Env, sharded

Pytree = Any

FREE = -1  # rid_of value for an unoccupied slot


@dataclass
class SlotInfo:
    rid: int
    cur_len: int  # next decode write position for this slot
    tokens_done: int  # generated so far (prefill emits the first)
    gen_len: int


class SlotPool:
    kind = "slot"
    chunk_prefill_ok = False

    def __init__(self, cfg: ModelConfig, env: Env, *, num_slots: int,
                 prompt_len: int, max_gen: int, device="cuda"):
        if cfg.family == "vlm" or cfg.is_encdec:
            raise ValueError(
                f"{cfg.name}: continuous batching supports decoder-only "
                "archs (vlm/enc-dec prefill carries extra modalities)")
        Mo.check_supported(cfg)
        if "local" in cfg.block_pattern + cfg.pattern_tail:
            # sliding-window blocks keep a ring-aligned cache of size
            # min(window, seq); growing a prompt-sized ring to the pool's
            # ring size would scramble the slot = pos % w alignment
            raise ValueError(
                f"{cfg.name}: sliding-window ('local') blocks are not "
                "supported by the slot pool (ring-buffer caches cannot be "
                "grown after prefill)")
        # a slot's positions: a multiple of tp under a seq_sharded plan
        n = prompt_len + max_gen
        if sharded(cfg, env) and env.plan.kv_cache == "seq_sharded":
            n = -(-n // env.tp) * env.tp
        self.slot_len = n
        self.cfg = cfg
        self.env = env
        self.device = torch.device(device)
        self.num_slots = num_slots
        self.prompt_len = prompt_len
        self.max_gen = max_gen
        self.caches: Pytree = Mo.init_cache(cfg, env, num_slots,
                                            self.slot_len,
                                            device=self.device,
                                            whole_rows=True)
        self._slots: List[Optional[SlotInfo]] = [None] * num_slots
        self._free: Deque[int] = deque(range(num_slots))  # O(1) admission
        # two fused-step variants: an all-greedy batch runs the pure-argmax
        # step (no mask/Gumbel work); any sampling row selects the sampler
        self._decode = {s: St.make_fused_decode_step(
            cfg, env, prompt_len=prompt_len, sample=s) for s in (False, True)}

    # -- occupancy ---------------------------------------------------------
    @property
    def free_slot_count(self) -> int:
        return len(self._free)

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    def occupied_slots(self) -> List[int]:
        return self.active_slots()

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self._free) / max(self.num_slots, 1)

    @property
    def free_capacity(self) -> int:
        """Absolute admission headroom: free slots (each slot is a full
        worst-case reservation here)."""
        return len(self._free)

    def info(self, slot: int) -> Optional[SlotInfo]:
        return self._slots[slot]

    def rid_of(self, slot: int) -> int:
        s = self._slots[slot]
        return FREE if s is None else s.rid

    # -- admission / retirement --------------------------------------------
    def can_admit(self, gen_len: int, *, prompt=None) -> bool:
        return bool(self._free)  # no prefix cache: prompt can't help

    def preempt_frees(self, slot: int, gen_len: int, *,
                      prompt=None) -> bool:
        """A slot is worst-case reserved, so evicting any slot admits any
        request the engine already validated against max_gen."""
        return True

    def admit(self, rid: int, gen_len: int, *, prefilling: bool = False,
              prompt=None) -> int:
        """Bind a free slot for `rid`. The slot stays empty (info None)
        until insert() writes the prefilled cache; the pool has no
        chunked-prefill lanes, and a contiguous per-slot cache has nothing
        to share, so `prompt` is ignored."""
        assert not prefilling, "slot pool has no chunked-prefill lanes"
        return self._free.popleft()

    def cached_prefix_len(self, slot: int) -> int:
        """No prefix cache: every prompt position prefills."""
        return 0

    def probe_prefix(self, prompt) -> int:
        """No prefix cache: a router probe can never hit here."""
        return 0

    def drop_prefix_cache(self) -> None:
        """The slot pool keeps no prefix cache: nothing to drop."""

    def release(self) -> None:
        """Retire the pool (replica scale-down): every slot must be back
        on the free list — a leak raises — then the cache is dropped."""
        live = [i for i, s in enumerate(self._slots) if s is not None]
        if live:
            raise RuntimeError(f"release with occupied slots {live}")
        if len(self._free) != self.num_slots:
            raise RuntimeError(
                f"release leaked {self.num_slots - len(self._free)} slots "
                "(acquired but never evicted)")
        self.caches = None

    def insert(self, slot: int, rid: int, prefill_caches: Pytree,
               gen_len: int) -> None:
        """Bind `rid` to `slot` and write its prefilled (batch-1, length
        prompt_len) cache into the pool, grown to the pool's length (the
        rank's positions of it under a seq_sharded plan)."""
        assert self._slots[slot] is None, f"slot {slot} occupied"
        if slot in self._free:  # direct pool use (tests): claim this slot
            self._free.remove(slot)
        self.caches = Mo.cache_insert_slot(
            self.caches, Mo.grow_caches(
                prefill_caches, self.slot_len - self.prompt_len, self.cfg,
                self.env), slot)
        self._slots[slot] = SlotInfo(rid=rid, cur_len=self.prompt_len,
                                     tokens_done=1, gen_len=gen_len)

    def ensure(self, slot: int, pos: int) -> None:
        """Capacity is reserved wholesale at admission: nothing to grow."""

    def truncate(self, slot: int, n: int) -> None:
        """Rollback is free on a reserved contiguous cache: positions past
        the write cursor are never attended and are overwritten before the
        cursor reaches them."""

    def finish_prefill(self, slot: int) -> SlotInfo:
        raise NotImplementedError("slot pool has no chunked-prefill lanes")

    def evict(self, slot: int, *, zero: bool = False) -> None:
        """Free `slot`. Insert overwrites a whole slot, so zeroing is only
        hygiene (tests check that evicted slots hold no stale KV)."""
        if self._slots[slot] is not None:
            self._free.append(slot)
        self._slots[slot] = None
        if zero:
            self.caches = Mo.cache_evict_slot(self.caches, slot)

    # -- host swap tier: none (a worst-case reservation has no partial
    # progress worth keeping at block granularity); the engine's swap path
    # falls back to restart preemption on False -------------------------------
    def swap_out(self, slot: int) -> bool:
        return False

    def has_swapped(self, rid: int) -> bool:
        return False

    def can_resume(self, rid: int) -> bool:
        return False

    def plan_resume(self, rid: int) -> bool:
        return False

    def cancel_resume_plans(self) -> None:
        pass

    def swap_in(self, rid: int) -> int:
        raise NotImplementedError("slot pool has no host swap tier")

    def drop_swapped(self, rid: int) -> None:
        pass

    # -- the fused step -------------------------------------------------------
    def decode(self, params, prev_tok, meta_i, meta_f, row_slots, *,
               sample: bool):
        """One fused step over the contiguous pool. With T == num_slots
        rows, row t is slot t (free slots decode junk into their own,
        unattended rows) and row_slots is not read; any other T (verify
        rows past the slots, a drafter's one row) runs the row-indirected
        step, row_slots mapping each row onto its slot (-1 masks)."""
        dev = self.device
        mi = torch.as_tensor(meta_i, device=dev)
        mf = torch.as_tensor(meta_f, device=dev)
        rs = (None if meta_i.shape[1] == self.num_slots else
              torch.as_tensor(row_slots, device=dev))
        nxt, self.caches = self._decode[sample](params, self.caches,
                                                prev_tok, mi, mf, rs)
        return nxt

    # -- decode-batch views ---------------------------------------------------
    def advance(self, slot: int) -> SlotInfo:
        """Record one decoded token for `slot`; returns the updated info."""
        s = self._slots[slot]
        assert s is not None
        s.cur_len += 1
        s.tokens_done += 1
        return s

    def finished(self, slot: int) -> bool:
        s = self._slots[slot]
        return s is not None and s.tokens_done >= s.gen_len

    # -- reporting ----------------------------------------------------------
    def metrics(self) -> Dict[str, float]:
        return {}

    def describe(self) -> str:
        return (f"slot KV: {self.num_slots} slots x "
                f"{self.prompt_len + self.max_gen} reserved tokens")

    # -- introspection (tests) ----------------------------------------------
    def read_slot(self, slot: int) -> Pytree:
        return Mo.cache_read_slot(self.caches, slot)
