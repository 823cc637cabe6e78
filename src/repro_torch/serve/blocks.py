"""BlockManager — a paged KV cache: global block pool + per-request tables.

Port of the JAX package's serve/blocks.py. The
BlockManager owns a global pool of fixed-size KV blocks
(Mo.init_paged_cache) on the serving device and a host-side
[num_slots, MB] block table per request; blocks are allocated on demand as
a request's cur_len crosses block boundaries and returned to an O(1) free
list at retirement, so resident KV tracks what requests actually wrote.

Admission is gated by *reservation*: a request reserves (but does not yet
allocate) the blocks its declared gen_len can ever need, so on-demand
allocation can never deadlock mid-decode and block exhaustion surfaces as
clean queue backpressure at admit time.

Physical block 0 is the null block: never allocated, it absorbs the writes
of masked rows (free slots / idle prefill lanes) in the fused decode step.

Prefix caching (copy-on-write sharing): full prompt blocks are
content-addressed by a per-block hash *chain* (h_j = H(h_{j-1} ||
tokens_j), so a block hash commits to its whole prefix); a request whose
prompt chain hits the index admits with its table pointing at the shared
physical blocks, and those prefill positions are never recomputed (the
engine starts its lanes at `cached_len`). Sharing is refcounted: a block
returns to the pool only when its last reference drops, and registered
blocks whose refcount hits zero are *retained* in a reclaim list (still
KV-valid, still admission capacity) until the free list runs dry; reclaim
takes the block with the fewest lifetime hits, LRU breaking ties. The
first write into a still-shared block — only ever the boundary block of a
fully-cached prompt — copies it into a fresh block first
(Mo.make_paged_copy), so two requests sharing a prefix never observe each
other's writes. Double frees raise before the free list is poisoned.

Two ways in: chunked prefill streams a prompt through lane rows of the
decode step (admit(prefilling=True) ... finish_prefill); classic admission
scatters a batch-1 prefill's K/V into the slot's blocks (insert).

Hybrid and recurrent archs: sliding-window ('local') units keep a ring of
the trailing window in a second, window-sized table per request
(table_local, ceil(min(window, prompt + gen) / block_size) blocks,
allocated on demand like the global table and freed at release);
recurrent units (rglru, rwkv) keep their state in pool rows pinned to the
slot (decode row == slot). Both admit only by classic prefill + insert:
recurrent state is sequential over the prompt and ring writes would wrap
onto each other within a chunk, so chunk_prefill_ok is False there, and
the prefix cache (global blocks only) is off.

QuantBlockManager (`--kv quant`) is the same bookkeeping over an int8
pool with per-row f32 scales, for archs of global attention blocks
(attn and moe).

The host swap tier (HostSwapPool, `swap=True`): preemption copies a
victim's blocks (global and ring tables, the int8 pool's scales, the
recurrent state row) into CPU tensors — pinned where the pool is on the
card, through a synchronising copy — and evicts the slot; re-admission
scatters them into fresh blocks and a free slot's state row, and decoding
resumes where it stopped with nothing recomputed. One host pool may serve
a whole fleet (serve/router.py), so a request drained off one replica
resumes on another.

Over a DeviceMesh (an engine built with `mesh=`) the manager is the
rank's: the host side (tables, refcounts, reservations, the prefix index)
is the same on every rank, and the pool holds every block with the KV
heads the rank's query heads read and state rows of its channels or
heads (Mo.init_paged_cache); a classic insert scatters the rank's
prefill cache, which holds the same heads and channels. The host swap
tier copies the rank's own share of a victim: the KV heads of its pool
(and the int8 pool's scales at those heads) and its state channels, into
pinned host memory of the rank's own HostSwapPool. The budget counts
blocks, which the host bookkeeping keeps the same on every rank, so
every rank accepts or declines the same swap and the host state stays
the same on every rank. swap_out_bytes / swap_in_bytes count the bytes
this rank copied, its share: over tp ranks that split the KV heads and
channels evenly, 1 / tp of the logical blocks' bytes the JAX package
counts (its payload is the whole, gathered array).

Left out of the port so far: the int8 pool for window or recurrent archs.
"""
from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_decode import ops as pd_ops
from repro_torch.launch import steps as St
from repro_torch.models import model as Mo
from repro_torch.models.env import Env

Pytree = Any

FREE = -1


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass
class PagedSlot:
    rid: int
    cur_len: int  # next decode write position
    tokens_done: int
    gen_len: int
    plen: int = 0  # the request's own prompt length (0: engine prompt_len)
    prefilling: bool = False  # still consuming prompt chunks (lane rows)
    alloc_g: int = 0  # table entries bound so far (shared + private)
    alloc_l: int = 0  # window-ring table entries bound so far
    reserved: int = 0  # blocks reserved but not yet allocated
    cached_len: int = 0  # prompt tokens served from the prefix cache
    shared_g: int = 0  # leading table entries referencing shared blocks
    hashes: Tuple[bytes, ...] = ()  # prompt block hash chain (full blocks)


@dataclass
class SwapRecord:
    """One swapped-out request: its blocks' KV pulled into host tensors
    plus the PagedSlot bookkeeping that rebuilds the slot on swap-in."""
    rid: int
    payload: Any  # CPU tensor tree congruent to the pool, block dim = n
    n_blocks: int
    nbytes: int
    cur_len: int
    tokens_done: int
    gen_len: int
    reserved: int
    cached_len: int
    alloc_g: int
    alloc_l: int
    plen: int = 0


class HostSwapPool:
    """Host-side KV block pool — the swap tier under the device pool.
    Preemption copies a victim's blocks out instead of discarding them;
    re-admission scatters them back and decoding resumes from the swap
    point bit-identically (no recompute). One pool may be shared across a
    ReplicaSet's replicas (host RAM is node-local), so a request drained
    off one replica can restore on another.

    `budget_blocks` caps host residency (a full budget makes swap_out
    decline, and the engine restart-preempts); the last backend to detach
    leak-checks that every swapped request was restored or dropped."""

    def __init__(self, budget_blocks: Optional[int] = None):
        if budget_blocks is not None and budget_blocks < 0:
            raise ValueError(f"budget_blocks must be >= 0 or None, got "
                             f"{budget_blocks}")
        self.budget_blocks = budget_blocks  # None = unbounded
        self._records: Dict[int, SwapRecord] = {}
        self._attached = 0
        # resume-plan ownership: at most one backend fleet-wide holds a
        # standing re-admission reservation for a swapped rid (two
        # replicas reserving one victim's footprint would double-commit
        # fleet capacity for one resume)
        self._planned: Dict[int, Any] = {}

    @property
    def blocks_resident(self) -> int:
        return sum(r.n_blocks for r in self._records.values())

    @property
    def bytes_resident(self) -> int:
        return sum(r.nbytes for r in self._records.values())

    def can_store(self, n_blocks: int) -> bool:
        return (self.budget_blocks is None
                or self.blocks_resident + n_blocks <= self.budget_blocks)

    def store(self, rec: SwapRecord) -> None:
        assert rec.rid not in self._records, \
            f"rid {rec.rid} is already swapped out"
        assert self.can_store(rec.n_blocks), "host swap budget exhausted"
        self._records[rec.rid] = rec

    def has(self, rid: int) -> bool:
        return rid in self._records

    def peek(self, rid: int) -> SwapRecord:
        return self._records[rid]

    def take(self, rid: int) -> SwapRecord:
        """Remove and return `rid`'s record (swap-in frees host residency)."""
        self._planned.pop(rid, None)
        return self._records.pop(rid)

    def drop(self, rid: int) -> None:
        """Discard a swapped request (cancelled / restarted): its host
        blocks free without a restore."""
        self._planned.pop(rid, None)
        self._records.pop(rid, None)

    # -- resume-plan ownership ------------------------------------------------
    def plan(self, rid: int, owner: Any) -> None:
        cur = self._planned.get(rid)
        assert cur is None or cur is owner, \
            f"rid {rid} already has a resume plan on another backend"
        self._planned[rid] = owner

    def planner(self, rid: int) -> Optional[Any]:
        return self._planned.get(rid)

    def unplan(self, rid: int) -> None:
        self._planned.pop(rid, None)

    def attach(self) -> None:
        self._attached += 1

    def detach(self) -> None:
        """A backend released its device pool. When the last one detaches
        the host pool must be empty: a swapped request nobody can restore
        is a leak, as a lost device block is."""
        self._attached -= 1
        if self._attached <= 0 and self._records:
            held = sorted(self._records)
            raise RuntimeError(
                f"host swap pool leaked {len(held)} swapped request(s) "
                f"{held} ({self.blocks_resident} blocks) at last detach")


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t`: pinned memory filled by a synchronising copy
    from the card (the copy has landed when this returns; a non-blocking
    copy read early would be silent corruption), a plain clone on the
    CPU."""
    if t.device.type != "cuda":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _tree_nbytes(tree) -> int:
    return sum(x.numel() * x.element_size()
               for unit in tree["blocks"] + tree["tail"]
               for x in unit.values())


class BlockManager:
    kind = "paged"
    _quant = False  # int8 pool + scales (QuantBlockManager)

    def __init__(self, cfg: ModelConfig, env: Env, *, num_slots: int,
                 prompt_len: int, max_gen: int, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 max_shared_fraction: float = 1.0,
                 swap_pool: Optional[HostSwapPool] = None,
                 device="cuda"):
        if cfg.family == "vlm" or cfg.is_encdec:
            raise ValueError(
                f"{cfg.name}: continuous batching supports decoder-only "
                "archs (vlm/enc-dec prefill carries extra modalities)")
        Mo.check_supported(cfg)
        self.cfg = cfg
        self.env = env
        self.device = torch.device(device)
        self.num_slots = num_slots
        self.prompt_len = prompt_len
        self.max_gen = max_gen
        self.block_size = block_size
        kinds = set(cfg.block_pattern) | set(cfg.pattern_tail)
        self.window = cfg.local_window
        self.has_global = bool(kinds & {"attn", "moe"})
        self.has_local = "local" in kinds
        # recurrent state rows pin the decode batch to slot == row
        self.has_state = bool(kinds & set(Mo.RECURRENT_KINDS))
        # recurrent state cannot parallelize a prompt chunk inside one
        # step, and ring writes would wrap onto each other within a chunk
        # (rows p and p + w share ring slot p % w): both admit by batch-1
        # prefill + insert instead
        self.chunk_prefill_ok = not self.has_state and not self.has_local
        bs = block_size
        max_kv = prompt_len + max_gen  # last written pos < prompt+gen-1
        self.mb_global = _ceil_div(max_kv, bs) if self.has_global else 0
        self.mb_local = (_ceil_div(min(self.window, max_kv), bs)
                         if self.has_local else 0)
        worst = num_slots * (self.mb_global + self.mb_local)
        self.num_blocks = (num_blocks if num_blocks is not None
                           else worst + 1)  # + null
        if self.num_blocks < 1 + self.mb_global + self.mb_local:
            raise ValueError(
                f"num_blocks={self.num_blocks} cannot hold even one request "
                f"({self.mb_global}+{self.mb_local} blocks + null)")
        self.caches: Pytree = Mo.init_paged_cache(
            cfg, env, self.num_blocks, bs, num_rows=num_slots,
            quant=self._quant, device=self.device)
        # the host swap tier (may be shared fleet-wide); its counters are
        # this backend's own traffic, so a fleet rollup can sum them
        self.swap_pool = swap_pool
        if swap_pool is not None:
            swap_pool.attach()
        self._swap_out_bytes = 0
        self._swap_in_bytes = 0
        self._swapped_blocks = 0
        # rid -> blocks held reserved here for its planned swap-in
        # (counted in _reserved_total)
        self._resume_plans: Dict[int, int] = {}
        # host-side tables: row per slot, 0 = unallocated (null block)
        self.table = np.zeros((num_slots, max(self.mb_global, 1)), np.int32)
        self.table_local = np.zeros((num_slots, max(self.mb_local, 1)),
                                    np.int32)
        self._slots: List[Optional[PagedSlot]] = [None] * num_slots
        self._free_slots: Deque[int] = deque(range(num_slots))
        self._free_blocks: Deque[int] = deque(range(1, self.num_blocks))
        # mirror of _free_blocks for the O(1) double-free guard: a block id
        # returned twice would sit in the free list twice and get handed to
        # two requests, silently cross-writing their KV
        self._free_block_set: Set[int] = set(self._free_blocks)
        self._reserved_total = 0  # blocks promised to admitted requests
        # sharing applies to global tables only: a window ring rewrites
        # positions in place and recurrent state is not content-addressable
        self.prefix_cache = (bool(prefix_cache) and self.has_global
                             and self.chunk_prefill_ok)
        if not 0.0 <= max_shared_fraction <= 1.0:
            raise ValueError(f"max_shared_fraction must be in [0, 1], got "
                             f"{max_shared_fraction}")
        self.max_shared_fraction = float(max_shared_fraction)
        self._ref = np.zeros(self.num_blocks, np.int64)  # table references
        self._cached: Dict[bytes, int] = {}   # prefix-chain hash -> block id
        self._hash_of: Dict[int, bytes] = {}  # registered block -> its hash
        self._hits: Dict[int, int] = {}  # registered block -> cache hits
        # registered blocks whose last reference dropped: still KV-valid,
        # still admission capacity. Values are insertion sequence numbers:
        # reclaim pops the fewest-hits entry, LRU breaking ties.
        self._reclaim: Dict[int, int] = {}
        self._reclaim_seq = 0
        self._hit_tokens = 0     # prompt tokens served from the cache
        self._lookup_tokens = 0  # prompt tokens probed at admission
        self._cow_copies = 0
        # one-entry probe memo: a backpressured queue head re-probes every
        # scheduler step — don't re-hash the prompt each time. Invalidated
        # whenever the index changes.
        self._probe_memo: Optional[Tuple[bytes, tuple]] = None
        self._insert = Mo.make_paged_insert(cfg, bs)
        self._copy = Mo.make_paged_copy(cfg)
        self._evict = Mo.make_paged_evict(cfg)
        self._read = Mo.make_paged_read(cfg)
        # two fused-step variants: an all-greedy batch runs the pure-argmax
        # step (no mask/Gumbel work); any sampling row selects the sampler
        self._decode = {s: St.make_paged_decode_step(
            cfg, env, prompt_len=prompt_len, sample=s) for s in (False, True)}

    # -- sizing / admission math -------------------------------------------
    def blocks_for(self, gen_len: int, plen: Optional[int] = None) -> int:
        """Physical blocks a request with this gen_len can ever touch (its
        KV spans positions [0, plen + gen_len - 1))."""
        kv = max((plen or self.prompt_len) + gen_len - 1, 1)
        n = _ceil_div(kv, self.block_size) if self.has_global else 0
        if self.has_local:
            n += _ceil_div(min(self.window, kv), self.block_size)
        return n

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    @property
    def free_unreserved(self) -> int:
        """Free + reclaimable (cache-retained, refcount 0) minus promised
        reservations — the capacity admission may still hand out."""
        return (len(self._free_blocks) + len(self._reclaim)
                - self._reserved_total)

    def _prompt_hashes(self, prompt) -> Tuple[bytes, ...]:
        """Content-hash chain over the prompt's *full* blocks. blake2b,
        not Python hash(): a collision here would silently serve one
        request another's KV."""
        bs = self.block_size
        toks = np.ascontiguousarray(np.asarray(prompt, np.int32))
        h = b"paged-prefix-root"
        out = []
        for j in range(len(toks) // bs):
            m = hashlib.blake2b(h, digest_size=16)
            m.update(toks[j * bs:(j + 1) * bs].tobytes())
            h = m.digest()
            out.append(h)
        return tuple(out)

    def _probe(self, prompt) -> Tuple[Tuple[bytes, ...], int, int, int]:
        """(hashes, shared, cached_len, cow): how much of `prompt` the
        cache already holds. cached_len is capped at len(prompt) - 1 — the
        last prompt token always runs (its logits emit the first generated
        token), so a fully-cached prompt keeps exactly one lane row and its
        write into the shared boundary block is the copy-on-write case
        (cow=1 reserves the fresh block that copy will need)."""
        if prompt is None or not self.prefix_cache:
            return (), 0, 0, 0
        key = np.ascontiguousarray(np.asarray(prompt, np.int32)).tobytes()
        if self._probe_memo is not None and self._probe_memo[0] == key:
            return self._probe_memo[1]
        hashes = self._prompt_hashes(prompt)
        shared = 0
        for h in hashes:
            if h not in self._cached:
                break
            shared += 1
        cached_len = min(shared * self.block_size, len(prompt) - 1)
        cow = 1 if shared * self.block_size > cached_len else 0
        self._probe_memo = (key, (hashes, shared, cached_len, cow))
        return hashes, shared, cached_len, cow

    def can_admit(self, gen_len: int, *, prompt=None) -> bool:
        """With `prompt`, admission is prefix-aware: shared blocks cost no
        fresh capacity, except that resurrecting a reclaimable block (and
        the one copy-on-write block of a fully-cached prompt) re-commits
        physical capacity the reservation math must still cover."""
        if not self._free_slots:
            return False
        hashes, shared, _, cow = self._probe(prompt)
        resurrect = sum(1 for h in hashes[:shared]
                        if self._ref[self._cached[h]] == 0)
        plen = len(prompt) if prompt is not None else None
        need = self.blocks_for(gen_len, plen) - shared + cow + resurrect
        return need <= self.free_unreserved

    def preempt_frees(self, slot: int, gen_len: int, *,
                      prompt=None) -> bool:
        """Evicting `slot` frees its unspent reservation plus every block
        it holds the *last* reference to — admit iff that covers the
        candidate's (prefix-discounted) need."""
        s = self._slots[slot]
        assert s is not None
        vblocks = {int(self.table[slot, j]) for j in range(s.alloc_g)}
        vblocks |= {int(self.table_local[slot, j])
                    for j in range(s.alloc_l)}
        freed = s.reserved + sum(  # replint: ignore[R001] -- order-insensitive reduction: sum over the set is the same for any iteration order
            1 for b in vblocks if self._ref[b] == 1)
        hashes, shared, _, cow = self._probe(prompt)
        resurrect = 0
        for h in hashes[:shared]:
            bid = self._cached[h]
            if self._ref[bid] == 0 or (self._ref[bid] == 1
                                       and bid in vblocks):
                resurrect += 1
        plen = len(prompt) if prompt is not None else None
        need = self.blocks_for(gen_len, plen) - shared + cow + resurrect
        return need <= self.free_unreserved + freed

    # -- occupancy ----------------------------------------------------------
    def active_slots(self) -> List[int]:
        """Slots in the decode batch (prefilling slots ride lane rows)."""
        return [i for i, s in enumerate(self._slots)
                if s is not None and not s.prefilling]

    def occupied_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is not None]

    @property
    def free_slot_count(self) -> int:
        return len(self._free_slots)

    @property
    def occupancy(self) -> float:
        return 1.0 - len(self._free_slots) / max(self.num_slots, 1)

    @property
    def free_capacity(self) -> int:
        """Absolute admission headroom: unreserved blocks (slots are
        rarely the binding constraint on a paged pool)."""
        return max(self.free_unreserved, 0)

    @property
    def blocks_in_use(self) -> int:
        """Blocks referenced by live requests (cache-retained blocks with
        no referents are reclaimable capacity, not use)."""
        return (self.usable_blocks - len(self._free_blocks)
                - len(self._reclaim))

    @property
    def block_occupancy(self) -> float:
        """Fraction of the pool committed (allocated + reserved) — the
        admission-honest load signal published to the autoscaler."""
        committed = self.blocks_in_use + self._reserved_total
        return committed / max(self.usable_blocks, 1)

    def info(self, slot: int) -> Optional[PagedSlot]:
        return self._slots[slot]

    def rid_of(self, slot: int) -> int:
        s = self._slots[slot]
        return FREE if s is None else s.rid

    # -- admission / allocation --------------------------------------------
    def admit(self, rid: int, gen_len: int, *, prefilling: bool = False,
              prompt=None) -> int:
        """Reserve a slot + the request's worst-case blocks; allocation
        itself happens on demand via ensure(). Returns the slot. With
        `prompt`, hit blocks of the prefix cache are attached (refcounted)
        to the slot's table and `cached_len` records how many prompt
        positions never need a prefill lane."""
        use_prefix = prefilling and prompt is not None
        assert self.can_admit(gen_len, prompt=prompt if use_prefix else None)
        slot = self._free_slots.popleft()
        plen = len(prompt) if prompt is not None else self.prompt_len
        need = self.blocks_for(gen_len, plen)
        hashes, shared, cached_len, cow = (
            self._probe(prompt) if use_prefix else ((), 0, 0, 0))
        s = PagedSlot(rid=rid, cur_len=0, tokens_done=0, gen_len=gen_len,
                      plen=plen, prefilling=prefilling,
                      reserved=need - shared + cow,
                      cached_len=cached_len, shared_g=shared, hashes=hashes)
        self._slots[slot] = s
        for j in range(shared):
            self._attach(slot, j, self._cached[hashes[j]])
        s.alloc_g = shared
        self._reserved_total += s.reserved
        if use_prefix and self.prefix_cache:
            self._lookup_tokens += len(prompt)
            self._hit_tokens += cached_len
        return slot

    def _attach(self, slot: int, j: int, bid: int) -> None:
        """Point table entry j at shared block `bid` (incref; resurrect it
        from the reclaim list if its last holder already retired)."""
        if self._ref[bid] == 0:
            del self._reclaim[bid]
        self._ref[bid] += 1
        self._hits[bid] = self._hits.get(bid, 0) + 1
        self.table[slot, j] = bid

    def _unregister_coldest(self) -> int:
        """Pop the reclaimable block with the fewest lifetime cache hits
        (LRU insertion order breaks ties) and drop its index entry."""
        bid = min(self._reclaim,
                  key=lambda b: (self._hits.get(b, 0), self._reclaim[b]))
        del self._reclaim[bid]
        del self._cached[self._hash_of.pop(bid)]
        self._hits.pop(bid, None)
        self._probe_memo = None  # the index shrank; memoized hits may lie
        return bid

    def _take_block(self) -> int:
        """A fresh physical block: the free list first, else reclaim the
        coldest cache-retained block."""
        if self._free_blocks:
            bid = self._free_blocks.popleft()
            self._free_block_set.discard(bid)
            return bid
        return self._unregister_coldest()

    def _release(self, bid: int) -> bool:
        """Drop one reference to `bid`; returns True iff the block went
        back to the free list (registered blocks are retained)."""
        self._ref[bid] -= 1
        if self._ref[bid] > 0:
            return False
        if bid in self._hash_of:
            self._reclaim[bid] = self._reclaim_seq
            self._reclaim_seq += 1
            return False
        self._free_blocks.append(bid)
        self._free_block_set.add(bid)
        return True

    def _alloc(self, slot: int, local: bool = False) -> None:
        s = self._slots[slot]
        bid = self._take_block()
        self._ref[bid] = 1
        if local:
            self.table_local[slot, s.alloc_l] = bid
            s.alloc_l += 1
        else:
            self.table[slot, s.alloc_g] = bid
            s.alloc_g += 1
        s.reserved -= 1
        self._reserved_total -= 1
        assert s.reserved >= 0, "request outgrew its reservation"

    def _cow(self, slot: int, j: int) -> None:
        """Copy-on-write: `slot` is about to write into shared table entry
        j. Copy the block's KV into a fresh block (reserved at admission),
        repoint the table, drop the shared reference."""
        s = self._slots[slot]
        old = int(self.table[slot, j])
        new = self._take_block()
        self._ref[new] = 1
        self.caches = self._copy(self.caches, old, new)
        self.table[slot, j] = new
        s.shared_g = j
        s.reserved -= 1
        self._reserved_total -= 1
        assert s.reserved >= 0, "copy-on-write outgrew its reservation"
        self._cow_copies += 1
        self._release(old)

    def ensure(self, slot: int, pos: int) -> None:
        """Allocate blocks so `slot` can write KV at logical position
        `pos` (and its window-ring position). Writes are strictly
        sequential from cached_len, so the only write that can land in a
        shared block is the first one past a partially-cached boundary —
        the copy-on-write trigger."""
        s = self._slots[slot]
        assert s is not None
        bs = self.block_size
        if self.has_global:
            if s.shared_g * bs > s.cached_len and pos >= s.cached_len:
                self._cow(slot, s.shared_g - 1)
            while s.alloc_g < pos // bs + 1:
                self._alloc(slot)
        if self.has_local:
            ring_hi = min(pos, self.window - 1)
            while s.alloc_l < ring_hi // bs + 1:
                self._alloc(slot, local=True)

    def truncate(self, slot: int, n: int) -> None:
        """Roll `slot`'s committed KV back to its first `n` positions:
        blocks wholly past position n-1 go back through _release and their
        reservation is re-credited. Never reaches shared prefix blocks."""
        s = self._slots[slot]
        assert s is not None and not s.prefilling
        keep = _ceil_div(n, self.block_size)
        assert keep >= s.shared_g, \
            f"truncate({n}) would free shared prefix blocks of slot {slot}"
        for j in range(keep, s.alloc_g):
            self._release(int(self.table[slot, j]))
            self.table[slot, j] = 0
            s.reserved += 1
            self._reserved_total += 1
        s.alloc_g = min(s.alloc_g, keep)

    def insert(self, slot: int, rid: int, prefill_caches: Pytree,
               gen_len: int) -> None:
        """Classic admission: bind `rid` to `slot` (taken by admit, or
        claimed here for direct pool use) and scatter the batch-1 prefill
        cache into the slot's blocks: global k/v ([L,1,Hkv,prompt_len,hd])
        through its table, window rings through its ring table, recurrent
        state into the slot's rows."""
        if self._slots[slot] is None:
            # direct pool use (tests): take this specific slot
            assert self.can_admit(gen_len), "block pool exhausted"
            self._free_slots.remove(slot)
            need = self.blocks_for(gen_len)
            self._slots[slot] = PagedSlot(rid=rid, cur_len=0, tokens_done=0,
                                          gen_len=gen_len, reserved=need)
            self._reserved_total += need
        s = self._slots[slot]
        assert s.shared_g == 0, \
            "classic insert scatters the whole prompt; it cannot target a " \
            "slot admitted with shared prefix blocks"
        s.rid = rid
        s.plen = self.prompt_len  # classic prefill scatters the full shape
        self.ensure(slot, self.prompt_len - 1)
        tg, tl = self._tables_of(slot)
        self.caches = self._insert(self.caches, prefill_caches, tg, slot, tl)
        s.cur_len = self.prompt_len
        s.tokens_done = 1
        s.prefilling = False

    def _tables_of(self, slot: int):
        dev = self.device
        return (torch.as_tensor(self.table[slot], device=dev),
                torch.as_tensor(self.table_local[slot], device=dev))

    def finish_prefill(self, slot: int) -> PagedSlot:
        """Chunked prefill consumed the whole prompt: the slot joins the
        decode batch. Its full prompt blocks now hold valid KV — register
        any not yet in the prefix index so later identical prefixes hit."""
        s = self._slots[slot]
        assert s is not None and s.prefilling
        s.prefilling = False
        s.cur_len = s.plen or self.prompt_len
        s.tokens_done = 1
        if self.prefix_cache:
            cap = int(self.max_shared_fraction * self.usable_blocks)
            for j, h in enumerate(s.hashes):
                if h in self._cached:
                    continue
                if len(self._hash_of) >= cap:
                    # residency cap: make room by unregistering the coldest
                    # reclaimable entry, else this block stays private
                    if not self._reclaim:
                        continue
                    freed = self._unregister_coldest()
                    self._free_blocks.append(freed)
                    self._free_block_set.add(freed)
                bid = int(self.table[slot, j])
                self._cached[h] = bid
                self._hash_of[bid] = h
                self._hits.setdefault(bid, 0)
                self._probe_memo = None  # the index grew; re-probe
        return s

    # -- the fused step -------------------------------------------------------
    def decode(self, params, prev_tok, meta_i, meta_f, row_slots, *,
               sample: bool):
        """One fused step over the block pool. row_slots[t] names the slot
        whose table row t addresses (decode rows: the slot itself; prefill
        lane rows: the admitting slot; -1: masked row -> null table)."""
        rs = np.asarray(row_slots)
        safe = np.clip(rs, 0, self.num_slots - 1)
        live = (rs >= 0)[:, None]
        dev = self.device
        tables = {"global": torch.as_tensor(
            np.where(live, self.table[safe], 0), device=dev)}
        if self.has_local:
            tables["local"] = torch.as_tensor(
                np.where(live, self.table_local[safe], 0), device=dev)
        nxt, self.caches = self._decode[sample](
            params, self.caches, prev_tok, torch.as_tensor(meta_i, device=dev),
            torch.as_tensor(meta_f, device=dev), tables)
        return nxt

    # -- decode-batch views -------------------------------------------------
    def advance(self, slot: int) -> PagedSlot:
        s = self._slots[slot]
        assert s is not None and not s.prefilling
        s.cur_len += 1
        s.tokens_done += 1
        return s

    def finished(self, slot: int) -> bool:
        s = self._slots[slot]
        return (s is not None and not s.prefilling
                and s.tokens_done >= s.gen_len)

    # -- retirement ---------------------------------------------------------
    def evict(self, slot: int, *, zero: bool = False) -> None:
        """Free `slot`: drop one reference per table entry. Zeroing is
        hygiene only (tests) and skips blocks that stay shared or cached.
        Double frees are hard errors, not silent corruption."""
        s = self._slots[slot]
        if s is None:
            raise RuntimeError(
                f"double free: slot {slot} is already free (its block "
                "table was returned to the pool once)")
        freeing_g = [int(self.table[slot, j]) for j in range(s.alloc_g)]
        freeing_l = [int(self.table_local[slot, j])
                     for j in range(s.alloc_l)]
        freeing = freeing_g + freeing_l
        dup = [b for b in freeing
               if b in self._free_block_set or self._ref[b] <= 0]
        if len(set(freeing)) != len(freeing):  # within-table alias
            dup += [b for b in sorted(set(freeing)) if freeing.count(b) > 1]
        if dup:
            raise RuntimeError(
                f"double free: slot {slot} block table names free block(s) "
                f"{sorted(set(dup))} — the free list would hand them to "
                "two requests")
        if zero:
            # only blocks this eviction returns to the free list may be
            # zeroed; shared or cache-retained blocks keep their KV
            dropping = {b for b in freeing
                        if self._ref[b] == 1 and b not in self._hash_of}
            dev = self.device
            keep = lambda ids: torch.as_tensor(
                [b for b in ids if b in dropping], dtype=torch.int64,
                device=dev)
            self.caches = self._evict(self.caches, keep(freeing_g), slot,
                                      keep(freeing_l))
        for b in freeing:
            self._release(b)
        self.table[slot, :] = 0
        self.table_local[slot, :] = 0
        self._reserved_total -= s.reserved
        self._slots[slot] = None
        self._free_slots.append(slot)

    # -- host swap tier ------------------------------------------------------
    def _swap_gather(self, slot: int, gids, lids) -> Pytree:
        """`slot`'s named blocks (global table ids `gids`, ring ids
        `lids`; quant scales alongside) and its state rows, copied into
        host tensors: a tree congruent to the pool with the block dim
        shrunk to n and the row dim to 1."""
        dev = self.device
        gi = torch.as_tensor(np.asarray(gids, np.int64), device=dev)
        li = torch.as_tensor(np.asarray(lids, np.int64), device=dev)
        out = {"blocks": [], "tail": []}
        for kind, unit, st in Mo._units(self.cfg, self.caches):
            d = {}
            for name, leaf in Mo._layer_views(unit, st).items():
                if kind in Mo.RECURRENT_KINDS:
                    g = leaf[:, slot:slot + 1]
                else:
                    g = leaf[:, li if kind == "local" else gi]
                d[name] = _to_host(g if st else g[0])
            out["blocks" if st else "tail"].append(d)
        return {k: tuple(v) for k, v in out.items()}

    def _swap_scatter(self, slot: int, gids, lids, payload: Pytree) -> None:
        """Write a host payload into the blocks `gids` / `lids` and the
        state rows of `slot` (the inverse of _swap_gather, at new physical
        ids and possibly another slot)."""
        dev = self.device
        gi = torch.as_tensor(np.asarray(gids, np.int64), device=dev)
        li = torch.as_tensor(np.asarray(lids, np.int64), device=dev)
        for (kind, unit, st), (_, src_u, _) in zip(
                Mo._units(self.cfg, self.caches),
                Mo._units(self.cfg, payload)):
            for name, leaf in Mo._layer_views(unit, st).items():
                src = src_u[name].to(dev)
                src = src if st else src[None]
                if kind in Mo.RECURRENT_KINDS:
                    leaf[:, slot:slot + 1] = src
                else:
                    leaf[:, li if kind == "local" else gi] = src

    def swap_out(self, slot: int) -> bool:
        """Copy `slot`'s live KV (every allocated block, its state rows)
        to the host pool, then evict the slot. Returns False — the caller
        restart-preempts — when no host pool is attached, the budget is
        exhausted, or the slot is still prefilling (partial-prompt lane
        state does not restore). Shared prefix blocks are copied too: the
        restore allocates private blocks, trading dedup for zero
        recompute (the index keeps the originals)."""
        if self.swap_pool is None:
            return False
        s = self._slots[slot]
        assert s is not None
        if s.prefilling:
            return False
        n_blocks = s.alloc_g + s.alloc_l
        if not self.swap_pool.can_store(n_blocks):
            return False
        payload = self._swap_gather(slot, self.table[slot, :s.alloc_g],
                                    self.table_local[slot, :s.alloc_l])
        nbytes = _tree_nbytes(payload)
        self.swap_pool.store(SwapRecord(
            rid=s.rid, payload=payload, n_blocks=n_blocks, nbytes=nbytes,
            cur_len=s.cur_len, tokens_done=s.tokens_done, gen_len=s.gen_len,
            reserved=s.reserved, cached_len=s.cached_len,
            alloc_g=s.alloc_g, alloc_l=s.alloc_l, plen=s.plen))
        self.evict(slot)
        self._swap_out_bytes += nbytes
        self._swapped_blocks += n_blocks
        return True

    def has_swapped(self, rid: int) -> bool:
        return self.swap_pool is not None and self.swap_pool.has(rid)

    def plan_resume(self, rid: int) -> bool:
        """Reserve `rid`'s swap-in footprint ahead of fresh admissions: a
        standing reservation (counted in _reserved_total) taken the moment
        capacity exists, so fresh arrivals with tighter deadlines queue
        behind the victim instead of starving it. One backend fleet-wide
        may hold the plan (the HostSwapPool arbitrates); swap_in consumes
        it. Returns True iff this backend holds the plan. Idempotent."""
        if not self.has_swapped(rid):
            return False
        if rid in self._resume_plans:
            return True
        if self.swap_pool.planner(rid) is not None:
            return False  # another replica already reserved the resume
        rec = self.swap_pool.peek(rid)
        need = rec.n_blocks + rec.reserved
        if need > self.free_unreserved:
            return False
        self._resume_plans[rid] = need
        self._reserved_total += need
        self.swap_pool.plan(rid, self)
        return True

    def cancel_resume_plans(self) -> None:
        """Release every standing resume reservation (drain / release: a
        retiring backend must not pin capacity for resumes it will never
        run; the records stay in the shared pool for a live peer)."""
        for rid, need in list(self._resume_plans.items()):
            self._reserved_total -= need
            self.swap_pool.unplan(rid)
        self._resume_plans.clear()

    def can_resume(self, rid: int) -> bool:
        """Swap-in admission: a free slot plus the request's allocated
        blocks and its unspent reservation (it must still be able to
        finish its gen_len). With a standing plan here the blocks are
        already reserved; a plan held by another backend makes the rid
        theirs to resume."""
        if not self.has_swapped(rid) or not self._free_slots:
            return False
        planner = self.swap_pool.planner(rid)
        if planner is not None:
            return planner is self
        rec = self.swap_pool.peek(rid)
        return rec.n_blocks + rec.reserved <= self.free_unreserved

    def swap_in(self, rid: int) -> int:
        """Restore a swapped request: allocate fresh blocks, scatter the
        host payload back (into a free slot's state row too), rebuild the
        PagedSlot at its swap-point cursor. The restored KV is
        byte-identical to what swap_out pulled, so decoding resumes
        bit-identically; restored blocks are private (no hashes:
        re-registering would alias the index's live originals)."""
        assert self.can_resume(rid), f"cannot resume swapped rid {rid}"
        planned = self._resume_plans.pop(rid, None)
        if planned is not None:  # consume the standing reservation
            self._reserved_total -= planned
        rec = self.swap_pool.take(rid)
        slot = self._free_slots.popleft()
        need = rec.reserved + rec.alloc_g + rec.alloc_l
        s = PagedSlot(rid=rid, cur_len=rec.cur_len,
                      tokens_done=rec.tokens_done, gen_len=rec.gen_len,
                      plen=rec.plen, reserved=need, cached_len=rec.cached_len)
        self._slots[slot] = s
        self._reserved_total += need
        for _ in range(rec.alloc_g):  # _alloc draws the reservation down
            self._alloc(slot)
        for _ in range(rec.alloc_l):
            self._alloc(slot, local=True)
        self._swap_scatter(slot, self.table[slot, :rec.alloc_g],
                           self.table_local[slot, :rec.alloc_l], rec.payload)
        self._swap_in_bytes += rec.nbytes
        return slot

    def drop_swapped(self, rid: int) -> None:
        """Discard `rid`'s host copy (restart fallback / cancellation) and
        any standing resume reservation held for it here."""
        if self.swap_pool is not None:
            planned = self._resume_plans.pop(rid, None)
            if planned is not None:
                self._reserved_total -= planned
            self.swap_pool.drop(rid)

    def cached_prefix_len(self, slot: int) -> int:
        """Prompt positions this slot serves from the prefix cache."""
        s = self._slots[slot]
        return 0 if s is None else s.cached_len

    def probe_prefix(self, prompt) -> int:
        """Prompt positions an admission would serve from the cache right
        now (read-only). The router's prefix-affine policy probes every
        replica's pool with this before choosing one."""
        if prompt is None:
            return 0
        return self._probe(prompt)[2]

    def drop_prefix_cache(self) -> None:
        """Forget every registered prefix block (set_params: their K/V was
        computed under the old weights). Only on an idle pool: every
        registered block is then unreferenced, waiting in the reclaim set,
        and goes back to the free list; hit counters are kept."""
        if np.count_nonzero(self._ref):
            raise RuntimeError("drop_prefix_cache with referenced blocks "
                               f"{np.flatnonzero(self._ref).tolist()}")
        for bid in self._reclaim:
            self._free_blocks.append(bid)
            self._free_block_set.add(bid)
        self._reclaim.clear()
        self._cached.clear()
        self._hash_of.clear()
        self._hits.clear()
        self._probe_memo = None

    def release(self) -> None:
        """Retire the pool. Verifies the free-list accounting returns to
        empty — every usable block either free or cache-retained with zero
        references, no dangling reservations — then drops the device
        cache. Leaks raise."""
        live = [i for i, s in enumerate(self._slots) if s is not None]
        if live:
            raise RuntimeError(f"release with occupied slots {live}")
        if self.swap_pool is not None:
            # standing resume reservations are not leaks: the records stay
            # in the shared pool for a live peer to plan next tick
            self.cancel_resume_plans()
        if self._reserved_total:
            raise RuntimeError(f"release leaked {self._reserved_total} "
                               "reserved blocks")
        accounted = len(self._free_blocks) + len(self._reclaim)
        if accounted != self.usable_blocks:
            raise RuntimeError(
                f"release leaked {self.usable_blocks - accounted} blocks "
                f"({len(self._free_blocks)} free + {len(self._reclaim)} "
                f"reclaimable of {self.usable_blocks})")
        if int(np.count_nonzero(self._ref)):
            held = np.flatnonzero(self._ref).tolist()
            raise RuntimeError(f"release with referenced blocks {held}")
        self.caches = None
        if self.swap_pool is not None:
            # the last backend off a shared pool leak-checks host residency
            pool, self.swap_pool = self.swap_pool, None
            pool.detach()

    # -- reporting ----------------------------------------------------------
    @property
    def prefix_hit_tokens(self) -> int:
        """Cumulative prompt tokens served from the cache — the fleet
        rollup sums these raw counts across replicas."""
        return self._hit_tokens

    @property
    def prefix_lookup_tokens(self) -> int:
        """Cumulative prompt tokens probed at admission (the hit-rate
        denominator)."""
        return self._lookup_tokens

    @property
    def prefix_hit_rate(self) -> float:
        """Cumulative fraction of probed prompt tokens served from the
        cache (the prefill compute the pool saved)."""
        return self._hit_tokens / max(self._lookup_tokens, 1)

    @property
    def shared_occupancy(self) -> float:
        """Fraction of the pool actively shared — blocks referenced by two
        or more live requests right now."""
        return (int(np.count_nonzero(self._ref >= 2))
                / max(self.usable_blocks, 1))

    def metrics(self) -> Dict[str, float]:
        """Backend load signals merged into the engine snapshot; with a
        swap tier, this backend's cumulative swap traffic too (its own,
        even over a shared host pool, so a fleet rollup sums them)."""
        m = {"kv_block_occupancy": self.block_occupancy,
             "prefix_hit_rate": self.prefix_hit_rate,
             "kv_shared_occupancy": self.shared_occupancy}
        if self.swap_pool is not None:
            m.update(swapped_blocks=float(self._swapped_blocks),
                     swap_out_bytes=float(self._swap_out_bytes),
                     swap_in_bytes=float(self._swap_in_bytes))
        return m

    def describe(self) -> str:
        swap = "" if self.swap_pool is None else ", host swap on"
        return (f"paged KV: {self.num_blocks} blocks x "
                f"{self.block_size} tokens, prefix cache "
                f"{'on' if self.prefix_cache else 'off'}{swap}")

    # -- introspection (tests) ----------------------------------------------
    def read_slot(self, slot: int) -> Pytree:
        """Gather `slot` back as a batch-1 cache; unallocated table entries
        read as zeros (the null block may hold masked-row junk)."""
        s = self._slots[slot]
        ag = 0 if s is None else s.alloc_g
        al = 0 if s is None else s.alloc_l
        dev = self.device
        valid = torch.as_tensor(np.arange(self.table.shape[1]) < ag,
                                device=dev)
        valid_l = torch.as_tensor(np.arange(self.table_local.shape[1]) < al,
                                  device=dev)
        tg, tl = self._tables_of(slot)
        return self._read(self.caches, tg, valid, slot, tl, valid_l)


class QuantBlockManager(BlockManager):
    """The `--kv quant` backend: BlockManager bookkeeping over an int8
    block pool with per-row f32 dequant scales ([NB,Hkv,bs] — one scale
    per (block, head, token) across the head dim).

    Everything host-side (tables, refcounts, prefix hashing, reservation
    math, the host swap tier, whose payloads carry the scale leaves) is
    inherited unchanged; the deltas are on the device: the pool
    layout (Mo.init_paged_cache quant=True), quantize-on-insert (the fused
    decode step quantizes each new token's K/V row in models/model.py,
    dispatching on the "k_scale" cache leaf; prompt rows arrive the same
    way, as chunked-prefill lane rows; a classic insert quantizes the
    prefill cache through Mo.quantize_paged_request), and dequant fused
    into the read (kernels/paged_decode paged_flash_decode_quant).

    At (hd+4)/(2*hd) the bytes per token of the bf16 pool, an equal-byte
    budget holds ~2x the blocks — ~2x admitted concurrency — with
    bit-exactness relaxed to a bounded-divergence contract:
    `kv_quant_divergence` below is the scheme's calibrated relative RMS
    quantization error."""

    kind = "quant"
    _quant = True

    def __init__(self, cfg: ModelConfig, *args, **kw):
        super().__init__(cfg, *args, **kw)
        cfg, base_insert = self.cfg, self._insert
        self._insert = lambda pool, request, *tables: base_insert(
            pool, Mo.quantize_paged_request(cfg, request), *tables)
        # calibrated divergence: relative RMS error of the int8 scheme on a
        # seeded unit-normal sample (a per-write measurement would sync the
        # hot path; tests pin the end-to-end bound)
        x = torch.as_tensor(np.random.default_rng(0).normal(
            size=(1024, self.cfg.head_dim)), dtype=torch.float32)
        q, sc = pd_ops.quantize_kv(x)
        deq = q.float() * sc[..., None]
        self.quant_divergence = float(
            torch.sqrt(torch.mean((deq - x) ** 2) / torch.mean(x ** 2)))

    def metrics(self) -> Dict[str, float]:
        m = super().metrics()
        m["kv_quant_divergence"] = self.quant_divergence
        return m

    def describe(self) -> str:
        return "int8 " + super().describe().replace("paged KV", "quant KV", 1)

    def read_slot(self, slot: int) -> Pytree:
        """Introspection reads dequantize (int8 * scales -> bf16) so the
        result is directly comparable to an fp pool's read."""
        return Mo.dequantize_paged_request(self.cfg, super().read_slot(slot))
