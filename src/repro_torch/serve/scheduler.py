"""ReplicaEngine + ServingEngine — continuous batching over a KVBackend.

Port of the JAX package's serve/scheduler.py: chunked-prefill and
classic admission, swap-out preemption over a host tier, and speculative
verify rows.

`ReplicaEngine` is ONE serving replica: a KVBackend (its own block pool,
its own prefix cache), the in-flight lane/slot bookkeeping, the fused
decode step, and its own ServingMetrics. It has no arrival queue and no
SchedulerPolicy — it only answers "can you take this request?"
(`can_accept`), commits admissions (`admit`), and runs decode ticks
(`step_decode`). It also owns the drain lifecycle real scale-down needs:
a draining replica accepts no new work, finishes (or restart-preempts)
what it holds, and `release()` returns its pool with leak checking.

`ServingEngine` is the single-replica composition: a RequestQueue +
SchedulerPolicy admission loop over one ReplicaEngine. The multi-replica
composition is `serve/router.py`'s `ReplicaSet`.

One scheduler iteration (ServingEngine.step()):

  1. admit: the SchedulerPolicy picks which arrived request admits next
     while the KVBackend can reserve its worst case (exhaustion = queue
     backpressure, not an OOM mid-decode). If the backend is full, the
     policy may issue a preemption verdict: with a host swap tier the
     victim's blocks are copied out and it later resumes where it stopped
     (swapped victims get standing resume reservations and admit first);
     otherwise the engine evicts the victim, clears its progress, and
     re-queues it at its original arrival time — restart-preemption is
     safe because sampling is position-keyed, so the victim regenerates
     identical tokens. With prefill_chunk > 0 the
     prompt is not prefilled in a separate batch-1 call: it streams
     through `prefill_chunk` piggybacked lane rows of the regular decode
     step (chunked prefill). With prefill_chunk == 0 (and always on the
     slot pool) admission is classic: a batch-1 prefill of the whole
     prompt (the flash-attention kernel past 128 tokens), its K/V inserted
     into the backend, the first token taken from the prefill logits.
  2. decode: one fused step over decode rows (+ lane rows, + with a
     drafter num_slots * spec_k verify rows), run by the backend: every
     row writes K/V where its table says and attends at its own depth; the
     sample step happens on the device and the [T] int32 token vector is
     the only per-step host download. A slot emits its row's token plus
     every verify row's token while the drafts match the target's own
     outputs; the rejected positions' capacity is rolled back.
  3. retire: finished slots (gen budget spent, or a stop token emitted)
     return their capacity to the backend.

Greedy decoding keeps output token-for-token equal to the one-shot
serve_batch baseline (launch/serve.py; streamed prefill for chunked
admission, full prefill for classic); seeded sampling is reproducible
and lane-placement-invariant; speculative serving emits bit for bit what
non-speculative serving emits, and a swap-resumed request what an
unpreempted one emits. The clock is injected: tests and the CLI drive a
ManualClock; nothing here sleeps.

Over a mesh (`mesh=`, a DeviceMesh of a process group's ranks, and
`plan=`, SERVE_PLAN by default: the JAX package's keywords) every rank of
the mesh runs the same engine: the whole one-device params are cut to
the rank's shards once (bridge.rank_shards), and every rank keeps the
same host state (queue, tables, slots, the prefix index) over a pool of
its own KV heads and state channels (serve/kv.py). A step's rows are not
split over the data axes: the engine has one scheduler, one set of
tables and one pool, a classic admission prefills a batch of 1, and a
step is padded to 128-row tiles, so splitting its few rows would save
nothing; every rank runs the whole step and a data rank repeats its tp
group's work (models/model.py _Ranks.whole_rows; unlike the train step
and the one-shot, which split rows over dp). The tokens a step downloads
are the only input of the scheduler, so every rank picks the same ones
(launch/steps.py: the vocabulary-parallel argmax, or the sampler over
the columns gathered over tp), and the engine checks that they are the
same on every rank, stopping the run (RuntimeError) where they are not.
A speculative step's check covers every row, so every verify row's token
(each one a block accepts) and the drafts the verify rows fed in. The
drafters are per rank (serve/spec.py), AdaptiveSpecK is host state, the
same on every rank. The host swap tier copies each rank's own share of a
victim (serve/blocks.py). The paged pools hold the rank's KV heads under
either layout (the JAX package's paged branch ignores the layout); the
slot pool follows plan.kv_cache (serve/slots.py: under seq_sharded every
KV head at the rank's positions, kernel #5 at each row's own depth).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs.base import ModelConfig, ParallelPlan
from repro_torch.core.clock import Clock, ManualClock
from repro_torch.launch import steps as St
from repro_torch.models.env import SERVE_PLAN, Env, sharded
from repro_torch.parallel import collectives as C
from repro_torch.serve.kv import KVBackend, make_kv_backend
from repro_torch.serve.metrics import ServingMetrics
from repro_torch.serve.policy import FIFOPolicy, SchedulerPolicy
from repro_torch.serve.request import Request, RequestQueue
from repro_torch.serve.spec import AdaptiveSpecK, Drafter, make_drafter

Pytree = Any


@dataclass
class _Lane:
    """An in-flight chunked prefill riding the decode batch's lane rows.

    prefill_chunk is a *token budget* shared by every admitting request:
    each step the budget rows are packed FIFO across the open lanes, so
    several short prompts can prefill in one step while a long prompt
    streams through in chunks."""
    slot: int
    req: Request
    pos: int = 0  # prompt tokens consumed so far
    take: int = 0  # rows granted this step
    last_row: int = 0  # row of the chunk's final token (first-token source)


class ReplicaEngine:
    """One serving replica: KVBackend + lanes + fused step + metrics."""

    def __init__(self, cfg: ModelConfig, params: Pytree, *,
                 name: str = "replica-0",
                 num_slots: int = 4, prompt_len: int = 32, max_gen: int = 32,
                 kv: str = "paged", block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 max_shared_fraction: float = 1.0,
                 prefill_chunk: Optional[int] = None,
                 spec=None, spec_k=4,
                 swap: bool = False,
                 swap_budget_blocks: Optional[int] = None,
                 swap_pool=None,
                 plan: Optional[ParallelPlan] = None, mesh=None,
                 clock: Optional[Clock] = None,
                 metrics_window_s: float = 10.0,
                 device="cuda"):
        self.cfg = cfg
        self.name = name
        self.prompt_len = prompt_len
        self.max_gen = max_gen
        self.clock = clock or ManualClock()
        self.env = Env(mesh=mesh, plan=plan or SERVE_PLAN)
        # per rank over a DeviceMesh: the rank's shards of the params
        self.per_rank = sharded(cfg, self.env)
        self.params = self._local(params)
        self.device = torch.device(device)
        self.pool: KVBackend = make_kv_backend(
            kv, cfg, self.env, num_slots=num_slots, prompt_len=prompt_len,
            max_gen=max_gen, block_size=block_size, kv_blocks=kv_blocks,
            prefix_cache=prefix_cache,
            max_shared_fraction=max_shared_fraction, swap=swap,
            swap_budget_blocks=swap_budget_blocks, swap_pool=swap_pool,
            device=self.device)
        self.kv = self.pool.kind
        if prefill_chunk is None:
            prefill_chunk = prompt_len if self.pool.chunk_prefill_ok else 0
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got "
                             f"{prefill_chunk}")
        if prefill_chunk and not self.pool.chunk_prefill_ok:
            raise ValueError(
                f"{cfg.name}: chunked prefill is not supported by the "
                f"'{self.pool.kind}' backend for this arch (recurrent "
                "state is sequential over the prompt; ring writes wrap "
                "within a chunk; the slot pool has no per-row tables)")
        self.prefill_chunk = int(prefill_chunk)
        # -- speculative decoding (serve/spec.py): verify rows ride the step
        # like lane rows, several rows sharing one slot at consecutive
        # depths. That needs per-row attention over a write-then-read
        # cache: window rings wrap within a draft and recurrent state is
        # sequential, so both are refused. spec_k="auto": the verify block
        # stays cap rows wide per slot; each request's live depth follows
        # its own acceptance (AdaptiveSpecK)
        if spec_k == "auto":
            self.spec_k = 4
            self._spec_ctl: Optional[AdaptiveSpecK] = AdaptiveSpecK(
                cap=self.spec_k)
        else:
            self.spec_k = int(spec_k)
            self._spec_ctl = None
        if isinstance(spec, str) or spec is None:
            self.drafter: Optional[Drafter] = make_drafter(
                spec, cfg, self.env, num_slots=self.pool.num_slots,
                prompt_len=prompt_len, max_gen=max_gen, spec_k=self.spec_k,
                device=self.device)
        else:  # a pre-built Drafter (tests plug deterministic ones in)
            self.drafter = spec
        if self.drafter is not None:
            kinds = set(cfg.block_pattern) | set(cfg.pattern_tail)
            if not kinds <= {"attn", "moe"}:
                raise ValueError(
                    f"{cfg.name}: speculative decoding needs per-row "
                    "attention blocks (sliding-window rings wrap within a "
                    "draft; recurrent state is sequential)")
            if self.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        self.metrics = ServingMetrics(window_s=metrics_window_s)
        self._prefill = St.make_prefill_step(cfg, self.env)
        # classic admissions sample their first token from the prefill
        # logits with the same fused sample math (position 0)
        self._sample_first = St.make_sample_fn(cfg, prompt_len, self.env)
        self._lanes: List[_Lane] = []
        # device [T] int32: last step's fused sample/argmax
        self._tok_prev = torch.zeros((num_slots,), dtype=torch.int32,
                                     device=self.device)
        self._row_src: Dict[int, int] = {}  # slot -> row in _tok_prev
        self._fresh: Dict[int, int] = {}  # slot -> host-known next token
        self._inflight: Dict[int, Request] = {}  # rid -> request
        self.completed: List[Request] = []
        self.decode_steps = 0
        self.draining = False

    def _local(self, params: Pytree) -> Pytree:
        """The whole one-device params as this replica computes on them:
        the rank's shards over a mesh, as they are otherwise."""
        return (bridge.rank_shards(params, self.cfg, self.env)
                if self.per_rank else params)

    def _agreed(self, tokens) -> None:
        """Over a mesh, stop the run where the ranks' tokens differ (their
        schedulers would diverge silently)."""
        if self.per_rank and not C.same_on_every_rank(tokens, self.env):
            raise RuntimeError(
                f"{self.name}: the mesh's ranks picked different tokens")

    # -- state -----------------------------------------------------------------
    @property
    def busy(self) -> bool:
        return bool(self._inflight)

    def prompt_arg(self, req: Request):
        """The prompt to hand the backend's admission probes: chunked
        admissions pass it so a prefix-caching backend can attach shared
        blocks (classic batch-1 prefill scatters the whole prompt and
        cannot share)."""
        return req.prompt if self.prefill_chunk else None

    def admission_room(self) -> bool:
        """Lane-budget gate: open lanes only while the step's token budget
        can still reach a new prompt (bounds admitted-but-starved lanes).
        Classic replicas always have room: the backend's can_admit is the
        only gate."""
        if not self.prefill_chunk:
            return True
        return (sum(len(l.req.prompt) - l.pos for l in self._lanes)
                < self.prefill_chunk)

    def can_take(self, req: Request) -> bool:
        """Capacity predicate only: can the backend hold `req` right now?
        A swapped-out request resumes instead of re-admitting: its gate is
        can_resume (a free slot, its allocated blocks and its unspent
        reservation), not the fresh-admission math."""
        if self.pool.has_swapped(req.rid):
            return self.pool.can_resume(req.rid)
        return self.pool.can_admit(req.eff_gen_len,
                                   prompt=self.prompt_arg(req))

    def can_accept(self, req: Request) -> bool:
        """Could this replica commit `req` right now? (Routing predicate —
        admission-accurate because admit() takes its reservations
        immediately, so successive calls within one tick stay honest.)"""
        return (not self.draining and self.admission_room()
                and self.can_take(req))

    # -- admission commit ---------------------------------------------------
    @torch.no_grad()
    def admit(self, req: Request, now: float) -> None:
        """Commit one admission (caller already took it off its queue)."""
        req.t_admit = now
        self._inflight[req.rid] = req
        if self.pool.has_swapped(req.rid):
            # swap-in resume: the host tier holds the request's KV at its
            # preemption cursor. Restore it and feed the last emitted token
            # (the one swap-out never fed back) to the next step: decoding
            # continues bit-identically, with no prefill and no recompute
            slot = self.pool.swap_in(req.rid)
            self._fresh[slot] = req.tokens[-1]
            if self.drafter is not None:
                self.drafter.admit(req)
            return
        if self.drafter is not None:
            self.drafter.admit(req)
        if not self.prefill_chunk:
            self._admit_classic(
                self.pool.admit(req.rid, req.eff_gen_len), req, now)
            return
        slot = self.pool.admit(req.rid, req.eff_gen_len,
                               prefilling=True, prompt=req.prompt)
        # cached prefix positions never ride a lane: start at the first
        # uncached token (the last prompt token always runs to emit the
        # first generated token)
        self._lanes.append(_Lane(slot=slot, req=req,
                                 pos=self.pool.cached_prefix_len(slot)))

    def _admit_classic(self, slot: int, req: Request, now: float) -> None:
        """Batch-1 prefill + cache insert (the non-chunked path). The first
        token comes from the prefill logits at position 0 — greedy requests
        take the plain argmax, seeded ones the fused sample math — and
        feeds the next step's decode row through the fresh-token path. A
        restart-preempted request's re-prefill is booked as recompute."""
        logits, caches = self._prefill(
            self.params, {"tokens": torch.as_tensor(
                np.asarray(req.prompt)[None], device=self.device)})
        self.metrics.record_prefill_tokens(len(req.prompt),
                                           recompute=req.restarts > 0)
        self.pool.insert(slot, req.rid, caches, req.eff_gen_len)
        if req.sampling.greedy:
            first_dev = St.greedy(logits, self.cfg, self.env)[:, 0]
        else:
            mi = np.zeros((St.META_I_ROWS, 1), np.int32)
            mf = np.zeros((St.META_F_ROWS, 1), np.float32)
            mi[St.ROW_CUR_LEN, 0] = len(req.prompt) - 1  # -> position 0
            self._fill_sampling(mi, mf, 0, req)
            first_dev = self._sample_first(
                logits, torch.as_tensor(mi, device=self.device),
                torch.as_tensor(mf, device=self.device))
        self._agreed(first_dev)
        first = int(first_dev[0])
        req.t_first_token = now
        req.tokens.append(first)
        self._fresh[slot] = first
        self.metrics.record_first_token(req, now)
        self.metrics.record_tokens(now, 1)
        if self.pool.finished(slot) or first in req.sampling.stop_set:
            self._retire(slot, now)  # gen_len == 1 / instant stop token

    # -- preemption (swap-out, else restart) ---------------------------------
    def running(self) -> List[Request]:
        """Decoding (preemptible) requests, for the policy's verdict."""
        return [self._inflight[self.pool.info(s).rid]
                for s in self.pool.active_slots()]

    def slot_of(self, req: Request) -> Optional[int]:
        """The slot `req` occupies, or None (a stale policy verdict)."""
        return next((s for s in self.pool.occupied_slots()
                     if self.pool.rid_of(s) == req.rid), None)

    def lane_open(self, slot: int) -> bool:
        return any(ln.slot == slot for ln in self._lanes)

    def preempt(self, victim: Request, slot: int, now: float) -> Request:
        """Preemption: return the victim's KV capacity; the caller re-queues
        it at its original arrival time.

        Swap-out first: a backend with a host tier copies the victim's
        blocks out, so its tokens survive and re-admission resumes it
        bit-identically with nothing recomputed. Restart otherwise (no
        host tier, budget full, mid-prefill): clear the victim's progress.
        Safe because sampling is position-keyed — on re-admission the
        victim regenerates bit-identical tokens — but the re-prefill is
        paid compute, booked into recomputed_tokens via `restarts`."""
        assert not self.lane_open(slot), \
            f"preempting slot {slot} with an open prefill lane"
        swapped = self.pool.swap_out(slot)
        if not swapped:
            self.pool.evict(slot)
        self._row_src.pop(slot, None)
        self._fresh.pop(slot, None)
        if self.drafter is not None:
            self.drafter.retire(victim.rid)
        if self._spec_ctl is not None:
            self._spec_ctl.retire(victim.rid)
        del self._inflight[victim.rid]
        victim.t_admit = None
        if not swapped:
            victim.tokens.clear()
            victim.t_first_token = None
            victim.restarts += 1
        self.metrics.record_preempt(now)
        return victim

    # -- drain lifecycle ------------------------------------------------------
    def start_drain(self, *, preempt: bool = False) -> List[Request]:
        """Enter drain mode: no new admissions (can_accept goes False).
        With preempt=False the replica finishes what it holds; with
        preempt=True every in-flight request — decoding or mid-prefill —
        is preempted (swapped out where the backend can, else restarted)
        and returned for the caller to re-queue (bit-identical either way,
        so a drain can be immediate without changing output)."""
        self.draining = True
        # a draining replica will never run its planned swap-ins: free the
        # standing reservations so a live peer can take them over
        self.pool.cancel_resume_plans()
        if not preempt:
            return []
        now = self.clock.now()
        # closing the lanes first makes mid-prefill slots preemptible too
        # (preempt()'s open-lane guard is about a lane writing into a
        # freed slot; with no lanes left there is nothing to write)
        self._lanes.clear()
        return [self.preempt(self._inflight[self.pool.rid_of(slot)], slot,
                             now)
                for slot in list(self.pool.occupied_slots())]

    def cancel_drain(self) -> None:
        """Scale-up may reuse a still-draining replica: its cache is warm,
        which beats a cold spawn."""
        self.draining = False

    def release(self) -> None:
        """Return the replica's pool. Must be idle; the backend's release()
        verifies its free-list accounting (no leaked blocks/reservations)
        before dropping the device cache."""
        if self.busy or self._lanes:
            raise RuntimeError(
                f"{self.name}: release() while {len(self._inflight)} "
                "requests are in flight — drain first")
        self.pool.release()

    # -- one decode tick -----------------------------------------------------
    @torch.no_grad()
    def step_decode(self, now: float) -> int:
        """Run one fused decode step over the replica's mixed batch
        (+ prefill lanes) and retire finished requests. Returns tokens
        emitted this tick."""
        active = self.pool.active_slots()
        lanes = self._lanes
        if not active and not lanes:
            return 0

        # pack the prefill token budget FIFO across open lanes
        N = self.pool.num_slots
        budget = self.prefill_chunk
        for lane in lanes:
            lane.take = min(budget, len(lane.req.prompt) - lane.pos)
            budget -= lane.take
        # prefill compute actually spent this step; chunks of
        # restart-preempted requests are re-work, booked separately
        self.metrics.record_prefill_tokens(
            sum(ln.take for ln in lanes if ln.req.restarts == 0))
        self.metrics.record_prefill_tokens(
            sum(ln.take for ln in lanes if ln.req.restarts > 0),
            recompute=True)
        lane_rows = self.prefill_chunk if lanes else 0
        # speculative verify rows: a block of num_slots * spec_k rows after
        # the lane rows (slot s's candidates at spec_base + s * spec_k + j),
        # present whenever a drafter is configured; unused ones stay masked
        spec_rows = N * self.spec_k if self.drafter is not None else 0
        spec_base = N + lane_rows
        T = N + lane_rows + spec_rows
        meta_i = np.zeros((St.META_I_ROWS, T), np.int32)
        meta_f = np.zeros((St.META_F_ROWS, T), np.float32)
        meta_i[St.ROW_TOK_SRC, :] = -1
        row_slots = np.full((T,), -1, np.int32)
        sample = False
        # draft proposals per decoding slot, k capped so the last verify
        # row writes inside the request's budget: at most gen_len -
        # tokens_done tokens may still be emitted
        drafts: Dict[int, List[int]] = {}
        if self.drafter is not None:
            for slot in active:
                info = self.pool.info(slot)
                req = self._inflight[info.rid]
                k_live = (self.spec_k if self._spec_ctl is None
                          else self._spec_ctl.k(req.rid))
                k_eff = min(k_live, info.gen_len - info.tokens_done - 1)
                if k_eff <= 0:
                    continue
                d = self.drafter.propose(req, k_eff)[:k_eff]
                if d:
                    drafts[slot] = d
        for slot in active:
            info = self.pool.info(slot)
            req = self._inflight[info.rid]
            self.pool.ensure(slot, info.cur_len)
            row_slots[slot] = slot
            meta_i[St.ROW_CUR_LEN, slot] = info.cur_len
            sample |= self._fill_sampling(meta_i, meta_f, slot, req)
            if slot in self._fresh:
                meta_i[St.ROW_TOK_SRC, slot] = -1
                meta_i[St.ROW_FRESH, slot] = self._fresh.pop(slot)
            else:
                meta_i[St.ROW_TOK_SRC, slot] = self._row_src.pop(slot, slot)
        for slot, d in drafts.items():
            info = self.pool.info(slot)
            req = self._inflight[info.rid]
            # capacity for every candidate write position (rolled back on
            # rejection by truncate); every row's K/V lands before any row
            # attends, so verify row j sees rows 0..j-1 of its slot
            self.pool.ensure(slot, info.cur_len + len(d))
            base = spec_base + slot * self.spec_k
            for j, tok in enumerate(d):
                r = base + j
                row_slots[r] = slot
                meta_i[St.ROW_FRESH, r] = tok
                meta_i[St.ROW_CUR_LEN, r] = info.cur_len + 1 + j
                sample |= self._fill_sampling(meta_i, meta_f, r, req)
        row = N
        for lane in lanes:
            if lane.take <= 0:
                continue
            self.pool.ensure(lane.slot, lane.pos + lane.take - 1)
            sl = slice(row, row + lane.take)
            meta_i[St.ROW_FRESH, sl] = \
                lane.req.prompt[lane.pos:lane.pos + lane.take]
            meta_i[St.ROW_CUR_LEN, sl] = \
                np.arange(lane.pos, lane.pos + lane.take)
            row_slots[sl] = lane.slot
            sample |= self._fill_sampling(meta_i, meta_f, sl, lane.req)
            row += lane.take
            lane.last_row = row - 1

        nxt_dev = self.pool.decode(self.params, self._tok_prev, meta_i,
                                   meta_f, row_slots, sample=sample)
        # every row's token (a verify block's accepted ones among them),
        # and the drafts the verify rows fed in
        self._agreed(nxt_dev if not spec_rows else torch.cat([
            nxt_dev.long(), torch.as_tensor(
                meta_i[St.ROW_FRESH, spec_base:], device=self.device).long()]))
        self._tok_prev = nxt_dev
        nxt = nxt_dev.cpu().numpy()  # the one host transfer per step
        self.decode_steps += 1

        emitted = 0
        for slot in active:
            info = self.pool.info(slot)
            req = self._inflight[info.rid]
            cur = info.cur_len
            d = drafts.get(slot, [])
            base = spec_base + slot * self.spec_k
            outs = [int(nxt[slot])] + [int(nxt[base + j])
                                       for j in range(len(d))]
            # accept the longest prefix where draft j equals the target's
            # own output for that position (o_{j-1}): verify row j's
            # logits, and seeded its fold_in(seed, position) draw, equal
            # sequential decode's exactly while every earlier draft matched
            a = 0
            while a < len(d) and d[a] == outs[a]:
                a += 1
            emit = outs[:a + 1]
            stop = req.sampling.stop_set
            cut = next((i for i, t in enumerate(emit) if t in stop), None)
            if cut is not None:
                emit = emit[:cut + 1]
            if d:
                # roll the rejected suffix's capacity back (a no-op when
                # every draft was accepted) and record acceptance
                self.pool.truncate(slot, cur + len(emit))
                self.metrics.record_spec(len(d), len(emit) - 1, len(emit))
                if self._spec_ctl is not None:
                    self._spec_ctl.update(req.rid, len(d), len(emit) - 1)
            # next step's input token (the last emitted) sits at the row
            # that produced it: the slot's row for a = 0, else verify row
            # a - 1
            self._row_src[slot] = (slot if len(emit) == 1
                                   else base + len(emit) - 2)
            for tok in emit:
                self.pool.advance(slot)
                req.tokens.append(tok)
                emitted += 1
            if self.pool.finished(slot) or emit[-1] in stop:
                self._retire(slot, now)
        still_open: List[_Lane] = []
        for lane in lanes:
            lane.pos += lane.take
            if lane.pos < len(lane.req.prompt):
                still_open.append(lane)
                continue
            slot = lane.slot
            self.pool.finish_prefill(slot)
            req = lane.req
            req.t_first_token = now
            tok = int(nxt[lane.last_row])
            req.tokens.append(tok)
            self.metrics.record_first_token(req, now)
            # next step, this slot's input token comes from the lane row
            self._row_src[slot] = lane.last_row
            emitted += 1
            if self.pool.finished(slot) or tok in req.sampling.stop_set:
                self._retire(slot, now)
        self._lanes = still_open
        if emitted:
            self.metrics.record_tokens(now, emitted)
        return emitted

    @staticmethod
    def _fill_sampling(meta_i, meta_f, rows, req: Request) -> bool:
        """Write one request's SamplingParams into its row(s); returns
        whether the row actually samples (so an all-greedy batch can take
        the pure-argmax step variant)."""
        sp = req.sampling
        meta_i[St.ROW_SEED, rows] = sp.seed
        meta_i[St.ROW_TOP_K, rows] = sp.top_k
        meta_i[St.ROW_POS0, rows] = len(req.prompt) - 1
        meta_f[St.ROW_TEMPERATURE, rows] = sp.temperature
        meta_f[St.ROW_TOP_P, rows] = sp.top_p
        return not sp.greedy

    def _retire(self, slot: int, now: float) -> None:
        rid = self.pool.rid_of(slot)
        req = self._inflight.pop(rid)
        req.t_done = now
        self.completed.append(req)
        self.metrics.record_done(req, now)
        self.pool.evict(slot)
        self._row_src.pop(slot, None)
        self._fresh.pop(slot, None)
        if self.drafter is not None:
            self.drafter.retire(rid)
        if self._spec_ctl is not None:
            self._spec_ctl.retire(rid)

    # -- reporting ----------------------------------------------------------------
    def load_score(self):
        """Routing key: committed KV first (the signal that gates admission
        on a paged backend), the in-flight count as the queue-depth
        tiebreak, then *absolute* free capacity (more free capacity =
        smaller key, so of two empty replicas with unequal pools the big
        one wins)."""
        m = self.pool.metrics()
        return (m.get("kv_block_occupancy", self.pool.occupancy),
                len(self._inflight), -self.pool.free_capacity)

    def set_params(self, params: Pytree) -> None:
        """Swap the serving weights (a post-training loop publishing its
        updated policy). Only between requests: in-flight KV was computed
        under the old weights, so a mid-request swap would mix two models
        inside one generation. The tree must have the old one's structure
        (the step reads it by name); only the reference changes.

        Unlike the JAX package, whose set_params keeps the prefix index,
        the backend's prefix cache is dropped too (every registered block
        is unreferenced once the replica is idle, so it is returned to the
        free list): those blocks hold K/V computed under the old weights,
        and a later prompt sharing their prefix would attend over them
        (ROADMAP.md §3). Over a mesh the whole params are cut to the
        rank's shards, as at construction."""
        if self.busy or self._lanes:
            raise RuntimeError(
                f"{self.name}: set_params with {len(self._inflight)} "
                "requests in flight — drain first")
        self.pool.drop_prefix_cache()
        self.params = self._local(params)

    def snapshot(self, *, queue_depth: Optional[int] = None
                 ) -> Dict[str, float]:
        return self.metrics.snapshot(self.clock.now(),
                                     queue_depth=queue_depth,
                                     slot_occupancy=self.pool.occupancy,
                                     **self.pool.metrics())


class ServingEngine:
    """The single-replica serving composition: RequestQueue +
    SchedulerPolicy admission loop over one ReplicaEngine."""

    def __init__(self, cfg: ModelConfig, params: Pytree, *,
                 num_slots: int = 4, prompt_len: int = 32, max_gen: int = 32,
                 kv: str = "paged", block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 max_shared_fraction: float = 1.0,
                 prefill_chunk: Optional[int] = None,
                 spec=None, spec_k=4,
                 swap: bool = False,
                 swap_budget_blocks: Optional[int] = None,
                 swap_pool=None,
                 policy: Optional[SchedulerPolicy] = None,
                 plan: Optional[ParallelPlan] = None, mesh=None,
                 clock: Optional[Clock] = None,
                 metrics_window_s: float = 10.0,
                 device="cuda"):
        self.replica = ReplicaEngine(
            cfg, params, num_slots=num_slots, prompt_len=prompt_len,
            max_gen=max_gen, kv=kv, block_size=block_size,
            kv_blocks=kv_blocks, prefix_cache=prefix_cache,
            max_shared_fraction=max_shared_fraction,
            prefill_chunk=prefill_chunk, spec=spec, spec_k=spec_k,
            swap=swap, swap_budget_blocks=swap_budget_blocks,
            swap_pool=swap_pool, plan=plan, mesh=mesh, clock=clock,
            metrics_window_s=metrics_window_s, device=device)
        self.policy: SchedulerPolicy = policy or FIFOPolicy()
        self.queue = RequestQueue()

    # -- delegated surface (the replica owns the data plane) -----------------
    @property
    def cfg(self):
        return self.replica.cfg

    @property
    def params(self):
        return self.replica.params

    @property
    def env(self):
        return self.replica.env

    @property
    def clock(self):
        return self.replica.clock

    @property
    def pool(self) -> KVBackend:
        return self.replica.pool

    @property
    def kv(self) -> str:
        return self.replica.kv

    @property
    def prompt_len(self) -> int:
        return self.replica.prompt_len

    @property
    def max_gen(self) -> int:
        return self.replica.max_gen

    @property
    def prefill_chunk(self) -> int:
        return self.replica.prefill_chunk

    @property
    def drafter(self):
        return self.replica.drafter

    @property
    def spec_k(self) -> int:
        return self.replica.spec_k

    @property
    def metrics(self) -> ServingMetrics:
        return self.replica.metrics

    @property
    def completed(self) -> List[Request]:
        return self.replica.completed

    @property
    def decode_steps(self) -> int:
        return self.replica.decode_steps

    # -- state -----------------------------------------------------------------
    @property
    def busy(self) -> bool:
        return self.replica.busy

    def pending(self) -> int:
        return len(self.queue)

    def drained(self) -> bool:
        return not self.busy and not self.pending()

    def set_params(self, params: Pytree) -> None:
        self.replica.set_params(params)

    def submit(self, requests: Sequence[Request]) -> None:
        """Validate and enqueue. Never mutates the caller's Requests."""
        validate_requests(requests, self.prompt_len, self.max_gen,
                          allow_shorter=self.prefill_chunk > 0)
        for r in requests:
            self.queue.push(r)

    # -- scheduler iteration ------------------------------------------------------
    def step(self) -> Dict[str, float]:
        """Admit arrivals (policy order), run one fused decode step over
        the mixed batch (+ prefill lanes), retire finished requests.
        Returns the metrics snapshot (what a node would publish)."""
        now = self.clock.now()
        self._admit_ready(now)
        self.replica.step_decode(now)
        return self.snapshot()

    def _admit_ready(self, now: float) -> None:
        rep = self.replica
        # swap-aware admission: before any fresh request can claim blocks,
        # every arrived swapped-out victim gets a resume plan — a standing
        # reservation for its footprint that swap_in consumes — so fresh
        # admissions see the shrunk capacity and queue behind it
        for r in self.queue.ready(now):
            if rep.pool.has_swapped(r.rid):
                rep.pool.plan_resume(r.rid)
        preempted = False  # at most one restart per iteration (no thrash)
        ready = None  # built lazily, invalidated when the queue changes
        while True:
            if not rep.admission_room():
                return
            if self.queue.peek_ready(now) is None:
                return  # O(1) hot-path exit: nothing has arrived
            if ready is None:
                ready = self.queue.ready(now)
            req = self.policy.select(ready, now)
            if req is None:
                return
            prompt = rep.prompt_arg(req)
            if not rep.can_take(req):
                # resume-first: the pick may be blocked by a victim's
                # standing reservation; resuming that victim (its blocks
                # are reserved, it needs only a slot) makes progress where
                # returning would deadlock the admission loop
                swapped = next(
                    (r for r in ready if r is not req
                     and rep.pool.has_swapped(r.rid) and rep.can_take(r)),
                    None)
                if swapped is not None:
                    self.queue.remove(swapped)
                    ready.remove(swapped)
                    rep.admit(swapped, now)
                    continue
                victim = None if preempted else \
                    self.policy.victim(rep.running(), req, now)
                if victim is None:
                    return  # backend exhaustion -> queue backpressure
                vslot = rep.slot_of(victim)
                if vslot is None or rep.lane_open(vslot):
                    return  # stale or mid-prefill verdict: backpressure
                if not rep.pool.preempt_frees(vslot, req.eff_gen_len,
                                              prompt=prompt):
                    return  # eviction could not make room
                self.queue.push(rep.preempt(victim, vslot, now))
                preempted = True
                ready = None  # the victim re-joined the arrived set
                if not rep.can_take(req):
                    return  # a swap-resume's can_resume gate may disagree
            self.queue.remove(req)
            if ready is not None:
                ready.remove(req)
            rep.admit(req, now)

    # -- reporting ----------------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        now = self.clock.now()
        return self.replica.snapshot(queue_depth=self.queue.depth(now))

    def results(self) -> Dict[int, List[int]]:
        """rid -> generated tokens, for every completed request."""
        return {r.rid: list(r.tokens) for r in self.completed}


def validate_requests(requests: Sequence[Request], prompt_len: int,
                      max_gen: int, *, allow_shorter: bool = False) -> None:
    """Submit-time validation (ServingEngine and the router both gate
    here). Chunked prefill streams prompts through lane rows at the
    request's own length, so it accepts any prompt up to the engine's
    prompt_len budget (allow_shorter=True); classic prefill keeps the
    JAX package's exact-length contract."""
    for r in requests:
        n = len(r.prompt)
        if (n != prompt_len if not allow_shorter
                else not 0 < n <= prompt_len):
            raise ValueError(
                f"request {r.rid}: prompt length {n} "
                + (f"not in (0, {prompt_len}]" if allow_shorter
                   else f"!= engine prompt_len {prompt_len} (pad the trace)"))
        if r.eff_gen_len > max_gen:
            raise ValueError(
                f"request {r.rid}: gen_len {r.eff_gen_len} > "
                f"engine max_gen {max_gen}")


def run_to_completion(engine, requests: Sequence[Request] = (), *,
                      dt: float = 0.05, max_steps: int = 100_000,
                      on_step: Optional[Callable[[int, Dict[str, float]],
                                                 None]] = None
                      ) -> Dict[int, List[int]]:
    """Standalone drain loop (no cluster): step the engine (a
    ServingEngine or a router.ReplicaSet), advance the clock by `dt`
    between iterations. VirtualCluster.serve() is the cluster-integrated
    version of this loop."""
    engine.submit(requests)
    steps = 0
    while not engine.drained() and steps < max_steps:
        snap = engine.step()
        engine.clock.sleep(dt)
        if on_step is not None:
            on_step(steps, snap)
        steps += 1
    if not engine.drained():
        raise RuntimeError(f"serve did not drain in {max_steps} steps")
    return engine.results()
