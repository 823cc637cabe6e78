"""Drafters for speculative decoding on the fused step.

Port of the JAX package's serve/spec.py. A Drafter proposes up to k next
tokens for a decoding request; the target verifies all of them in ONE
fused step by stacking verify rows onto the decode batch
(serve/scheduler.py): row j holds draft d_j at depth cur_len + 1 + j,
exactly the mechanism chunked prefill rides. The target's own outputs
o_0..o_m come back in the same [T] token download; the engine keeps the
longest prefix where d_j == o_{j-1} and emits o_0..o_a.

Token-match acceptance is bit-exact for sampled rows too: the fused sample
step draws each row from fold_in(PRNGKey(seed), position)
(launch/steps.py make_sample_fn), so the target's token at a position is a
function of (seed, position, logits), and a verify row's logits equal
sequential decode's whenever every earlier draft matched (a row's output
does not depend on the rows around it). The rejection-sampling residual
degenerates to exact token match; greedy rows are the temperature <= 0
case of the same argument.

`NgramDrafter` — prompt-lookup self-drafting (no extra model, no extra
KV): match the request's trailing n-gram against its own earlier history
(prompt + generated tokens) and propose the continuation that followed
the most recent earlier occurrence that supplies all k tokens.

`ModelDrafter` — a tiny draft config (2 layers, d_model 48, 3/1 heads of
16 with a qkv bias, the target's vocabulary) decoding greedily one token
ahead through its own SlotPool: each of its steps is one row over a pool
of many slots (the row-indirected slot step). The target's emitted
tokens are fed in as catch-up before each proposal, so rejected draft KV
is overwritten sequentially and never attended — rollback is implicit.
Each drafter step is a T=1 fused step with a host sync.

Over a DeviceMesh (the engine's Env) the model drafter runs per rank as
the engine does: its SlotPool is the rank's (every row; the rank's KV
heads, or every KV head at the rank's positions under a seq_sharded
plan), its weights the rank's shards of the whole draft tree, and its
greedy picks the vocabulary-parallel argmax, so every rank proposes the
same drafts. The draft config's 3 query heads and 1 KV head do not
divide tp 2: the query heads are padded to head_pad (as the JAX
package's init_params pads them under a mesh) and the KV head is
replicated, as parallel/rules.py replicates a size its axis does not
divide.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import steps as St
from repro_torch.models import model as Mo
from repro_torch.models.env import Env, sharded
from repro_torch.parallel import rules
from repro_torch.serve.request import Request


class Drafter:
    """Base drafter: propose() is the contract; admit/retire are optional
    lifecycle hooks (stateful drafters keep per-request caches)."""

    name = "none"

    def propose(self, req: Request, k: int) -> List[int]:
        """Up to k draft tokens continuing req's history (prompt + tokens).
        May return fewer, or [] to skip speculation this step."""
        raise NotImplementedError

    def admit(self, req: Request) -> None:
        """The engine admitted req (it may re-admit after a preemption)."""

    def retire(self, rid: int) -> None:
        """req finished or was preempted: drop any per-request state."""

    def describe(self) -> str:
        return self.name


def _history(req: Request) -> List[int]:
    return [int(t) for t in req.prompt] + [int(t) for t in req.tokens]


class NgramDrafter(Drafter):
    """Prompt-lookup decoding: the request's own history is the draft
    model. Match the longest trailing n-gram (n = max_n..1) at its most
    recent earlier occurrence and propose the k tokens that followed it."""

    name = "ngram"

    def __init__(self, *, max_n: int = 3):
        self.max_n = max_n

    def propose(self, req: Request, k: int) -> List[int]:
        hist = _history(req)
        L = len(hist)
        for n in range(min(self.max_n, L - 1), 0, -1):
            suffix = hist[L - n:]
            best: List[int] = []
            for i in range(L - n - 1, -1, -1):  # most recent match first
                if hist[i:i + n] == suffix:
                    # i + n <= L - 1, so at least one continuation token
                    cont = hist[i + n:i + n + k]
                    if len(cont) >= k:
                        return cont
                    if len(cont) > len(best):
                        # a match near the end of history truncates the
                        # continuation (a constant run's most recent
                        # match is its own tail): keep scanning for one
                        # that supplies all k, else the longest
                        best = cont
            if best:
                return best
        return []


@dataclasses.dataclass
class _DraftState:
    slot: int
    committed: int  # history positions whose KV the draft cache holds


def draft_config(target: ModelConfig) -> ModelConfig:
    """The tiny draft config: qwen2-1.5b-smoke shapes with the target's
    vocabulary (draft tokens must be target token ids)."""
    return ModelConfig(
        name=f"draft-of-{target.name}",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=3,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=target.vocab_size,
        head_dim=16,
        qkv_bias=True,
        block_pattern=("attn",),
    )


class ModelDrafter(Drafter):
    """A small greedy draft model with its own SlotPool-backed KV.

    Per request: admit() prefills the prompt into a draft slot; propose()
    first catches the draft KV up with the target-emitted tokens (the
    committed cursor), then chains k greedy T=1 steps feeding its own
    predictions. `params` are the draft model's weights, the whole tree
    in env's layout (over a mesh padded for its tp degree, as
    init_params(draft_config(target), env) gives it, and as the JAX
    package's draft weights over the same mesh are); by default the
    port's own seeded init_params(draft_config(target), env, seed=0).
    Over a mesh each rank keeps its shards of it."""

    name = "model"

    def __init__(self, target: ModelConfig, env: Env, *, num_slots: int,
                 prompt_len: int, max_gen: int, spec_k: int, params=None,
                 device="cuda"):
        from repro_torch.serve.slots import SlotPool
        self.cfg = draft_config(target)
        self.device = torch.device(device)
        self.prompt_len = prompt_len
        # + spec_k headroom: draft-phase writes run past the committed
        # history by up to k-1 positions
        self.pool = SlotPool(self.cfg, env, num_slots=num_slots,
                             prompt_len=prompt_len,
                             max_gen=max_gen + spec_k, device=self.device)
        whole = (params if params is not None else
                 Mo.init_params(self.cfg, env, seed=0, device=self.device))
        self.params = (rules.local_shards(whole, Mo.param_specs(self.cfg,
                                                                env), env)
                       if sharded(self.cfg, env) else whole)
        self._prefill = St.make_prefill_step(self.cfg, env)
        self._state: Dict[int, _DraftState] = {}
        self._tok_prev = torch.zeros((1,), dtype=torch.int32,
                                     device=self.device)

    def admit(self, req: Request) -> None:
        if req.rid in self._state or not self.pool.can_admit(0):
            return
        slot = self.pool.admit(req.rid, req.eff_gen_len)
        _, caches = self._prefill(self.params, {"tokens": torch.as_tensor(
            np.asarray(req.prompt)[None], device=self.device)})
        self.pool.insert(slot, req.rid, caches, req.eff_gen_len)
        self._state[req.rid] = _DraftState(slot=slot,
                                           committed=self.prompt_len)

    def retire(self, rid: int) -> None:
        st = self._state.pop(rid, None)
        if st is not None:
            self.pool.evict(st.slot)

    def _step(self, tok: int, pos: int, slot: int) -> int:
        """One greedy T=1 fused step: write tok's KV at pos, return the
        draft model's argmax for pos + 1."""
        mi = np.zeros((St.META_I_ROWS, 1), np.int32)
        mi[St.ROW_TOK_SRC, 0] = -1
        mi[St.ROW_FRESH, 0] = tok
        mi[St.ROW_CUR_LEN, 0] = pos
        mf = np.zeros((St.META_F_ROWS, 1), np.float32)
        nxt = self.pool.decode(self.params, self._tok_prev, mi, mf,
                               np.asarray([slot], np.int32), sample=False)
        return int(nxt[0])

    def propose(self, req: Request, k: int) -> List[int]:
        if req.rid not in self._state:
            self.admit(req)  # lazy (re-)admission after a preemption
        st = self._state.get(req.rid)
        if st is None:  # draft pool exhausted: skip speculation
            return []
        hist = _history(req)
        if st.committed >= len(hist):
            return []  # nothing new to ingest (the engine never gets here)
        # catch-up: commit the target's emitted tokens into the draft KV;
        # the last step's output is the draft for position len(hist)
        nxt = 0
        for pos in range(st.committed, len(hist)):
            nxt = self._step(hist[pos], pos, st.slot)
        st.committed = len(hist)
        out = [nxt]
        pos = len(hist)
        for _ in range(k - 1):  # draft phase: junk KV past committed
            nxt = self._step(nxt, pos, st.slot)
            out.append(nxt)
            pos += 1
        return out[:k]

    def describe(self) -> str:
        return (f"model ({self.cfg.name}: {self.cfg.n_layers}L "
                f"d{self.cfg.d_model})")


class AdaptiveSpecK:
    """Per-request draft-depth controller (`--spec-k auto`), AIMD over the
    acceptance feedback the verify step already produces: full acceptance
    grows k by 1, under-half acceptance halves it (each rejected draft is
    a wasted verify row and a wasted drafter call).

    The verify-row block stays `cap` wide (the step's row count is fixed),
    so adaptation only changes how many of a slot's candidate rows are
    live; the rest stay masked. New requests start at `cap`."""

    def __init__(self, cap: int, floor: int = 1):
        assert cap >= floor >= 1
        self.cap = cap
        self.floor = floor
        self._k: Dict[int, int] = {}

    def k(self, rid: int) -> int:
        return self._k.get(rid, self.cap)

    def update(self, rid: int, proposed: int, accepted: int) -> None:
        """One verify outcome for `rid`: `accepted` of `proposed` drafts
        prefix-matched the target this step."""
        k = self._k.get(rid, self.cap)
        if accepted >= proposed:
            k = min(k + 1, self.cap)
        elif accepted * 2 < proposed:
            k = max(k // 2, self.floor)
        self._k[rid] = k

    def retire(self, rid: int) -> None:
        self._k.pop(rid, None)

    def describe(self) -> str:
        return f"adaptive k (floor {self.floor}, cap {self.cap})"


def make_drafter(kind: Optional[str], cfg: ModelConfig, env: Env, *,
                 num_slots: int, prompt_len: int, max_gen: int,
                 spec_k: int, device="cuda") -> Optional[Drafter]:
    """The one drafter-kind dispatch (mirrors make_kv_backend)."""
    if kind is None or kind == "off":
        return None
    if kind == "ngram":
        return NgramDrafter()
    if kind == "model":
        return ModelDrafter(cfg, env, num_slots=num_slots,
                            prompt_len=prompt_len, max_gen=max_gen,
                            spec_k=spec_k, device=device)
    raise ValueError(f"unknown drafter {kind!r} "
                     "(expected 'off', 'ngram' or 'model')")
