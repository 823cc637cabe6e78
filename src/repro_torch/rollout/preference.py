"""DPO-style preference updates from scored rollouts (port of the JAX
package's rollout/preference.py).

Scored rollouts pair up (best against worst completion per prompt), and
the trainer steps AdamW (optim/adamw.py) on the direct-preference
objective

    L = -log sigmoid(beta * ((lp_pi(c) - lp_ref(c)) - (lp_pi(r) - lp_ref(r))))

where lp(.) is the summed log-probability of the completion tokens under
the trained policy and under a frozen reference. Completion log-probs
take train mode's logits (models/model.py) with the padded vocabulary
masked, as lm_loss reads them, and a per-position mask selecting the
completion span, so prompts of different lengths batch together.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     tree_map, value_and_grad)
from repro_torch.rollout.engine import Rollout


# -- batching -----------------------------------------------------------------

def pack_sequences(items: Sequence[Rollout], *, pad_len: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Rollouts -> ([B,S] int32 tokens, [B,S-1] float32 mask).

    Row i is prompt_i ++ tokens_i padded to a common length; mask[i, j] is
    1.0 exactly on the label positions of completion tokens (inputs are
    seq[:-1], labels seq[1:], so completion token t at sequence index p
    counts at label index p-1). Padding predicts nothing."""
    seqs = [np.concatenate([np.asarray(r.prompt, np.int32),
                            np.asarray(r.tokens, np.int32)]) for r in items]
    S = max((len(s) for s in seqs), default=2)
    if pad_len is not None:
        if pad_len < S:
            raise ValueError(f"pad_len {pad_len} < longest sequence {S}")
        S = pad_len
    S = max(S, 2)  # forward needs at least one label position
    toks = np.zeros((len(seqs), S), np.int32)
    mask = np.zeros((len(seqs), S - 1), np.float32)
    for i, (r, s) in enumerate(zip(items, seqs)):
        toks[i, :len(s)] = s
        lo = len(r.prompt) - 1
        mask[i, lo:lo + len(r.tokens)] = 1.0
    return toks, mask


def build_pairs(rollouts: Sequence[Rollout]
                ) -> List[Tuple[Rollout, Rollout]]:
    """Chosen/rejected pairs: per (prompt_id, turn) group, the highest-
    against the lowest-reward completion. Groups whose rewards are all
    equal carry no preference and are skipped."""
    groups: Dict[Tuple[int, int], List[Rollout]] = {}
    for r in rollouts:
        groups.setdefault((r.prompt_id, r.turn), []).append(r)
    pairs = []
    for key in sorted(groups):
        g = sorted(groups[key], key=lambda r: (r.reward, -r.sample_idx))
        if g[-1].reward > g[0].reward:
            pairs.append((g[-1], g[0]))
    return pairs


def pack_pair_batch(pairs: Sequence[Tuple[Rollout, Rollout]], *,
                    pad_pairs: Optional[int] = None,
                    pad_len: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pairs -> fixed-shape arrays for the DPO step. pad_pairs / pad_len
    pin the batch shape across rounds (pair counts vary when ties are
    skipped); pair_mask zeroes the padding rows out of the loss."""
    P = len(pairs) if pad_pairs is None else pad_pairs
    if P < len(pairs):
        raise ValueError(f"pad_pairs {P} < {len(pairs)} pairs")
    chosen = [c for c, _ in pairs]
    rejected = [r for _, r in pairs]
    S = max((len(x.prompt) + len(x.tokens) for x in chosen + rejected),
            default=2)
    S = max(S, pad_len or 0)
    ct, cm = pack_sequences(chosen, pad_len=S)
    rt, rm = pack_sequences(rejected, pad_len=S)

    def pad(a, rows):
        out = np.zeros((P,) + a.shape[1:], a.dtype)
        out[:rows] = a
        return out

    pm = np.zeros((P,), np.float32)
    pm[:len(pairs)] = 1.0
    return {"chosen": pad(ct, len(pairs)), "chosen_mask": pad(cm, len(pairs)),
            "rejected": pad(rt, len(pairs)),
            "rejected_mask": pad(rm, len(pairs)), "pair_mask": pm}


# -- log-probs ----------------------------------------------------------------

def completion_logprobs(params, tokens, mask, cfg, env) -> torch.Tensor:
    """Summed log p(completion | prompt) per row, f32 [B], from train
    mode's logits over tokens[:, :-1] (differentiable in params)."""
    logits, _ = Mo.forward(params, tokens[:, :-1], cfg, env, mode="train")
    logz, ll = Mo.token_logprobs(logits, tokens[:, 1:].long(), cfg)
    return torch.sum((ll - logz) * mask, dim=-1)


# -- the trainer --------------------------------------------------------------

class PreferenceTrainer:
    """DPO over the serving model's params with a frozen reference.

    The reference is a copy of the params at construction. Each step
    takes fresh autograd leaves of the current params (value_and_grad)
    and adamw_update returns the next params as new tensors of the same
    tree and dtypes: the serving engine's weights change only when the
    caller passes them to engine.set_params."""

    def __init__(self, cfg, params, *, env: Optional[Env] = None,
                 beta: float = 0.5, opt: Optional[AdamWConfig] = None):
        self.cfg = cfg
        self.env = env if env is not None else Env()
        self.params = params
        self.ref_params = tree_map(lambda x: x.detach().clone(), params)
        self.beta = beta
        self.opt_cfg = opt if opt is not None else AdamWConfig(
            lr=1e-3, warmup_steps=0, total_steps=100, weight_decay=0.0)
        self.opt_state = adamw_init(params, self.opt_cfg)
        self.steps_done = 0

    def _loss(self, params, batch, ref_c, ref_r):
        cfg, env = self.cfg, self.env
        pi_c = completion_logprobs(params, batch["chosen"],
                                   batch["chosen_mask"], cfg, env)
        pi_r = completion_logprobs(params, batch["rejected"],
                                   batch["rejected_mask"], cfg, env)
        margin = (pi_c - ref_c) - (pi_r - ref_r)
        pm = batch["pair_mask"]
        n = torch.clamp_min(torch.sum(pm), 1.0)
        loss = torch.sum(-F.logsigmoid(self.beta * margin) * pm) / n
        return loss, (torch.sum(margin * pm) / n).detach()

    def step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One optimizer step on a packed pair batch."""
        dev = self.params["final_norm"].device
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.no_grad():  # the frozen reference takes no gradient
            ref_c = completion_logprobs(self.ref_params, b["chosen"],
                                        b["chosen_mask"], self.cfg, self.env)
            ref_r = completion_logprobs(self.ref_params, b["rejected"],
                                        b["rejected_mask"], self.cfg,
                                        self.env)
        (loss, margin), grads = value_and_grad(
            lambda p: self._loss(p, b, ref_c, ref_r), self.params)
        self.params, self.opt_state = adamw_update(grads, self.opt_state,
                                                   self.opt_cfg)
        self.steps_done += 1
        return {"train_loss": float(loss), "dpo_margin": float(margin)}

    def train(self, pairs: Sequence[Tuple[Rollout, Rollout]], *,
              steps: int = 1, pad_pairs: Optional[int] = None,
              pad_len: Optional[int] = None) -> Dict[str, float]:
        """`steps` optimizer steps on one packed batch of pairs: the
        first and last losses, the final margin and the pair count. No
        pairs (all ties) is a no-op round."""
        if not pairs:
            return {"train_loss": 0.0, "train_loss_first": 0.0,
                    "dpo_margin": 0.0, "pairs_per_round": 0.0}
        batch = pack_pair_batch(pairs, pad_pairs=pad_pairs, pad_len=pad_len)
        first = last = None
        for _ in range(max(steps, 1)):
            m = self.step(batch)
            first = m if first is None else first
            last = m
        return {"train_loss": last["train_loss"],
                "train_loss_first": first["train_loss"],
                "dpo_margin": last["dpo_margin"],
                "pairs_per_round": float(len(pairs))}
