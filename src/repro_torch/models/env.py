"""Execution environment threaded through model code (single device).

The JAX package's Env carries a device mesh and a ParallelPlan and pads
heads and vocabulary for its tensor-parallel degree. The port runs on one
device, so the degree is 1 and the padding helpers reduce to their tp=1
values; they stay functions of (cfg, env) so shapes are computed exactly
where the JAX package computes them.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import ModelConfig, ParallelPlan

# The reference's SERVE_PLAN (serve/scheduler.py) takes "pallas" on a TPU
# and "naive" elsewhere. The port serves as the pallas plan does on every
# device (its kernels on the card, their plain versions on the CPU:
# prefill past 128 tokens through flash attention, f32 decode
# probabilities), so it names that plan. Train mode reads this field for
# the DPO trainer and the logprob scorer: at sequences of up to 128
# positions both plans take attention_naive, so the port trains as the
# reference's CPU runs do; past 128 the pallas plan raises, as jax.grad
# through the reference's flash kernel does on a TPU.
SERVE_PLAN = ParallelPlan(fsdp=False, remat="full", attn_impl="pallas",
                          kv_cache="replicated")


@dataclass(frozen=True)
class Env:
    plan: ParallelPlan = field(default_factory=lambda: SERVE_PLAN)

    @property
    def tp(self) -> int:
        return 1


def head_pad(cfg: ModelConfig, env: Env) -> int:
    """Padded query-head count for the current TP degree."""
    tp = env.tp
    if tp <= 1:
        return cfg.n_heads
    return ((cfg.n_heads + tp - 1) // tp) * tp


def kv_head_pad(cfg: ModelConfig, env: Env) -> int:
    """MHA (kv == q heads) pads KV heads alongside Q so GQA grouping stays
    integral; GQA keeps its true KV head count."""
    hkv = max(cfg.n_kv_heads, 1)
    if cfg.n_kv_heads == cfg.n_heads:
        return head_pad(cfg, env)
    return hkv


def vocab_pad(cfg: ModelConfig, env: Env) -> int:
    tp = max(env.tp, 1)
    m = max(128, tp) if tp > 1 else 8
    return ((cfg.vocab_size + m - 1) // m) * m
