"""Analytic per-device HBM model: the roofline's memory term and the fit
check (port of the JAX package's launch/memory_model.py).

The model is the JAX package's, component for component and constant for
constant (tests/test_torch_dryrun.py holds the two equal on every cell of
configs.cells() over both production meshes): the HBM bytes a step moves
(traffic) and the bytes a device holds at its peak (residency), from the
config, the plan and the mesh's axis sizes, with no device and no trace.
Its trees are init_params' and init_cache's on the meta device
(launch/steps.py params_struct, cache_struct).

For a train cell the formula's weight, gradient and optimizer bytes
(MemoryReport.train_state: P_dev twice and half of opt_rw) are held
against the tensors the port allocates (optim/adamw.py adamw_init: an
f32 master copy and two moments, f32 or int8 rows with f32 scales, and
an int32 step). They differ by a known amount (formula_excess): the
formula counts P_dev / 2 parameters at 12 or 6.3 bytes each, so it reads
every parameter as bf16, and an f32 leaf (the norms' scales, the
recurrences' f32 parameters) counts as two; 6.3 stands for the 4-byte
master, two int8 moments and their per-row scales; the step counter is
not counted.

All numbers are per device, per step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.env import Env, vocab_pad
from repro_torch.optim.adamw import tree_leaves


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a nest (meta tensors included)."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


@dataclass(frozen=True)
class MemoryReport:
    traffic_bytes: int  # HBM bytes moved per step (roofline memory term)
    resident_bytes: int  # persistent + peak transient residency
    components: Dict[str, int]

    @property
    def fits_16GB(self) -> bool:
        return self.resident_bytes < 16e9

    def fits(self, capacity_bytes: float) -> bool:
        """Whether the modeled residency fits a device of that many
        bytes (the H100's 80 GB: launch/roofline.py H100; on the card its
        torch.cuda.get_device_properties(0).total_memory)."""
        return self.resident_bytes < capacity_bytes

    def train_state(self) -> Dict[str, int]:
        """A train cell's weight, gradient and optimizer bytes per device
        as the formula counts them: P_dev (grads_w) for the weights and
        again for their gradients, half of opt_rw for the optimizer."""
        c = self.components
        if "opt_rw" not in c:
            return {}
        return {"weights": c["grads_w"], "grads": c["grads_w"],
                "opt": c["opt_rw"] // 2}


def formula_excess(params, opt_state_bytes_per_param: float) -> float:
    """The bytes by which train_state()["opt"] exceeds the AdamW state
    adamw_init allocates for these parameters (one device): the formula
    counts a leaf of b bytes as b / 2 parameters at the given bytes each;
    the port holds an f32 master (4 bytes an element) and two moments,
    f32 (8 bytes an element) or, at 6.3, int8 (2 bytes an element, 8 a
    row for the two f32 scales; a 1-D leaf's moments stay f32), and a
    4-byte step counter."""
    int8 = opt_state_bytes_per_param < 12.0
    out = -4.0  # the int32 step
    for x in tree_leaves(params):
        n = x.numel()
        if int8 and x.dim() >= 2:
            held = 4 * n + 2 * n + 8 * (n // x.shape[-1])
        else:
            held = 12 * n
        out += opt_state_bytes_per_param * n * x.element_size() / 2 - held
    return out


def analyze_memory(cfg: ModelConfig, shape: ShapeConfig, env: Env,
                   opt_state_bytes_per_param: float = 12.0) -> MemoryReport:
    """The JAX package's analyze_memory."""
    from repro_torch.launch import steps as S

    p_struct = S.params_struct(cfg, env)
    P_global = tree_bytes(p_struct)
    tp = max(env.tp, 1)
    dp = max(env.dp, 1)
    fsdp = env.plan.fsdp
    # params are TP-sharded always; FSDP adds the dp axis
    P_dev = P_global / (tp * (dp if fsdp else 1))
    n_params_dev = P_dev / 2  # bf16

    B_loc = max(shape.global_batch // dp, 1)
    S_len = shape.seq_len
    d = cfg.d_model
    vp = vocab_pad(cfg, env)
    L = cfg.n_layers

    comp: Dict[str, int] = {}

    if shape.kind == "train":
        # weights: fwd read + bwd read (+ remat recompute read) of the
        # *gathered* (TP-sharded-only) copy; grads written sharded
        gather_factor = 3.0 if env.plan.remat != "full" else 2.0
        comp["weights_rw"] = int(gather_factor * P_global / tp)
        comp["grads_w"] = int(P_dev)
        comp["opt_rw"] = int(2 * n_params_dev * opt_state_bytes_per_param)
        # saved carries (remat nothing): one [B,S,d] per layer, w+r;
        # sequence-parallel carries are tp-sharded
        sp_div = tp if (env.plan.seq_shard_acts and S_len % tp == 0) else 1
        comp["act_saved"] = int(2 * L * B_loc * S_len * d * 2 / sp_div)
        # attention kv stream: per layer, per q-chunk pass over K and V
        hkv = max(cfg.n_kv_heads, 1)
        nq = max(S_len // env.plan.attn_q_chunk, 1)
        n_attn = _n_attn_layers(cfg)
        comp["attn_kv_stream"] = int(
            2 * n_attn * nq * B_loc * S_len * hkv * cfg.head_dim * 2)
        comp["logits"] = int(3 * B_loc * S_len * vp / tp * 2)
        resident = int(P_dev + n_params_dev * opt_state_bytes_per_param
                       + P_dev  # grads
                       + L * B_loc * S_len * d * 2 / sp_div  # saved carries
                       + B_loc * S_len * vp / tp * 4  # logits f32 transient
                       + 2e9)  # workspace
    elif shape.kind == "prefill":
        comp["weights_r"] = int(P_global / tp)
        comp["acts"] = int(2 * L * B_loc * S_len * d * 2)
        cache = _cache_bytes_dev(cfg, shape, env, B_loc)
        comp["cache_w"] = int(cache)
        hkv = max(cfg.n_kv_heads, 1)
        nq = max(S_len // env.plan.attn_q_chunk, 1)
        comp["attn_kv_stream"] = int(
            2 * _n_attn_layers(cfg) * nq * B_loc * S_len * hkv
            * cfg.head_dim * 2)
        comp["logits"] = int(B_loc * 1 * vp / tp * 2)
        resident = int(P_dev + cache + B_loc * S_len * d * 2 * 4 + 1e9)
    else:  # decode
        comp["weights_r"] = int(P_global / tp)
        cache = _cache_bytes_dev(cfg, shape, env, B_loc)
        comp["cache_rw"] = int(cache + 2 * B_loc * 1 * d * 2 * L)
        comp["logits"] = int(B_loc * vp / tp * 2)
        resident = int(P_dev + 2 * cache + 1e9)

    return MemoryReport(traffic_bytes=sum(comp.values()),
                        resident_bytes=resident, components=comp)


def _n_attn_layers(cfg: ModelConfig) -> int:
    full = sum(k in ("attn", "moe", "enc", "dec") for k in cfg.block_pattern)
    n = full * cfg.num_blocks + cfg.encoder_layers
    n += sum(k in ("attn", "moe", "dec") for k in cfg.pattern_tail)
    return max(n, 1)


def _cache_bytes_dev(cfg: ModelConfig, shape: ShapeConfig, env: Env,
                     B_loc: int) -> int:
    from repro_torch.launch import steps as S
    total = tree_bytes(S.cache_struct(cfg, env, shape))
    dp = max(env.dp, 1)
    tp = max(env.tp, 1)
    per_batch = total / dp
    if env.plan.kv_cache == "seq_sharded":
        # k/v leaves shard their seq dim over tp; states shard width/heads
        return int(per_batch / tp)
    return int(per_batch)
