"""Config dataclasses for models, input shapes, and parallelism plans.

Every assigned architecture is a `ModelConfig`; every assigned input shape is a
`ShapeConfig`; the sharding strategy for an (arch x shape x mesh) cell is a
`ParallelPlan`.  Configs are frozen and content-hashable.

A copy of the JAX package's configs/base.py: the port keeps its own so that
it imports nothing of that package, and the two must describe the same
shapes (tests/test_torch_model.py holds the bridged parameters to them).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# --------------------------------------------------------------------------
# Block kinds (the repeating unit of a model is a tuple of these):
#   "attn"   dense GQA attention + SwiGLU MLP (pre-RMSNorm, residual)
#   "moe"    dense GQA attention + mixture-of-experts MLP
#   "local"  sliding-window GQA attention + MLP (Griffin local block)
#   "rglru"  Griffin recurrent block (conv1d + RG-LRU) + MLP
#   "rwkv"   RWKV-6 time-mix + channel-mix
#   "enc"    bidirectional encoder attention + MLP (whisper encoder)
#   "dec"    causal self-attn + cross-attn + MLP (whisper decoder)
# --------------------------------------------------------------------------

VALID_KINDS = ("attn", "moe", "local", "rglru", "rwkv", "enc", "dec")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | audio | ssm | vlm
    n_layers: int  # decoder layers (repeating pattern + tail)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False  # Qwen2-VL multimodal rope
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # block structure: the repeating unit & optional non-repeating tail.
    block_pattern: Tuple[str, ...] = ("attn",)
    pattern_tail: Tuple[str, ...] = ()
    # hybrid / ssm extras
    local_window: int = 0  # sliding window for "local" blocks
    lru_width: int = 0  # RG-LRU recurrence width (0 -> d_model)
    conv_width: int = 4  # Griffin temporal conv
    # moe
    moe: Optional[MoEConfig] = None
    # enc-dec
    encoder_layers: int = 0
    enc_downsample: int = 1  # stub frontend downsample factor (whisper conv =2)
    # vlm
    num_vision_embeds: int = 0  # prepended precomputed patch embeds (stub)
    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act_dtype: str = "bfloat16"
    source: str = ""  # provenance tag from the assignment table

    def __post_init__(self):
        for k in self.block_pattern + self.pattern_tail:
            if k not in VALID_KINDS:
                raise ValueError(f"unknown block kind {k!r}")
        n_pat = self.n_layers - len(self.pattern_tail)
        if len(self.block_pattern) == 0 or n_pat % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} incompatible with "
                f"pattern {self.block_pattern} + tail {self.pattern_tail}"
            )

    # ---- derived ---------------------------------------------------------
    @property
    def num_blocks(self) -> int:
        """Scan trip count over the repeating unit."""
        return (self.n_layers - len(self.pattern_tail)) // len(self.block_pattern)

    @property
    def attn_free(self) -> bool:
        kinds = set(self.block_pattern) | set(self.pattern_tail)
        return kinds <= {"rwkv"}

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends over the full (unbounded) context."""
        kinds = set(self.block_pattern) | set(self.pattern_tail)
        full_attn = {"attn", "moe", "enc", "dec"}
        return not (kinds & full_attn)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    # TP divisibility padding (model axis = 16): see DESIGN.md §4
    def padded_vocab(self, tp: int = 16) -> int:
        return _round_up(self.vocab_size, max(128, tp))

    def padded_heads(self, tp: int = 16) -> int:
        return _round_up(self.n_heads, tp)

    @property
    def rglru_width(self) -> int:
        return self.lru_width or self.d_model

    # ---- parameter count (for MODEL_FLOPS = 6*N*D) ------------------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (unpadded). active_only: MoE top-k only."""
        d, ff, hd = self.d_model, self.d_ff, self.head_dim
        nq, nkv = self.n_heads, self.n_kv_heads

        def attn_params() -> int:
            p = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
            if self.qkv_bias:
                p += (nq + 2 * nkv) * hd
            if self.qk_norm:
                p += 2 * hd
            return p

        def mlp_params() -> int:
            return 3 * d * ff  # SwiGLU: gate, up, down

        def moe_params() -> int:
            assert self.moe is not None
            e = self.moe.num_experts if not active_only else self.moe.top_k
            return e * 3 * d * ff + d * self.moe.num_experts  # experts + router

        def rglru_params() -> int:
            w = self.rglru_width
            # in/gate proj, conv1d, lru gates (input+rec), out proj + mlp
            return 2 * d * w + self.conv_width * w + 2 * w * w // 1 + w * d + mlp_params()

        def local_params() -> int:
            return attn_params() + mlp_params()

        def rwkv_params() -> int:
            # time-mix: r,k,v,g,o projections + decay lora + tokenshift lerps
            tm = 5 * d * d + 2 * d * 64 + 6 * d
            cm = 2 * d * self.d_ff // 2 + d * d  # rwkv channel mix (k->ff, v->d)
            return tm + cm

        per_kind = {
            "attn": lambda: attn_params() + mlp_params(),
            "moe": lambda: attn_params() + moe_params(),
            "local": local_params,
            "rglru": rglru_params,
            "rwkv": rwkv_params,
            "enc": lambda: attn_params() + mlp_params(),
            "dec": lambda: 2 * attn_params() + mlp_params(),
        }
        total = 0
        for k in self.block_pattern:
            total += per_kind[k]() * self.num_blocks
        for k in self.pattern_tail:
            total += per_kind[k]()
        total += self.encoder_layers * per_kind["enc"]()
        total += d * self.vocab_size * (1 if self.tie_embeddings else 2)
        return total

    def digest(self) -> str:
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True, default=str)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    long_context: bool = False

    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode", long_context=True),
}


@dataclass(frozen=True)
class ParallelPlan:
    """How an (arch x shape) cell is laid out on the mesh.

    Axis names must exist in the mesh ("pod" is silently dropped on the
    single-pod mesh).
    """
    dp_axes: Tuple[str, ...] = ("pod", "data")
    tp_axis: str = "model"
    fsdp: bool = True  # shard weights/opt-state over dp_axes[-1] too
    remat: str = "nothing"  # nothing | dots | full(=no remat)
    attn_impl: str = "xla_chunked"  # naive | xla_chunked | pallas
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    kv_cache: str = "seq_sharded"  # replicated | seq_sharded (over tp_axis)
    moe_mode: str = "auto"  # auto | ep | tp  (ep needs E % tp_size == 0)
    scan_unroll: int = 1
    seq_shard_acts: bool = True  # Megatron-SP style: residual stream
    # sequence-sharded over tp between blocks (cuts saved-activation
    # residency ~tp x; the extra all-gather/reduce-scatter shows up in
    # the collective term)
    inner_unroll: bool = False  # unroll attention/rwkv chunk scans (roofline
    # unit lowerings need exact per-unit HLO costs; see launch/roofline.py)
    rwkv_chunk: int = 64
    # gradient sync
    grad_compression: str = "none"  # none | int8_ef (cross-pod)

    def resolve_moe(self, cfg: ModelConfig, tp_size: int) -> str:
        if self.moe_mode != "auto":
            return self.moe_mode
        if cfg.moe and cfg.moe.num_experts % tp_size == 0:
            return "ep"
        return "tp"


def default_plan(cfg: ModelConfig, shape: ShapeConfig) -> ParallelPlan:
    """Baseline (paper-faithful-era) plan; hillclimbs override fields."""
    big = cfg.param_count() > 3e9
    return ParallelPlan(
        fsdp=big or cfg.moe is not None,
        remat="nothing" if shape.kind == "train" else "full",
        attn_impl="xla_chunked",
        kv_cache="seq_sharded" if shape.kind in ("decode", "prefill")
        else "replicated",
    )
