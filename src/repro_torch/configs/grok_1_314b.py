"""grok-1-314b — MoE LM, 8 experts top-2. [hf:xai-org/grok-1; unverified]

8 experts are not divisible by the 16-way TP axis, so EP-over-model is
inapplicable (DESIGN.md §7): experts use TP-within-expert (ff over "model")
with FSDP over "data". Optimizer states are int8-blockwise to fit one pod.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=8, top_k=2),
    block_pattern=("moe",),
    source="hf:xai-org/grok-1; unverified",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        moe=MoEConfig(num_experts=4, top_k=2),
        block_pattern=("moe",),
    )
