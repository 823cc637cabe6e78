"""llama4-scout-17b-a16e — MoE LM, 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

16 experts / 16-way TP axis -> expert-parallel (EP) sharding: one expert per
model shard, tokens routed via all_to_all inside shard_map.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    rope_theta=500_000.0,
    moe=MoEConfig(num_experts=16, top_k=1),
    block_pattern=("moe",),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        moe=MoEConfig(num_experts=4, top_k=1),
        block_pattern=("moe",),
    )
