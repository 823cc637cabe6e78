"""rwkv6-1.6b — "Finch": attention-free RNN with data-dependent decay.
[arXiv:2404.05892; unverified]

head_size 64 -> 32 time-mix heads. Attention-free -> runs long_500k.
RWKV-6 channel-mix uses d_ff = 7168 (the assignment's d_ff).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # time-mix heads (d_model / head_dim)
    n_kv_heads=0,  # attention-free
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    block_pattern=("rwkv",),
    source="arXiv:2404.05892; unverified",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=0,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        block_pattern=("rwkv",),
    )
