"""qwen3-32b — dense GQA LM with qk-norm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    block_pattern=("attn",),
    source="hf:Qwen/Qwen3-8B; hf",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        qk_norm=True,
        block_pattern=("attn",),
    )
