"""qwen2-1.5b — dense GQA LM with QKV bias. [arXiv:2407.10671; hf]

12 query heads are not divisible by the 16-way TP axis; padded_heads pads the
Q projection to 16 heads (4 zero heads) for the production mesh. The waste is
visible in the MODEL_FLOPS/HLO_FLOPS ratio (EXPERIMENTS.md §Roofline).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    block_pattern=("attn",),
    source="arXiv:2407.10671; hf",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b-smoke",
        family="dense",
        n_layers=2,
        d_model=48,
        n_heads=3,  # deliberately non-power-of-two: exercises head padding
        n_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        qkv_bias=True,
        block_pattern=("attn",),
    )
