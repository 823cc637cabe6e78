"""qwen2-vl-7b — VLM backbone with M-RoPE; vision frontend STUBBED.
[arXiv:2409.12191; hf]

Per the assignment the patch embedder is a stub: input_specs() provides
precomputed patch embeddings (num_vision_embeds x d_model) prepended to the
token stream. M-RoPE splits each head's rotary dims into (temporal, h, w)
sections (16, 24, 24 pairs). 28 heads pad to 32 for the 16-way TP axis.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    num_vision_embeds=256,
    block_pattern=("attn",),
    source="arXiv:2409.12191; hf",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        qkv_bias=True,
        mrope=True,
        mrope_sections=(2, 3, 3),
        num_vision_embeds=8,
        block_pattern=("attn",),
    )
