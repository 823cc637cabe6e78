"""granite-3-8b — dense GQA LM. [hf:ibm-granite/granite-3.0-2b-base; hf]

vocab 49155 is not divisible by the 16-way TP axis; ModelConfig.padded_vocab
pads it to 49280 (multiple of 128) for the embedding/unembedding shards.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    head_dim=128,
    rope_theta=10_000.0,
    block_pattern=("attn",),
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=515,  # deliberately odd: exercises vocab padding
        head_dim=16,
        block_pattern=("attn",),
    )
