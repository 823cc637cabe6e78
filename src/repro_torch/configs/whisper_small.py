"""whisper-small — encoder-decoder backbone; conv frontend STUBBED.
[arXiv:2212.04356; unverified]

Per the assignment, the modality frontend is a stub: input_specs() provides
precomputed frame embeddings (post-conv, 2x downsampled). Decode shapes lower
the decoder serve_step with self- and cross-attention KV caches. The assigned
sequence lengths are mechanical, not speech-realistic (DESIGN.md §5).
12 heads pad to 16 for the TP axis; vocab 51865 pads to 51968.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,  # decoder layers
    encoder_layers=12,
    enc_downsample=2,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,  # MHA
    d_ff=3072,
    vocab_size=51865,
    head_dim=64,
    block_pattern=("dec",),
    source="arXiv:2212.04356; unverified",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke",
        family="audio",
        n_layers=2,
        encoder_layers=2,
        enc_downsample=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=515,
        head_dim=16,
        block_pattern=("dec",),
    )
