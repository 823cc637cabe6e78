"""recurrentgemma-9b — Griffin hybrid: RG-LRU + local attention, 2:1.
[arXiv:2402.19427; unverified]

38 layers = 12 x (rglru, rglru, local) + tail (rglru, rglru).
Sub-quadratic (local window 2048) -> runs the long_500k shape.
MQA (kv=1): KV replicated across TP, Q heads sharded.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    rope_theta=10_000.0,
    block_pattern=("rglru", "rglru", "local"),
    pattern_tail=("rglru", "rglru"),
    local_window=2048,
    lru_width=4096,
    conv_width=4,
    source="arXiv:2402.19427; unverified",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke",
        family="hybrid",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
        block_pattern=("rglru", "rglru", "local"),
        pattern_tail=("rglru", "rglru"),
        local_window=16,
        lru_width=64,
        conv_width=4,
    )
