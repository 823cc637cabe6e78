from repro_torch.data.pipeline import (  # noqa: F401
    MemmapCorpus,
    ShardedLoader,
    SyntheticLM,
    add_modality_stubs,
)
