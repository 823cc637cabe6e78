from repro_torch.parallel.rules import (  # noqa: F401
    apply_shardings,
    batch_specs,
    cache_specs,
    param_specs,
    state_specs,
    to_shardings,
)
