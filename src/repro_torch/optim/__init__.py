from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_lr,
    global_norm,
    make_train_state,
    tree_leaves,
    tree_map,
    value_and_grad,
)
from repro_torch.optim.compress import ef_psum_grads, init_error  # noqa: F401
