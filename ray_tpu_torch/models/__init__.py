"""Models of the port: the flagship transformer (dense or switch-MoE,
``moe``), its forward pass and train step, on one device or a mesh."""

from ray_tpu_torch.models.transformer import (  # noqa: F401
    Transformer, TransformerConfig, forward, init_params, loss_fn,
    make_train_state, make_train_step, param_specs)
