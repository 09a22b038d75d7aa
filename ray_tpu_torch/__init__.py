"""PyTorch/CUDA port of ray_tpu: the batched scheduling tick and its
placement-group and sinkhorn solves, and the transformer (dense or
switch-MoE) served and trained on one device.

The JAX package ``ray_tpu`` is the reference; this package imports
neither it nor JAX.  Its kernels are hand-written for Hopper (H100) and
are built from ``ray_tpu_torch/csrc/`` on first use, never at import.
"""

from ray_tpu_torch.models import (Transformer, TransformerConfig, forward,
                                  init_params, loss_fn)
from ray_tpu_torch.scheduler.torch_backend import (BatchSolver,
                                                   DeviceRuntimeSolver)

__all__ = ["BatchSolver", "DeviceRuntimeSolver", "Transformer",
           "TransformerConfig", "forward", "init_params", "loss_fn"]
