"""PyTorch/CUDA port of ray_tpu: the batched scheduling tick and its
placement-group and sinkhorn solves, and the transformer (dense or
switch-MoE) served on one device and trained on one device or on a
device mesh over ``torch.distributed`` (tensor, data, context, expert and
pipeline parallelism).

The JAX package ``ray_tpu`` is the reference; this package imports
neither it nor JAX.  Its kernels are hand-written for Hopper (H100) and
are built from ``ray_tpu_torch/csrc/`` on first use, never at import.
"""

from ray_tpu_torch.models import (Transformer, TransformerConfig, forward,
                                  init_params, loss_fn, make_train_state,
                                  make_train_step, param_specs)
from ray_tpu_torch.parallel import (MeshConfig, build_mesh,
                                    infer_mesh_config, single_device_mesh)
from ray_tpu_torch.scheduler.torch_backend import (BatchSolver,
                                                   DeviceRuntimeSolver)

__all__ = ["BatchSolver", "DeviceRuntimeSolver", "MeshConfig", "Transformer",
           "TransformerConfig", "build_mesh", "forward", "infer_mesh_config",
           "init_params", "loss_fn", "make_train_state", "make_train_step",
           "param_specs", "single_device_mesh"]
