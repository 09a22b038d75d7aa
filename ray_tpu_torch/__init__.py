"""PyTorch/CUDA port of ray_tpu's batched scheduling tick.

The JAX package ``ray_tpu`` is the reference; this package imports
neither it nor JAX.  Its kernels are hand-written for Hopper (H100) and
are built from ``ray_tpu_torch/csrc/`` on first use, never at import.
"""

from ray_tpu_torch.scheduler.torch_backend import (BatchSolver,
                                                   DeviceRuntimeSolver)

__all__ = ["BatchSolver", "DeviceRuntimeSolver"]
