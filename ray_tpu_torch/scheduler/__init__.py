"""Scheduling package of the port.

- ``torch_backend`` — the batched tick: ``BatchSolver`` (matrix solve and
  the closed-loop stream) and ``DeviceRuntimeSolver`` (the raylet's
  per-tick session with resident world state).
- ``bundle_packing`` — placement-group bundle packing on the device
  solve, with the greedy solve and the host validation beside it.
- ``convert`` — carries the JAX solvers' world state into this package.
- ``policy`` / ``resources`` — host-side policy and resource shapes.
"""

from ray_tpu_torch.scheduler.torch_backend import (BatchSolver,
                                                   DeviceRuntimeSolver)

__all__ = ["BatchSolver", "DeviceRuntimeSolver"]
