"""PyTorch/CUDA port of ray_tpu: the task API (``init``, ``@remote``,
``get``, ``put``, ``wait``) on thread workers of an in-process cluster,
with its object plane (node stores that spill, pulls and relay between
raylets, lineage reconstruction);
placement groups (``ray_tpu_torch.util``) and the autoscaler's loop
(``ray_tpu_torch.autoscaler``);
the batched scheduling tick and its placement-group and sinkhorn solves;
the raylet's scheduling plane around the tick (``Raylet``, an in-process
``LocalCluster``) and the autoscaler's demand solve
(``ResourceDemandScheduler``); and the
transformer (dense or switch-MoE) served on one device and trained on one
device or on a device mesh over ``torch.distributed`` (tensor, data,
context, expert and pipeline parallelism).

The JAX package ``ray_tpu`` is the reference; this package imports
neither it nor JAX.  Its kernels are hand-written for Hopper (H100) and
are built from ``ray_tpu_torch/csrc/`` on first use, never at import.
"""

from ray_tpu_torch import exceptions  # noqa: F401
from ray_tpu_torch._private.cluster import LocalCluster
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.raylet import Raylet
from ray_tpu_torch._private.worker import (available_resources,
                                           cluster_resources, get, init,
                                           is_initialized, nodes, put,
                                           shutdown, wait)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import \
    ResourceDemandScheduler
from ray_tpu_torch.models import (Transformer, TransformerConfig, forward,
                                  init_params, loss_fn, make_train_state,
                                  make_train_step, param_specs)
from ray_tpu_torch.parallel import (MeshConfig, build_mesh,
                                    infer_mesh_config, single_device_mesh)
from ray_tpu_torch.runtime_context import get_runtime_context
from ray_tpu_torch.scheduler.torch_backend import (BatchSolver,
                                                   DeviceRuntimeSolver)
# The placement-group API, as ``ray_tpu.util`` (``ray.util``).
from ray_tpu_torch import util  # noqa: E402,F401

__all__ = ["BatchSolver", "DeviceRuntimeSolver", "LocalCluster",
           "MeshConfig", "ObjectRef", "Raylet", "ResourceDemandScheduler",
           "Transformer", "TransformerConfig", "available_resources",
           "build_mesh", "cluster_resources", "exceptions", "forward", "get",
           "get_runtime_context", "infer_mesh_config", "init", "init_params",
           "is_initialized", "loss_fn", "make_train_state",
           "make_train_step", "nodes", "param_specs", "put", "remote",
           "shutdown", "single_device_mesh", "util", "wait"]


def remote(*args, **kwargs):
    """The ``@remote`` decorator for functions (reference
    worker.py:2221)::

        @ray_tpu_torch.remote
        def f(x): ...

        @ray_tpu_torch.remote(num_cpus=2, max_retries=3)
        def g(x): ...

    Classes (actors) are not ported yet (ROADMAP A.4b.5) and raise.
    """
    import inspect

    from ray_tpu_torch.remote_function import RemoteFunction

    def make(target, options):
        if inspect.isclass(target):
            raise NotImplementedError(
                "@remote on a class: actors are not ported yet "
                "(ROADMAP A.4b.5)")
        if not callable(target):
            raise TypeError("@remote target must be a function or class")
        return RemoteFunction(target, options)

    if len(args) == 1 and not kwargs and callable(args[0]):
        return make(args[0], {})
    if args:
        raise TypeError("@remote takes keyword options only, e.g. "
                        "@remote(num_cpus=2)")
    return lambda target: make(target, kwargs)
