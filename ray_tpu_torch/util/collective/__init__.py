"""ray_tpu_torch.util.collective: collective communication between
actors and tasks (reference ``ray_tpu.util.collective``).

Each group rendezvouses through a named detached actor: every rank
contributes its tensor for a slot, rank 0 computes the result once the
slot is full (a reduction is one ``torch.stack`` and one reduction on
the cluster's device), and every rank fetches it.  SPMD code on a device
mesh uses ``torch.distributed`` directly (``ray_tpu_torch.parallel``)
and needs no group here.
"""

from ray_tpu_torch.util.collective.collective import (  # noqa: F401
    allgather, allreduce, barrier, broadcast, create_collective_group,
    destroy_collective_group, get_collective_group_size, get_rank,
    init_collective_group, is_group_initialized, recv, reducescatter, send)
from ray_tpu_torch.util.collective.types import ReduceOp  # noqa: F401

__all__ = [
    "init_collective_group", "create_collective_group",
    "destroy_collective_group", "is_group_initialized", "get_rank",
    "get_collective_group_size", "allreduce", "allgather", "reducescatter",
    "broadcast", "send", "recv", "barrier", "ReduceOp",
]
