"""The autoscaler: demand-driven cluster scaling.

A port of ``ray_tpu.autoscaler`` (reference ``python/ray/autoscaler/``):
``StandardAutoscaler``, ``ResourceDemandScheduler`` (its pack mode on the
class-fill kernel), ``LoadMetrics``, the ``NodeProvider`` interface with
``FakeMultiNodeProvider`` (raylets of a ``Cluster``), the
``Monitor`` that bridges a cluster to the autoscaler and
``request_resources``.
"""

from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler  # noqa: F401
from ray_tpu_torch.autoscaler.load_metrics import LoadMetrics  # noqa: F401
from ray_tpu_torch.autoscaler.monitor import Monitor  # noqa: F401
from ray_tpu_torch.autoscaler.node_provider import (  # noqa: F401
    FakeMultiNodeProvider, NodeProvider)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import (  # noqa: F401
    ResourceDemandScheduler, get_bin_pack_residual)
from ray_tpu_torch.autoscaler.sdk import request_resources  # noqa: F401
