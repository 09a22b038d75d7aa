"""ray_tpu_torch.serve: model serving on the actor runtime.

The port of ``ray_tpu.serve``, module for module (``handle``,
``batching``, ``replica``, ``router``, ``controller``, ``http_proxy``,
``api``, ``pipeline``).  The controller places replicas through the
pack-mode solve on the cluster's device (``_kernel_place``, the
class-fill kernel on the card); divergences C.30 (a failed solve is
counted and raised) and C.31 (``deploy`` waits for the HTTP proxy's
route) are in ROADMAP.md.

Parity: reference ``python/ray/serve/`` — detached ``ServeController``
holding goal state (controller.py:39), ``DeploymentState`` reconciler
scaling replica actors (deployment_state.py), ``Router`` with
round-robin + backpressure (router.py:170), ``@serve.deployment`` API
(api.py:1032), ``@serve.batch`` batching (batching.py), long-poll config
push (reference long_poll.py; here ``ServeController.listen_for_change``),
queue-metric autoscaling (autoscaling_policy.py), HTTP proxy
(reference http_proxy.py; stdlib ThreadingHTTPServer in
``serve/http_proxy.py``).
"""

from ray_tpu_torch.serve.api import (  # noqa: F401
    Deployment, delete, deployment, get_deployment, list_deployments, run,
    shutdown, start)
from ray_tpu_torch.serve.batching import batch  # noqa: F401
from ray_tpu_torch.serve.handle import DeploymentHandle  # noqa: F401
from ray_tpu_torch.serve.http_proxy import HTTPRequest  # noqa: F401
from ray_tpu_torch.serve import pipeline  # noqa: F401
from ray_tpu_torch.serve.pipeline import InputNode  # noqa: F401

__all__ = ["Deployment", "DeploymentHandle", "HTTPRequest", "batch",
           "pipeline", "InputNode",
           "delete", "deployment", "get_deployment", "list_deployments",
           "run", "shutdown", "start"]
