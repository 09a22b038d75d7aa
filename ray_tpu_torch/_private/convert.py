"""Build the runtime's objects from plain data.

The runtime's inputs play the part of weights here: a cluster view and
the task specs queued against it.  These functions make the port's
objects from plain data (ids as bytes, resource names, quantized rows,
dicts), as read out of the JAX package's objects or made from a seed, so
that both packages can start from the same state.  Like
``scheduler/convert.py``, nothing here imports the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ray_tpu_torch._private import ids
from ray_tpu_torch._private.task_spec import (TaskArg, TaskSpec,
                                              scheduling_class_of)
from ray_tpu_torch.scheduler.policy import SchedulingOptions, SchedulingType
from ray_tpu_torch.scheduler.resources import (FP_SCALE, ClusterResourceView,
                                               NodeResources, ResourceRequest)

# TaskSpec fields that hold an id, and the id type of each.
_ID_FIELDS = {"task_id": ids.TaskID, "job_id": ids.JobID,
              "function_id": ids.FunctionID, "owner_id": ids.WorkerID,
              "parent_task_id": ids.TaskID, "actor_id": ids.ActorID,
              "placement_group_id": ids.PlacementGroupID}


def node_resources_from_quantized(columns: Sequence[str], total_q, avail_q,
                                  labels: Optional[Dict] = None
                                  ) -> NodeResources:
    """One node's ledger from its quantized (1/10,000) rows."""
    nr = NodeResources({c: int(q) / FP_SCALE
                        for c, q in zip(columns, total_q) if q > 0},
                       labels=dict(labels or {}))
    nr.available = {c: int(q) for c, q in zip(columns, avail_q) if q > 0}
    return nr


def view_from_quantized(node_ids: Sequence[bytes], columns: Sequence[str],
                        total_q: np.ndarray, avail_q: np.ndarray,
                        labels: Optional[Sequence[Dict]] = None
                        ) -> ClusterResourceView:
    """A ``ClusterResourceView`` with one node per id (``NodeID`` of the
    bytes), in order, from [N, R] quantized total and available rows
    over ``columns``."""
    view = ClusterResourceView()
    for i, nid in enumerate(node_ids):
        view.add_node(ids.NodeID(bytes(nid)), node_resources_from_quantized(
            columns, total_q[i], avail_q[i],
            labels[i] if labels is not None else None))
    return view


def scheduling_options_from_fields(fields: Dict) -> SchedulingOptions:
    """``fields``: the option attributes, the type by its value
    (``"hybrid"``, ``"spread"``, ...), the affinity node id as bytes."""
    f = dict(fields)
    f["scheduling_type"] = SchedulingType(f["scheduling_type"])
    nid = f.get("node_affinity_node_id")
    if nid is not None:
        f["node_affinity_node_id"] = ids.NodeID(bytes(nid))
    return SchedulingOptions(**f)


def task_spec_from_fields(fields: Dict) -> TaskSpec:
    """A ``TaskSpec`` from its fields: ids as bytes, ``resources`` and
    ``lifetime_resources`` as dicts, ``scheduling_options`` as for
    :func:`scheduling_options_from_fields`, ``args`` as dicts of
    ``TaskArg``'s fields (object and owner ids as bytes).  The
    scheduling class is interned in the port's table."""
    f = dict(fields)
    for name, cls in _ID_FIELDS.items():
        if f.get(name) is not None:
            f[name] = cls(bytes(f[name]))
    f["resources"] = ResourceRequest(f["resources"])
    if f.get("lifetime_resources") is not None:
        f["lifetime_resources"] = ResourceRequest(f["lifetime_resources"])
    f["scheduling_options"] = scheduling_options_from_fields(
        f["scheduling_options"])
    args = []
    for a in f.get("args", ()):
        a = dict(a)
        if a.get("object_id") is not None:
            a["object_id"] = ids.ObjectID(bytes(a["object_id"]))
        if a.get("owner_id") is not None:
            a["owner_id"] = ids.WorkerID(bytes(a["owner_id"]))
        args.append(TaskArg(**a))
    f["args"] = args
    f["scheduling_class"] = scheduling_class_of(f["resources"],
                                                f["scheduling_options"])
    return TaskSpec(**f)
