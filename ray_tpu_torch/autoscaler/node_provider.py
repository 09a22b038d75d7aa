"""Node providers: the pluggable "how do I get a machine" interface.

A port of ``ray_tpu.autoscaler.node_provider`` for the PyTorch port:
``NodeProvider``, ``MockProvider`` and ``FakeMultiNodeProvider``, the
last adding and removing raylets of a ``Cluster``
(``add_node(resources)``, ``remove_node``).  ``LocalProcessProvider``,
which launches node-host OS processes, waits for process workers and the
wire (ROADMAP A.4b.9).

Parity: reference ``python/ray/autoscaler/node_provider.py`` (ABC with
``non_terminated_nodes/create_node/terminate_node/node_tags/...``) and
``python/ray/autoscaler/_private/fake_multi_node/node_provider.py``
(multi-node on one machine by launching extra in-process raylets with
distinct fake node IDs — the test substrate for autoscaler e2e runs).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

TAG_NODE_KIND = "node-kind"  # "head" | "worker"
TAG_NODE_TYPE = "user-node-type"
TAG_NODE_STATUS = "node-status"
STATUS_UP_TO_DATE = "up-to-date"
STATUS_UNINITIALIZED = "uninitialized"
NODE_KIND_HEAD = "head"
NODE_KIND_WORKER = "worker"


class NodeProvider:
    """Abstract provider. Node ids are provider-scoped strings."""

    def __init__(self, provider_config: Optional[dict] = None,
                 cluster_name: str = "default"):
        self.provider_config = provider_config or {}
        self.cluster_name = cluster_name

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        raise NotImplementedError

    def is_running(self, node_id: str) -> bool:
        raise NotImplementedError

    def is_terminated(self, node_id: str) -> bool:
        raise NotImplementedError

    def node_tags(self, node_id: str) -> Dict[str, str]:
        raise NotImplementedError

    def internal_ip(self, node_id: str) -> str:
        raise NotImplementedError

    def create_node(self, node_config: dict, tags: Dict[str, str],
                    count: int) -> None:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def set_node_tags(self, node_id: str, tags: Dict[str, str]) -> None:
        raise NotImplementedError


class MockProvider(NodeProvider):
    """In-memory provider for unit tests (reference
    ``python/ray/tests/autoscaler_test_utils.py`` MockProvider)."""

    def __init__(self, provider_config=None, cluster_name="mock"):
        super().__init__(provider_config, cluster_name)
        self._nodes: Dict[str, Dict[str, Any]] = {}
        self._next = 0
        self.lock = threading.RLock()
        self.fail_creates = False

    def non_terminated_nodes(self, tag_filters=None):
        tag_filters = tag_filters or {}
        with self.lock:
            out = []
            for nid, n in self._nodes.items():
                if n["terminated"]:
                    continue
                if all(n["tags"].get(k) == v for k, v in tag_filters.items()):
                    out.append(nid)
            return out

    def is_running(self, node_id):
        with self.lock:
            return node_id in self._nodes and \
                not self._nodes[node_id]["terminated"]

    def is_terminated(self, node_id):
        with self.lock:
            n = self._nodes.get(node_id)
            return n is None or n["terminated"]

    def node_tags(self, node_id):
        with self.lock:
            return dict(self._nodes[node_id]["tags"])

    def internal_ip(self, node_id):
        return f"172.0.0.{int(node_id)}"

    def create_node(self, node_config, tags, count):
        if self.fail_creates:
            return
        with self.lock:
            for _ in range(count):
                nid = str(self._next)
                self._next += 1
                self._nodes[nid] = {"tags": dict(tags), "terminated": False,
                                    "config": dict(node_config or {}),
                                    "created_at": time.time()}

    def terminate_node(self, node_id):
        with self.lock:
            if node_id in self._nodes:
                self._nodes[node_id]["terminated"] = True

    def set_node_tags(self, node_id, tags):
        with self.lock:
            self._nodes[node_id]["tags"].update(tags)


class FakeMultiNodeProvider(NodeProvider):
    """Backs provider nodes with real in-process raylets on a
    ``Cluster``: autoscaler decisions add and remove schedulable
    nodes, as the reference's fake_multi_node provider launches real
    raylet processes.  A node gets its type's ``resources`` (``{"CPU":
    1}`` by default), those above 0."""

    def __init__(self, cluster, node_types: Dict[str, dict],
                 cluster_name: str = "fake"):
        super().__init__({"node_types": node_types}, cluster_name)
        self.cluster = cluster
        self.node_types = node_types
        self._raylets: Dict[str, Any] = {}
        self._tags: Dict[str, Dict[str, str]] = {}
        self._terminated: set = set()
        self.lock = threading.RLock()
        # The pre-existing head node.
        head = cluster.head_node
        hid = head.node_id.hex()
        self._raylets[hid] = head
        self._tags[hid] = {TAG_NODE_KIND: NODE_KIND_HEAD,
                           TAG_NODE_TYPE: "head",
                           TAG_NODE_STATUS: STATUS_UP_TO_DATE}

    def non_terminated_nodes(self, tag_filters=None):
        tag_filters = tag_filters or {}
        with self.lock:
            return [nid for nid, tags in self._tags.items()
                    if nid not in self._terminated and
                    all(tags.get(k) == v for k, v in tag_filters.items())]

    def is_running(self, node_id):
        with self.lock:
            return node_id in self._raylets and node_id not in self._terminated

    def is_terminated(self, node_id):
        return not self.is_running(node_id)

    def node_tags(self, node_id):
        with self.lock:
            return dict(self._tags.get(node_id, {}))

    def internal_ip(self, node_id):
        return node_id[:12]

    def create_node(self, node_config, tags, count):
        node_type = tags.get(TAG_NODE_TYPE)
        resources = dict(
            (node_config or {}).get("resources") or
            self.node_types.get(node_type, {}).get("resources", {"CPU": 1}))
        with self.lock:
            for _ in range(count):
                raylet = self.cluster.add_node(
                    {k: float(v) for k, v in resources.items() if v})
                nid = raylet.node_id.hex()
                self._raylets[nid] = raylet
                self._tags[nid] = dict(tags)
                self._tags[nid][TAG_NODE_STATUS] = STATUS_UP_TO_DATE

    def terminate_node(self, node_id):
        with self.lock:
            raylet = self._raylets.get(node_id)
            if raylet is None or node_id in self._terminated:
                return
            self._terminated.add(node_id)
        self.cluster.remove_node(raylet)

    def set_node_tags(self, node_id, tags):
        with self.lock:
            self._tags[node_id].update(tags)
