"""Serve deployment DAGs: author a multi-deployment inference graph,
build it into deployments + a runnable handle.

A copy of ``ray_tpu.serve.pipeline`` for the PyTorch port.  A tensor
input above ``serve_zero_copy_threshold_bytes`` rides the same object-id
hand-off as a numpy one (its ``nbytes``); a CUDA tensor is put as the
port's device object.

Parity: reference ``python/ray/serve/pipeline/`` (DAG authored with
``.bind()`` + ``InputNode``, compiled by ``pipeline.build`` into the
deployments it needs — ``api.py:8``, ``deployment_node.py``,
``deployment_method_node.py``, ``deployment_function_node.py``).

Authoring::

    @serve.deployment
    class Model:
        def __init__(self, weight): ...
        def forward(self, x): ...

    @serve.deployment
    def ensemble(a, b): ...

    with InputNode() as inp:
        m1 = Model.bind(1)
        m2 = Model.bind(2)
        dag = ensemble.bind(m1.forward.bind(inp), m2.forward.bind(inp))
    handle = pipeline.build(dag)     # deploys every node's deployment
    result = ray_tpu_torch.get(handle.remote(5))

Execution walks the DAG per request: each bound method/function call
becomes a handle call on its deployment, upstream results resolved
first (fan-out stages run concurrently — sibling calls are submitted
before any result is awaited).
"""

from __future__ import annotations

import itertools
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch


_uid_counter = itertools.count()


class DAGNode:
    """Base of the authoring nodes.  Every node gets a stable ``_uid``
    so a DAGHandle survives pickling (object ids do not)."""

    def __init__(self):
        self._uid = f"n{next(_uid_counter)}-{uuid.uuid4().hex[:8]}"

    def _resolve(self, input_value, cache: Dict[str, Any]):
        raise NotImplementedError


class InputNode(DAGNode):
    """Placeholder for the per-request input (reference InputNode).
    Usable as a context manager for authoring-scope clarity."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getitem__(self, idx):
        return _InputAttr(self, idx)

    def _resolve(self, input_value, cache):
        return input_value


class _InputAttr(DAGNode):
    def __init__(self, parent: InputNode, idx):
        super().__init__()
        self._parent = parent
        self._idx = idx

    def _resolve(self, input_value, cache):
        return input_value[self._idx]


class ClassNode(DAGNode):
    """A deployment class bound to init args (``Deployment.bind``)."""

    def __init__(self, deployment, init_args: tuple,
                 init_kwargs: dict):
        super().__init__()
        self._deployment = deployment
        self._init_args = init_args
        self._init_kwargs = init_kwargs

    def __getattr__(self, method_name: str):
        if method_name.startswith("_"):
            raise AttributeError(method_name)
        return _MethodBinder(self, method_name)

    def _resolve(self, input_value, cache):
        raise TypeError(
            "a bound class is not callable in the DAG; bind one of its "
            "methods")


class _MethodBinder:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs) -> "MethodNode":
        return MethodNode(self._class_node, self._method_name, args,
                          kwargs)


class MethodNode(DAGNode):
    def __init__(self, class_node: ClassNode, method_name: str,
                 args: tuple, kwargs: dict):
        super().__init__()
        self._class_node = class_node
        self._method = method_name
        self._args = args
        self._kwargs = kwargs

    def _resolve(self, input_value, cache):
        key = self._uid
        if key in cache:
            return cache[key]
        handle = cache["handles"][self._class_node._uid]
        # Upstream results pass as ObjectRefs: the replica call's arg
        # resolution awaits them, so every branch of the DAG is in
        # flight before anything blocks (true dataflow execution).
        args = [_submit(a, input_value, cache) for a in self._args]
        kwargs = {k: _submit(v, input_value, cache)
                  for k, v in self._kwargs.items()}
        ref = getattr(handle, self._method).remote(*args, **kwargs)
        cache[key] = ref
        return ref


class FunctionNode(DAGNode):
    """A function deployment bound to upstream nodes."""

    def __init__(self, deployment, args: tuple, kwargs: dict):
        super().__init__()
        self._deployment = deployment
        self._args = args
        self._kwargs = kwargs

    def _resolve(self, input_value, cache):
        key = self._uid
        if key in cache:
            return cache[key]
        handle = cache["handles"][self._uid]
        args = [_submit(a, input_value, cache) for a in self._args]
        kwargs = {k: _submit(v, input_value, cache)
                  for k, v in self._kwargs.items()}
        ref = handle.remote(*args, **kwargs)
        cache[key] = ref
        return ref


def _submit(node, input_value, cache):
    """Kick off a node (returns an ObjectRef for deployment calls, the
    literal value otherwise)."""
    if isinstance(node, DAGNode):
        return node._resolve(input_value, cache)
    return node


def _payload_nbytes(value) -> Optional[int]:
    """Cheap size of a bytes-like / buffer-backed payload (None when
    the size can't be known without serializing)."""
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    nbytes = getattr(value, "nbytes", None)  # numpy arrays, tensors
    if isinstance(nbytes, int):
        return nbytes
    return None


def _has_input_attr(node, seen: Optional[set] = None) -> bool:
    """Whether any node indexes the request input driver-side
    (``InputNode()[i]``) — those DAGs need the literal value."""
    if seen is None:
        seen = set()
    if not isinstance(node, DAGNode) or node._uid in seen:
        return False
    seen.add(node._uid)
    if isinstance(node, _InputAttr):
        return True
    children = []
    if isinstance(node, MethodNode):
        children = list(node._args) + list(node._kwargs.values())
    elif isinstance(node, FunctionNode):
        children = list(node._args) + list(node._kwargs.values())
    return any(_has_input_attr(c, seen) for c in children)


class DAGHandle:
    """The built pipeline: ``remote(input)`` runs one request through
    the graph and returns a ref to the root's result.

    Zero-copy ingress: a large buffer-backed input is put ONCE into
    the object store and every stage receives the ObjectRef (the
    object-id handoff) — the payload materializes in each replica
    straight off the shm data plane instead of being pickled into
    every stage's task args (k stages = 1 serialization, not k).
    DAGs that index the input driver-side (``InputNode()[i]``) keep
    the literal value."""

    def __init__(self, root: DAGNode, handles: Dict[str, Any],
                 deployments: List):
        self._root = root
        self._handles = handles      # node uid -> DeploymentHandle
        self.deployments = deployments
        self._indexed_input = _has_input_attr(root)

    def remote(self, input_value=None):
        from ray_tpu_torch._private.config import get_config
        from ray_tpu_torch._private.object_ref import ObjectRef
        value = input_value
        if not self._indexed_input and \
                not isinstance(input_value, ObjectRef):
            threshold = get_config().serve_zero_copy_threshold_bytes
            nbytes = _payload_nbytes(input_value)
            if threshold >= 0 and nbytes is not None \
                    and nbytes >= threshold:
                value = ray_tpu_torch.put(input_value)
        cache: Dict = {"handles": self._handles}
        out = self._root._resolve(value, cache)
        if isinstance(out, ObjectRef):
            return out
        return ray_tpu_torch.put(out)


def _collect(node, class_nodes: List, fn_nodes: List, seen: set):
    if not isinstance(node, DAGNode) or node._uid in seen:
        return
    seen.add(node._uid)
    if isinstance(node, MethodNode):
        _collect(node._class_node, class_nodes, fn_nodes, seen)
        for a in list(node._args) + list(node._kwargs.values()):
            _collect(a, class_nodes, fn_nodes, seen)
    elif isinstance(node, FunctionNode):
        fn_nodes.append(node)
        for a in list(node._args) + list(node._kwargs.values()):
            _collect(a, class_nodes, fn_nodes, seen)
    elif isinstance(node, ClassNode):
        class_nodes.append(node)
        for a in (list(node._init_args) +
                  list(node._init_kwargs.values())):
            _collect(a, class_nodes, fn_nodes, seen)
    elif isinstance(node, _InputAttr):
        _collect(node._parent, class_nodes, fn_nodes, seen)


def _build_inner(root: DAGNode) -> DAGHandle:
    """Deploy every deployment the DAG references and return a runnable
    handle.

    Naming never mutates the author's nodes (a node reused across two
    builds keeps both DAGHandles working) and never collides with
    pre-existing standalone deployments."""
    from ray_tpu_torch import serve
    class_nodes: List[ClassNode] = []
    fn_nodes: List[FunctionNode] = []
    _collect(root, class_nodes, fn_nodes, set())
    taken = set(serve.list_deployments())
    handles: Dict[int, Any] = {}
    deployments = []

    def fresh_name(base: str) -> str:
        name, n = base, 0
        while name in taken:
            n += 1
            name = f"{base}_{n}"
        taken.add(name)
        return name

    # Class deployments first: a FunctionNode/ClassNode may take a
    # bound class as an init/call arg (composition) — it resolves to
    # the already-deployed handle.
    def materialize_init_arg(a):
        if isinstance(a, ClassNode):
            return handles[a._uid]
        if isinstance(a, DAGNode):
            raise TypeError(
                "only bound classes (handles) and plain values may be "
                "used as deployment init args; request-time nodes "
                "cannot — they have no value at deploy time")
        return a

    def deploy_node(node):
        name = fresh_name(node._deployment.name)
        d = node._deployment.options(name=name, route_prefix=None)
        if isinstance(node, ClassNode):
            d.deploy(*[materialize_init_arg(a)
                       for a in node._init_args],
                     **{k: materialize_init_arg(v)
                        for k, v in node._init_kwargs.items()})
        else:
            d.deploy()
        deployments.append(d)
        handles[node._uid] = serve.get_deployment(name).get_handle()

    # Composition means a ClassNode's init args may reference other
    # ClassNodes: deploy in dependency order.
    pending = list(class_nodes)
    while pending:
        progressed = False
        for node in list(pending):
            deps = [a for a in (list(node._init_args) +
                                list(node._init_kwargs.values()))
                    if isinstance(a, ClassNode)]
            if all(dep._uid in handles for dep in deps):
                deploy_node(node)
                pending.remove(node)
                progressed = True
        if not progressed:
            raise ValueError("cycle in deployment init-arg bindings")
    for node in fn_nodes:
        deploy_node(node)
    return DAGHandle(root, handles, deployments)


class PipelineDriver:
    """Ingress deployment wrapping a DAGHandle: HTTP requests (and
    handle calls) run the graph (reference DAGDriver shape).  The
    DAGHandle pickles into the replica — DeploymentHandles reconstruct
    from their names, node identity is uid-stable."""

    def __init__(self, dag_handle: "DAGHandle"):
        self._dag = dag_handle

    def __call__(self, request):
        # HTTP path: the proxy passes an HTTPRequest; json body (or
        # query "input") is the DAG input.  Direct handle calls pass
        # the input value through unchanged.
        value = request
        body = getattr(request, "json", None)
        if callable(body):
            try:
                value = body()
            except Exception:
                # No/invalid JSON body: the documented fallback is the
                # "input" query param, not the raw query_params dict.
                value = getattr(request, "query_params", {}).get("input")
        return ray_tpu_torch.get(self._dag.remote(value))


def build(root: DAGNode, http_route: Optional[str] = None):
    """Deploy every deployment the DAG references and return a runnable
    handle (reference ``pipeline.build``, api.py:8); with
    ``http_route``, additionally deploy a :class:`PipelineDriver`
    ingress bound to that route and return it as
    ``handle.ingress``."""
    handle = _build_inner(root)
    handle.ingress = None
    if http_route is not None:
        from ray_tpu_torch import serve
        driver = serve.deployment(
            PipelineDriver,
            name=f"pipeline_driver{http_route.replace('/', '_')}",
            route_prefix=http_route)
        driver.deploy(handle)
        handle.ingress = driver
    return handle
