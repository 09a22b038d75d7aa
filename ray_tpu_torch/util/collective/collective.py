"""Collective group management and operations.

A port of ``ray_tpu.util.collective.collective`` (reference
``python/ray/util/collective/collective.py``: ``init_collective_group``
:115, ``allreduce`` :253, ``broadcast`` :368, ``allgather`` :418,
``reducescatter`` :467, ``send`` :526, ``recv`` :589).

Each group has a named detached rendezvous actor.  Every rank
contributes its tensor to a ``(kind, seq, op)`` slot; when the slot is
full rank 0 computes the result and every rank fetches it.  A reduction
(``_reduce_stack``) uploads the ranks' host arrays to the cluster's
device (the card unless the cluster runs on ``device="cpu"``; not the
arrays' own device, since they reach the rendezvous as host values),
stacks them and reduces with one ``sum``/``prod``/``amin``/``amax``/
``mean``, and brings the result back: host-bound by design, as the
reference's ``jnp`` reduction is.  The reference computes it in plain
``jnp`` outside any Pallas kernel, and plain PyTorch is its counterpart.

Types as the reference's: a numpy array in gives numpy out; a tensor in
gives its host form (a CPU tensor of its dtype, ROADMAP C.20) out.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.serialization import host_form
from ray_tpu_torch.util.collective.types import Backend, ReduceOp

_POLL_S = 0.002

#: Reductions run, by the device type they ran on.
reduce_stats: Dict[str, int] = {"cuda": 0, "cpu": 0}


class _Rendezvous:
    """Per-group rendezvous: slot store for collectives + P2P mailboxes."""

    def __init__(self, world_size: int):
        self._world = world_size
        # (kind, seq, op) -> {rank: payload}
        self._slots: Dict[tuple, Dict[int, object]] = {}
        # (kind, seq, op) -> computed result (or list of per-rank results)
        self._results: Dict[tuple, object] = {}
        self._fetched: Dict[tuple, int] = {}
        # (src, dst) -> FIFO of tensors
        self._mail: Dict[tuple, List[object]] = {}

    def world_size(self) -> int:
        return self._world

    def contribute(self, key: tuple, rank: int, payload) -> None:
        self._slots.setdefault(key, {})[rank] = payload

    def slot_full(self, key: tuple) -> bool:
        return len(self._slots.get(key, {})) >= self._world

    def take_slot(self, key: tuple):
        """Return {rank: payload} once full, else None."""
        slot = self._slots.get(key)
        if slot is None or len(slot) < self._world:
            return None
        return slot

    def put_result(self, key: tuple, result) -> None:
        self._results[key] = result
        self._slots.pop(key, None)

    def fetch(self, key: tuple):
        """(ready, result); the slot goes after world_size fetches."""
        if key not in self._results:
            return False, None
        res = self._results[key]
        n = self._fetched.get(key, 0) + 1
        if n >= self._world:
            self._results.pop(key, None)
            self._fetched.pop(key, None)
        else:
            self._fetched[key] = n
        return True, res

    # ---- point to point -------------------------------------------------
    def mail_put(self, src: int, dst: int, tensor) -> None:
        self._mail.setdefault((src, dst), []).append(tensor)

    def mail_get(self, src: int, dst: int):
        q = self._mail.get((src, dst))
        if not q:
            return False, None
        return True, q.pop(0)


_RendezvousActor = ray_tpu_torch.remote(_Rendezvous)


class _GroupState:
    __slots__ = ("name", "world_size", "rank", "rendezvous", "seq", "lock")

    def __init__(self, name: str, world_size: int, rank: int, rendezvous):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.rendezvous = rendezvous
        self.seq = 0
        self.lock = threading.Lock()

    def next_seq(self) -> int:
        with self.lock:
            self.seq += 1
            return self.seq


# Group table keyed per executing actor/thread: actors are threads of
# this process, so a flat per-process table would collide across ranks
# (the reference keeps one table per OS process, collective.py:70).
_groups_lock = threading.Lock()
_groups: Dict[tuple, _GroupState] = {}
# Worker-local name aliases: library code can hand user functions a
# stable default name while the real group is scoped per run.
_aliases: Dict[tuple, str] = {}


def set_group_alias(alias: str, group_name: str) -> None:
    """In this worker, collective ops called with ``alias`` resolve to
    ``group_name``."""
    with _groups_lock:
        _aliases[_ctx_key(alias)] = group_name


def _resolve_name(group_name: str) -> str:
    with _groups_lock:
        return _aliases.get(_ctx_key(group_name), group_name)


def _ctx_key(group_name: str) -> tuple:
    from ray_tpu_torch._private import worker_context
    spec = worker_context.get_context().task_spec
    actor_id = getattr(spec, "actor_id", None) if spec is not None else None
    owner = actor_id.hex() if actor_id else threading.get_ident()
    return (owner, group_name)


def _rendezvous_name(group_name: str) -> str:
    return f"collective_rendezvous:{group_name}"


def _get_or_create_rendezvous(group_name: str, world_size: int):
    name = _rendezvous_name(group_name)
    try:
        return ray_tpu_torch.get_actor(name)
    except ValueError:
        pass
    try:
        return _RendezvousActor.options(
            name=name, lifetime="detached").remote(world_size)
    except ValueError:
        # Lost the creation race; another rank made it.
        return ray_tpu_torch.get_actor(name)


def init_collective_group(world_size: int, rank: int,
                          backend: str = "xla",
                          group_name: str = "default") -> None:
    """Declare this actor (or task) a member of a collective group
    (reference collective.py:115)."""
    Backend.normalize(backend)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    key = _ctx_key(group_name)
    with _groups_lock:
        if key in _groups:
            raise RuntimeError(
                f"Group {group_name!r} already initialized in this worker")
    rdv = _get_or_create_rendezvous(group_name, world_size)
    state = _GroupState(group_name, world_size, rank, rdv)
    with _groups_lock:
        _groups[key] = state


def create_collective_group(actors, world_size: int, ranks: List[int],
                            backend: str = "xla",
                            group_name: str = "default") -> None:
    """Driver-side declaration for a list of actors (reference
    ``declare_collective_group``): each actor must expose
    ``init_collective_group(world_size, rank, backend, group_name)``."""
    if len(actors) != len(ranks):
        raise ValueError("actors and ranks must have the same length")
    refs = []
    for actor, rank in zip(actors, ranks):
        refs.append(actor.init_collective_group.remote(
            world_size, rank, backend, group_name))
    ray_tpu_torch.get(refs)


def destroy_collective_group(group_name: str = "default") -> None:
    actual = _resolve_name(group_name)
    with _groups_lock:
        state = _groups.pop(_ctx_key(actual), None)
        owner = _ctx_key("")[0]
        for k in [k for k, v in _aliases.items()
                  if v == actual and k[0] == owner]:
            _aliases.pop(k, None)
    if state is not None and state.rank == 0:
        try:
            ray_tpu_torch.kill(state.rendezvous)
        except Exception:  # noqa: BLE001 — the actor may be gone already
            pass


def is_group_initialized(group_name: str = "default") -> bool:
    name = _resolve_name(group_name)
    with _groups_lock:
        return _ctx_key(name) in _groups


def get_rank(group_name: str = "default") -> int:
    return _group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group(group_name).world_size


def _group(group_name: str) -> _GroupState:
    group_name = _resolve_name(group_name)
    with _groups_lock:
        state = _groups.get(_ctx_key(group_name))
    if state is None:
        raise RuntimeError(
            f"Collective group {group_name!r} is not initialized in this "
            "worker; call init_collective_group first.")
    return state


# ---- the reduction (one stack and one reduction on the device) ---------

def _reduce_device() -> torch.device:
    """The cluster's device: the card unless it runs on the CPU."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.device import resolve_device
    cluster = worker_mod.global_worker().cluster
    return resolve_device(cluster.device if cluster is not None else None)


def _reduce_stack(arrays: List, op: ReduceOp, device=None):
    """Reduce the ranks' arrays elementwise on ``device`` (the
    cluster's by default).  numpy in gives numpy out, tensors give a CPU
    tensor; an integer SUM or PRODUCT keeps the input's dtype (as
    ``jnp``'s does without x64), an integer MEAN is float32."""
    dev = _reduce_device() if device is None else torch.device(device)
    as_numpy = not isinstance(arrays[0], torch.Tensor)
    with warnings.catch_warnings():
        # A payload read from the store is a read-only numpy view; the
        # stack copies it, and nothing writes through the view.
        warnings.filterwarnings("ignore", message=".*not writable.*")
        stacked = torch.stack([torch.as_tensor(a).to(dev) for a in arrays])
    if op == ReduceOp.SUM:
        out = stacked.sum(dim=0, dtype=stacked.dtype)
    elif op == ReduceOp.PRODUCT:
        out = stacked.prod(dim=0, dtype=stacked.dtype)
    elif op == ReduceOp.MIN:
        out = stacked.amin(dim=0)
    elif op == ReduceOp.MAX:
        out = stacked.amax(dim=0)
    elif op == ReduceOp.MEAN:
        if not (stacked.is_floating_point() or stacked.is_complex()):
            stacked = stacked.to(torch.float32)
        out = stacked.mean(dim=0)
    else:
        raise ValueError(f"Unsupported ReduceOp {op}")
    reduce_stats[dev.type] = reduce_stats.get(dev.type, 0) + 1
    out = out.cpu()
    return out.numpy() if as_numpy else out


def _payload(tensor):
    """What a rank contributes: a tensor's host form, else numpy."""
    if isinstance(tensor, torch.Tensor):
        return host_form(tensor)
    return np.asarray(tensor)


def _run_collective(state: _GroupState, kind: str, payload, op=None):
    """Contribute, let rank 0 compute, fetch."""
    key = (kind, state.next_seq(), str(op))
    rdv = state.rendezvous
    ray_tpu_torch.get(rdv.contribute.remote(key, state.rank, payload))
    # Rank 0 computes once the slot fills; all ranks poll for the result.
    if state.rank == 0:
        while True:
            slot = ray_tpu_torch.get(rdv.take_slot.remote(key))
            if slot is not None:
                result = _combine(kind, slot, op, state.world_size)
                ray_tpu_torch.get(rdv.put_result.remote(key, result))
                break
            time.sleep(_POLL_S)
    while True:
        ready, res = ray_tpu_torch.get(rdv.fetch.remote(key))
        if ready:
            return res
        time.sleep(_POLL_S)


def _combine(kind: str, slot: Dict[int, object], op, world: int):
    ordered = [slot[r] for r in range(world)]
    if kind == "allreduce":
        return _reduce_stack(ordered, op)
    if kind == "allgather":
        return [_payload(t) for t in ordered]
    if kind == "reducescatter":
        red = _reduce_stack(ordered, op)
        if isinstance(red, torch.Tensor):
            return list(torch.tensor_split(red, world, dim=0))
        return np.array_split(red, world, axis=0)
    if kind == "broadcast":
        for t in ordered:
            if t is not None:
                return _payload(t)
        raise RuntimeError("broadcast: no source contribution")
    if kind == "barrier":
        return True
    raise ValueError(kind)


# ---- public ops ---------------------------------------------------------

def allreduce(tensor, group_name: str = "default",
              op: ReduceOp = ReduceOp.SUM):
    """All-reduce ``tensor`` across the group; returns the reduced array
    (the reference's collective.py:253 writes in place; callers
    rebind)."""
    state = _group(group_name)
    return _run_collective(state, "allreduce", _payload(tensor), op)


def allgather(tensor, group_name: str = "default") -> List:
    """Gather one tensor per rank, ordered by rank (reference :418)."""
    state = _group(group_name)
    return _run_collective(state, "allgather", _payload(tensor))


def reducescatter(tensor, group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM):
    """Reduce across ranks, then return this rank's shard along axis 0
    (reference :467)."""
    state = _group(group_name)
    shards = _run_collective(state, "reducescatter", _payload(tensor), op)
    return shards[state.rank]


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    """Broadcast from ``src_rank`` to all ranks (reference :368)."""
    state = _group(group_name)
    payload = _payload(tensor) if state.rank == src_rank else None
    return _run_collective(state, "broadcast", payload)


def barrier(group_name: str = "default") -> None:
    """Block until every rank has entered the barrier."""
    state = _group(group_name)
    _run_collective(state, "barrier", True)


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """P2P send (reference :526) through the group mailbox."""
    state = _group(group_name)
    if dst_rank == state.rank:
        raise ValueError("cannot send to self")
    ray_tpu_torch.get(state.rendezvous.mail_put.remote(
        state.rank, dst_rank, _payload(tensor)))


def recv(src_rank: int, group_name: str = "default",
         timeout: Optional[float] = None):
    """P2P receive (reference :589); FIFO per (src, dst) channel."""
    state = _group(group_name)
    if src_rank == state.rank:
        raise ValueError("cannot recv from self")
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        ok, t = ray_tpu_torch.get(state.rendezvous.mail_get.remote(
            src_rank, state.rank))
        if ok:
            return t
        if deadline is not None and time.monotonic() >= deadline:
            raise TimeoutError(f"recv from rank {src_rank} timed out")
        time.sleep(_POLL_S)
