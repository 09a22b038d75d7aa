"""128-bit opaque identifiers for cluster entities.

A copy of ``ray_tpu._private.ids`` for the PyTorch port, with a plain
``threading.Lock`` in place of the lock-order witness.

TPU-native re-design of the reference ID scheme (reference:
``src/ray/common/id.h:1`` — TaskID/ObjectID/ActorID/NodeID/JobID as fixed-width
binary IDs with nil sentinels).  We keep the same external contract — fixed
width, hex round-trip, ``is_nil``, hashable, orderable — but the representation
is a plain ``bytes`` payload; there is no embedded structure decoding on the
hot path, and object indices are carried separately in the object-ref metadata.
"""

from __future__ import annotations

import os
import random
import threading


_ID_SIZE = 16  # 128-bit, matches reference UniqueID size.

# ID generation is on the task-submission hot path (TaskID + one
# ObjectID per return), and ``os.urandom`` is a real syscall per call —
# measured at >200us on some kernels, which made it THE
# dominant cost of ``remote()``.  IDs need uniqueness, not
# cryptographic strength: draw them from a per-thread PRNG seeded once
# from urandom (+ pid + thread id, so forks and threads can't share a
# stream).
_rand_local = threading.local()


def _random_bytes(n: int) -> bytes:
    rng = getattr(_rand_local, "rng", None)
    if rng is None or _rand_local.pid != os.getpid():
        seed = int.from_bytes(os.urandom(16), "little") \
            ^ (os.getpid() << 64) ^ threading.get_ident()
        rng = _rand_local.rng = random.Random(seed)
        _rand_local.pid = os.getpid()
    return rng.getrandbits(n * 8).to_bytes(n, "little")


class BaseID:
    """Fixed-width binary id. Immutable, hashable, hex round-trippable."""

    __slots__ = ("_binary", "_hash")
    SIZE = _ID_SIZE

    def __init__(self, binary: bytes):
        if len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(binary)}"
            )
        self._binary = binary
        self._hash = hash((type(self).__name__, binary))

    @classmethod
    def from_random(cls):
        return cls(_random_bytes(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def is_nil(self) -> bool:
        return self._binary == b"\xff" * self.SIZE

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(self) is type(other) and self._binary == other._binary

    def __lt__(self, other):
        return self._binary < other._binary

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:16]})"

    def __reduce__(self):
        return (type(self), (self._binary,))


class JobID(BaseID):
    SIZE = 4

    _counter = 0
    _lock = threading.Lock()

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(cls.SIZE, "little"))

    @classmethod
    def next(cls) -> "JobID":
        with cls._lock:
            cls._counter += 1
            return cls.from_int(cls._counter)

    def int_value(self) -> int:
        return int.from_bytes(self._binary, "little")


class UniqueID(BaseID):
    pass


class NodeID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class TaskID(BaseID):
    """Task id.  Reference embeds parent/actor info in the byte layout
    (``src/ray/common/id.h``); we carry that in the TaskSpec instead and keep
    the id opaque."""

    SIZE = 16

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        return cls(job_id.binary().ljust(cls.SIZE, b"\x00"))


class ActorID(BaseID):
    SIZE = 16


class PlacementGroupID(BaseID):
    SIZE = 16


class ObjectID(BaseID):
    """Object id = owning task id (16B) + little-endian put/return index.

    Mirrors the reference's ``ObjectID::FromIndex`` scheme
    (``src/ray/common/id.h``) so that lineage — "which task created this
    object" — is recoverable from the id alone.
    """

    SIZE = 24

    @classmethod
    def from_index(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(8, "little"))

    def task_id(self) -> TaskID:
        return TaskID(self._binary[:16])

    def index(self) -> int:
        return int.from_bytes(self._binary[16:], "little")


class FunctionID(BaseID):
    pass


NIL_NODE_ID = NodeID.nil()
NIL_ACTOR_ID = ActorID.nil()
