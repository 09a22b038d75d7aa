"""Object serialization for the memory store and the task-arg path.

A port of ``ray_tpu._private.serialization`` for the PyTorch port
(reference ``python/ray/serialization.py:413``): cloudpickle for code
and closures, pickle-protocol-5 out-of-band buffers for numpy (no copy
into the pickle stream; deserialization builds views over the stored
buffers), and nested ``ObjectRef`` capture, so that the owner can
register the refs a value contains.  Values are serialized on ``put``,
so a later mutation of the Python object cannot leak into the store.

The reference brings a jax device array to the host here
(``_device_to_host``).  The port's counterpart, a CUDA ``torch.Tensor``
as an object, belongs to the device-object plane (ROADMAP A.5): until
then serializing one raises ``NotImplementedError``, wherever in the
value it sits.  The flattened wire form (``to_bytes``, ``write_into``)
and ``serialize_into`` serve the node store and process workers, which
the port does not have yet.
"""

from __future__ import annotations

import io
import pickle
import sys
from typing import Any, List

import cloudpickle


class SerializedObject:
    """An immutable serialized value: inband pickle bytes + raw buffers."""

    __slots__ = ("inband", "buffers", "contained_refs")

    def __init__(self, inband: bytes, buffers: List[memoryview],
                 contained_refs: list):
        self.inband = inband
        self.buffers = buffers
        self.contained_refs = contained_refs

    @property
    def total_bytes(self) -> int:
        return len(self.inband) + sum(b.nbytes for b in self.buffers)


def _is_object_ref(obj) -> bool:
    # Late import to avoid a cycle; ObjectRef lives in object_ref.py.
    from ray_tpu_torch._private.object_ref import ObjectRef
    return isinstance(obj, ObjectRef)


def _is_cuda_tensor(obj) -> bool:
    torch = sys.modules.get("torch")
    tensor = getattr(torch, "Tensor", None)
    return tensor is not None and isinstance(obj, tensor) and obj.is_cuda


class _Pickler(cloudpickle.CloudPickler):
    """Cloudpickle with out-of-band buffer capture and ref collection."""

    def __init__(self, file, buffers_out, refs_out):
        super().__init__(
            file, protocol=5,
            buffer_callback=lambda b: buffers_out.append(b) or False)
        self._refs_out = refs_out

    def persistent_id(self, obj):
        return None

    def reducer_override(self, obj):
        if _is_object_ref(obj):
            self._refs_out.append(obj)
            return (_deserialize_ref_placeholder,
                    (obj.binary(), obj.owner_id_binary()))
        if _is_cuda_tensor(obj):
            raise NotImplementedError(
                f"a CUDA tensor ({tuple(obj.shape)}, {obj.dtype}) cannot "
                "be an object yet: device objects come with the "
                "device-object plane (ROADMAP A.5); move it to the CPU "
                "first")
        return super().reducer_override(obj)


def _deserialize_ref_placeholder(binary: bytes, owner_binary):
    from ray_tpu_torch._private.ids import ObjectID, WorkerID
    from ray_tpu_torch._private.object_ref import ObjectRef
    owner = WorkerID(owner_binary) if owner_binary else None
    return ObjectRef(ObjectID(binary), owner_id=owner,
                     skip_adding_local_ref=False)


def serialize(value: Any) -> SerializedObject:
    """Serialize ``value`` with zero-copy buffer capture: numpy arrays
    (and anything exporting pickle-5 buffers) contribute out-of-band
    ``memoryview`` buffers."""
    buffers: List[pickle.PickleBuffer] = []
    refs: list = []
    f = io.BytesIO()
    _Pickler(f, buffers, refs).dump(value)
    views = [b.raw() for b in buffers]
    return SerializedObject(f.getvalue(), views, refs)


def deserialize(s: SerializedObject) -> Any:
    return pickle.loads(s.inband, buffers=[
        bytes(b) if isinstance(b, memoryview) and not b.contiguous else b
        for b in s.buffers])


def dumps_function(fn) -> bytes:
    """Pickle user code/closures (reference: function_manager export path)."""
    return cloudpickle.dumps(fn)


def loads_function(blob: bytes):
    return cloudpickle.loads(blob)
