"""Object serialization for the memory store and the task-arg path.

A port of ``ray_tpu._private.serialization`` for the PyTorch port
(reference ``python/ray/serialization.py:413``): cloudpickle for code
and closures, pickle-protocol-5 out-of-band buffers for numpy (no copy
into the pickle stream; deserialization builds views over the stored
buffers), and nested ``ObjectRef`` capture, so that the owner can
register the refs a value contains.  Values are serialized on ``put``,
so a later mutation of the Python object cannot leak into the store.

A tensor is the port's ``jax.Array``.  At a serialization boundary (an
inline argument, a pull to another node, a spill) a CUDA tensor becomes
its host form, ``tensor.detach().cpu()`` with its dtype kept, wherever
in the value it sits (the reference's ``_device_to_host`` gives numpy,
which has no bfloat16: ROADMAP C.20).  A CPU tensor is pickled as one
out-of-band buffer of its bytes, as numpy is, and rebuilt by one copy
into fresh memory, so a reader can never write into the store's bytes.
A tensor put or returned whole never comes here: it is a device object
(``object_store.DeviceObject``).

The flat form (``flat_nbytes``, ``write_into``, ``to_bytes``,
``from_bytes``) is what the node store's spill files hold and what a
transfer between node stores moves, chunk by chunk (``flat_chunks``,
the port's read surface over a python-held object, where the reference
reads a segment block).  ``copy_into_view`` is its one copy; the
reference stripes copies of 64 MiB and more over a thread pool that
lives as long as the process, and the port, whose threads all stop at
``shutdown``, copies on the calling thread.  A flat form the port
receives or restores is placed with its first buffer 64-byte aligned
(``aligned_flat_buffer``), so that a value read from a copy computes as
the original does.  ``serialize_into`` serves
the native shared-memory segment only and waits for it (ROADMAP
A.4b.2b).
"""

from __future__ import annotations

import io
import pickle
import sys
import time
from typing import Any, Iterator, List, Tuple

import cloudpickle

#: Buffers at or above this size are copied with ``np.copyto`` (several
#: times the rate of a memoryview slice assignment, and it releases the
#: GIL).
_NUMPY_COPY_MIN = 256 * 1024

#: The data plane's copy ledger: payload bytes copied on the host by
#: ``copy_into_view`` (``bytes_copied``, ``copies``); the bytes of the
#: private copy a tensor put or returned as a device object takes on its
#: own device (``device_bytes_copied``, ROADMAP C.19); and the bytes and
#: seconds of the device-to-host copies that make CUDA tensors' host
#: forms (``device_to_host_bytes``, ``device_to_host_s``).
copy_stats = {"bytes_copied": 0, "copies": 0, "device_bytes_copied": 0,
              "device_to_host_bytes": 0, "device_to_host_s": 0.0}


def copy_into_view(dst: memoryview, offset: int, src) -> int:
    """Copy ``src`` (a buffer-protocol object) into ``dst[offset:]``:
    the data plane's one copy.  Returns the bytes written."""
    mv = src if isinstance(src, memoryview) else memoryview(src)
    n = mv.nbytes
    copy_stats["bytes_copied"] += n
    copy_stats["copies"] += 1
    if n >= _NUMPY_COPY_MIN and mv.contiguous:
        import numpy as np
        d = np.frombuffer(dst, dtype=np.uint8, count=n, offset=offset)
        np.copyto(d, np.frombuffer(mv.cast("B"), dtype=np.uint8))
        return n
    if not (mv.ndim == 1 and mv.format == "B"):
        mv = mv.cast("B") if mv.contiguous else memoryview(bytes(mv))
    dst[offset:offset + n] = mv
    return n


#: Where a received flat form puts its first out-of-band buffer.
FLAT_ALIGN = 64


def aligned_flat_buffer(nbytes: int, head) -> memoryview:
    """A writable ``nbytes`` view for a flat form whose leading bytes
    are ``head``, placed so that its first out-of-band buffer starts on
    a ``FLAT_ALIGN``-byte boundary.  The flat layout puts buffers at
    whatever offset the header leaves, and numpy's reductions take other
    (SIMD) paths over aligned and unaligned data: an array read from an
    unaligned copy can sum to other float32 bits than the original."""
    import numpy as np
    raw = np.empty(nbytes + FLAT_ALIGN, dtype=np.uint8)
    first = SerializedObject.first_buffer_offset(head)
    shift = 0 if first < 0 else \
        (-(raw.ctypes.data + first)) % FLAT_ALIGN
    return memoryview(raw)[shift:shift + nbytes]


def from_received(blob) -> "SerializedObject":
    """The object whose flat form ``blob`` came over the wire, copied
    once into an ``aligned_flat_buffer``: its buffers are views of that
    copy, placed as a pull places them."""
    buf = aligned_flat_buffer(len(blob), blob)
    copy_into_view(buf, 0, blob)
    return SerializedObject.from_bytes(buf)


def _as_bytes_view(b) -> memoryview:
    """A flat byte view of one out-of-band buffer (a non-contiguous
    buffer is copied first)."""
    mv = b if isinstance(b, memoryview) else memoryview(b)
    if not mv.contiguous:
        return memoryview(bytes(mv))
    return mv if mv.ndim == 1 and mv.format == "B" else mv.cast("B")


class SerializedObject:
    """An immutable serialized value: inband pickle bytes + raw buffers."""

    __slots__ = ("inband", "buffers", "contained_refs", "_header")

    def __init__(self, inband: bytes, buffers: List[memoryview],
                 contained_refs: list):
        self.inband = inband
        self.buffers = buffers
        self.contained_refs = contained_refs
        self._header = None

    @property
    def total_bytes(self) -> int:
        return len(self.inband) + sum(b.nbytes for b in self.buffers)

    def _flat_header(self) -> bytes:
        if self._header is None:
            self._header = pickle.dumps(
                (len(self.inband), [b.nbytes for b in self.buffers]),
                protocol=5)
        return self._header

    @property
    def flat_nbytes(self) -> int:
        """Size of the flat form (``to_bytes``'s length)."""
        return 8 + len(self._flat_header()) + self.total_bytes

    def _pieces(self) -> List[memoryview]:
        """The flat form as consecutive byte views: the header's length
        with the header (one piece, so that a reader's first chunk holds
        the whole header), the inband pickle, then each buffer."""
        header = self._flat_header()
        return [memoryview(len(header).to_bytes(8, "little") + header),
                memoryview(self.inband)] + \
            [_as_bytes_view(b) for b in self.buffers]

    def write_into(self, dst: memoryview) -> int:
        """Write the flat form into ``dst`` (a transfer buffer, a spill
        file's region); the layout is ``to_bytes``'s.  Returns the bytes
        written."""
        off = 0
        for piece in self._pieces():
            off += copy_into_view(dst, off, piece)
        return off

    def flat_chunks(self, chunk: int) -> Iterator[Tuple[int, memoryview]]:
        """``(offset, view)`` pieces of the flat form, in order, none
        longer than ``chunk`` bytes and none copied: the chunked read of
        a python-held object by a transfer."""
        off = 0
        for piece in self._pieces():
            for start in range(0, piece.nbytes, chunk):
                view = piece[start:start + chunk]
                yield off + start, view
            off += piece.nbytes

    def to_bytes(self) -> bytes:
        """The flat form as one contiguous blob."""
        out = bytearray(self.flat_nbytes)
        self.write_into(memoryview(out))
        return bytes(out)

    @staticmethod
    def first_buffer_offset(head) -> int:
        """Offset of the first out-of-band buffer in a flat form whose
        leading bytes are ``head``, or -1 when ``head`` is too short to
        hold the header."""
        mv = memoryview(head)
        if mv.nbytes < 8:
            return -1
        hlen = int.from_bytes(mv[:8], "little")
        if mv.nbytes < 8 + hlen:
            return -1
        inband_len, _ = pickle.loads(mv[8:8 + hlen])
        return 8 + hlen + inband_len

    @classmethod
    def from_bytes(cls, blob) -> "SerializedObject":
        """The object whose flat form is ``blob`` (any buffer): its
        buffers are views of ``blob``, not copies."""
        mv = memoryview(blob)
        hlen = int.from_bytes(mv[:8], "little")
        inband_len, buf_lens = pickle.loads(mv[8:8 + hlen])
        off = 8 + hlen
        inband = bytes(mv[off:off + inband_len])
        off += inband_len
        buffers = []
        for n in buf_lens:
            buffers.append(mv[off:off + n])
            off += n
        return cls(inband, buffers, [])


def _is_object_ref(obj) -> bool:
    # Late import to avoid a cycle; ObjectRef lives in object_ref.py.
    from ray_tpu_torch._private.object_ref import ObjectRef
    return isinstance(obj, ObjectRef)


def _is_tensor(obj) -> bool:
    torch = sys.modules.get("torch")
    tensor = getattr(torch, "Tensor", None)
    return tensor is not None and isinstance(obj, tensor)


def host_form(tensor):
    """A tensor's host form: a CUDA tensor copied to the CPU with its
    dtype kept (a copy that waits for the card), a CPU tensor as it is
    (ROADMAP C.20)."""
    if not tensor.is_cuda:
        return tensor
    t0 = time.perf_counter()
    out = tensor.detach().cpu()
    copy_stats["device_to_host_s"] += time.perf_counter() - t0
    copy_stats["device_to_host_bytes"] += out.numel() * out.element_size()
    return out


def _reduce_host_tensor(t):
    """Pickle a CPU tensor as one out-of-band buffer of its bytes (no
    copy), its dtype, shape and ``requires_grad``; other layouts and
    subclasses take torch's own pickling."""
    import torch
    if type(t) is not torch.Tensor or t.layout != torch.strided or \
            t.is_quantized:
        return t.__reduce_ex__(5)
    flat = t.detach().resolve_conj().resolve_neg().contiguous().reshape(-1)
    raw = flat.view(torch.uint8).numpy()
    return (_rebuild_host_tensor, (pickle.PickleBuffer(raw), t.dtype,
                                   tuple(t.shape), t.requires_grad))


def _rebuild_host_tensor(buf, dtype, shape, requires_grad):
    """A fresh CPU tensor from ``_reduce_host_tensor``'s buffer (copied:
    the buffer may be the store's read-only bytes)."""
    import numpy as np
    import torch
    src = np.frombuffer(buf, dtype=np.uint8)
    out = torch.empty(src.size, dtype=torch.uint8)
    if src.size:
        copy_into_view(memoryview(out.numpy()), 0, src)
    t = out.view(dtype).reshape(shape)
    return t.requires_grad_() if requires_grad else t


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
        if _is_tensor(obj):
            return _reduce_host_tensor(host_form(obj))
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
