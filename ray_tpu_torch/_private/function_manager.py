"""Function export through the cluster's function table.

A copy of ``ray_tpu._private.function_manager`` for the PyTorch port.
The table is ``LocalCluster.function_table``, standing in for the GCS
KV until the GCS is ported (ROADMAP A.4b.4).

Parity: reference ``python/ray/_private/function_manager.py`` — user
functions are cloudpickled once per definition, exported to the GCS KV keyed
by a content hash, and loaded+cached on the executor side.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Callable, Dict

from ray_tpu_torch._private.ids import FunctionID
from ray_tpu_torch._private.serialization import (dumps_function,
                                                  loads_function)

_KV_PREFIX = b"fn:"


class FunctionManager:
    def __init__(self, kv):
        self._kv = kv
        self._lock = threading.Lock()
        # id(fn) -> (FunctionID, weakref-to-fn); the weakref guards
        # against id() reuse after the original function is collected.
        self._export_cache: Dict[int, tuple] = {}
        self._load_cache: Dict[FunctionID, Callable] = {}

    def export(self, fn: Callable) -> FunctionID:
        import weakref
        key = id(fn)
        with self._lock:
            cached = self._export_cache.get(key)
            # id() values are reused after GC: a dead closure's address
            # can be handed to a brand-new function, which would then
            # silently execute the OLD function's code.  The weakref
            # identity check makes the cache hit only for the live
            # original.
            if cached is not None and cached[1]() is fn:
                return cached[0]
        blob = dumps_function(fn)
        digest = hashlib.sha256(blob).digest()[:FunctionID.SIZE]
        function_id = FunctionID(digest)
        self._kv.put(_KV_PREFIX + function_id.binary(), blob, overwrite=False)
        try:
            ref = weakref.ref(fn)
        except TypeError:
            ref = lambda _f=fn: _f     # non-weakrefable: strong pin
        with self._lock:
            self._export_cache[key] = (function_id, ref)
            # Seed the load cache with the original callable so local
            # execution avoids a deserialize round-trip.
            self._load_cache.setdefault(function_id, fn)
        return function_id

    def load(self, function_id: FunctionID) -> Callable:
        with self._lock:
            fn = self._load_cache.get(function_id)
        if fn is not None:
            return fn
        blob = self._kv.get(_KV_PREFIX + function_id.binary())
        if blob is None:
            raise KeyError(f"Function {function_id} not found in the "
                           "function table")
        fn = loads_function(blob)
        with self._lock:
            self._load_cache[function_id] = fn
        return fn
