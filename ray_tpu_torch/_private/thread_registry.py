"""Event-loop thread identity and the ``loop_only`` check.

A small copy of ``ray_tpu._private.debug.thread_registry`` for the
PyTorch port.  Methods that mutate scheduler state are loop-affine:
correct only on their daemon's event-loop thread.  :func:`loop_only`
marks such a method; with ``RAY_TPU_LOOP_AFFINITY=1`` in the environment
(the test suite sets it) every call off a loop thread of that kind
raises.  Loops register by kind: an ``EventLoop`` named ``raylet-a1b2c3``
registers its thread under kind ``raylet``.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import Dict


class LoopAffinityError(AssertionError):
    """A ``@loop_only`` method ran on a thread outside its loop kind."""


_lock = threading.Lock()
#: thread ident -> loop kind (e.g. "raylet").
_loop_threads: Dict[int, str] = {}


def _armed() -> bool:
    return os.environ.get("RAY_TPU_LOOP_AFFINITY", "") == "1"


def register_current(loop_name: str) -> None:
    """Register the calling thread as a loop thread of the kind
    ``loop_name`` names up to its first ``-``."""
    kind = loop_name.split("-", 1)[0]
    with _lock:
        _loop_threads[threading.get_ident()] = kind


def unregister_current() -> None:
    with _lock:
        _loop_threads.pop(threading.get_ident(), None)


def loop_only(kind: str):
    """Decorator: the wrapped method must run on a ``kind`` loop thread."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _armed():
                got = _loop_threads.get(threading.get_ident())
                if got != kind:
                    raise LoopAffinityError(
                        f"{fn.__qualname__} is @loop_only({kind!r}) but "
                        f"ran on thread "
                        f"{threading.current_thread().name!r} "
                        f"(registered loop kind: {got!r}); post it to "
                        f"the {kind} event loop instead of calling it "
                        f"directly")
            return fn(*args, **kwargs)

        wrapper.__loop_only__ = kind
        return wrapper

    return deco
