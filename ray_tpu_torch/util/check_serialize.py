"""Serializability inspection: find WHICH nested object breaks pickling.

A copy of ``ray_tpu.util.check_serialize`` for the PyTorch port
(reference ``python/ray/util/check_serialize.py``,
``inspect_serializability``): recursively descend into an
unserializable object's closure cells, attributes and members, pinpoint
the leaf objects that fail cloudpickle, and print a readable trace.
"""

from __future__ import annotations

import inspect
from typing import Any, NamedTuple, Optional, Set, Tuple

import cloudpickle


class FailureTuple(NamedTuple):
    """One offending object: where it lives and what holds it."""
    obj: Any
    name: str
    parent: Any

    def __repr__(self):
        return f"FailTuple({self.name} [obj={self.obj!r}, " \
               f"parent={self.parent!r}])"


def _serializable(obj: Any) -> bool:
    try:
        cloudpickle.dumps(obj)
        return True
    except Exception:
        return False


def _children(obj: Any):
    """(name, child) pairs worth descending into."""
    out = []
    if inspect.isfunction(obj):
        closure = getattr(obj, "__closure__", None) or ()
        names = obj.__code__.co_freevars
        for name, cell in zip(names, closure):
            try:
                out.append((name, cell.cell_contents))
            except ValueError:
                pass
        for name, value in (getattr(obj, "__globals__", {}) or {}).items():
            if name in obj.__code__.co_names and \
                    not inspect.ismodule(value):
                out.append((name, value))
    elif isinstance(obj, dict):
        out.extend((repr(k), v) for k, v in obj.items())
    elif isinstance(obj, (list, tuple, set)):
        out.extend((f"[{i}]", v) for i, v in enumerate(obj))
    else:
        for name, value in vars(type(obj)).items() \
                if not hasattr(obj, "__dict__") else \
                getattr(obj, "__dict__", {}).items():
            if not name.startswith("__"):
                out.append((name, value))
    return out


def inspect_serializability(
        base_obj: Any, name: Optional[str] = None, depth: int = 3,
        print_trace: bool = True,
) -> Tuple[bool, Set[FailureTuple]]:
    """Returns (serializable?, failure set of leaf offenders)."""
    name = name or getattr(base_obj, "__name__", repr(base_obj)[:40])
    failures: Set[FailureTuple] = set()
    ok = _inspect(base_obj, name, depth, None, failures)
    if print_trace and not ok:
        print(f"{'=' * 60}\n{name!r} is NOT serializable")
        for f in failures:
            print(f"  offender: {f.name} = {f.obj!r} "
                  f"(held by {f.parent!r})")
        print("=" * 60)
    return ok, failures


def _inspect(obj, name, depth, parent, failures) -> bool:
    if _serializable(obj):
        return True
    if depth <= 0:
        failures.add(FailureTuple(obj, name, parent))
        return False
    found_deeper = False
    for child_name, child in _children(obj):
        if not _serializable(child):
            found_deeper = True
            _inspect(child, f"{name}.{child_name}", depth - 1, obj,
                     failures)
    if not found_deeper:
        # This object itself is the leaf offender.
        failures.add(FailureTuple(obj, name, parent))
    return False
