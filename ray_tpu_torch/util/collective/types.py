"""Collective types (reference ``ray_tpu.util.collective.types``)."""

from __future__ import annotations

import enum


class ReduceOp(enum.Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    MEAN = 4  # extension: convenient for gradient averaging


class Backend:
    """Backend names.  ``nccl`` and ``gloo`` map onto the one
    implementation (the rendezvous through the object store), as in the
    reference, so code written for either runs unchanged."""

    XLA = "xla"
    NCCL = "nccl"
    GLOO = "gloo"

    @staticmethod
    def normalize(name: str) -> str:
        name = (name or "xla").lower()
        if name not in (Backend.XLA, Backend.NCCL, Backend.GLOO):
            raise ValueError(f"Unrecognized backend: {name!r}")
        return Backend.XLA
