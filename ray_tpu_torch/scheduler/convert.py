"""Carry a JAX solver's world state into this package.

The world state plays the part of weights here: a solver that was
prepared in the JAX package (``BatchSolver._device_state`` or
``DeviceRuntimeSolver._state``) is turned into this package's state, so
both can be driven from the same starting point.  Arrays arrive as
numpy (``np.asarray`` of each JAX array); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device


def _t(x, device, dtype=None) -> torch.Tensor:
    arr = np.array(x, dtype=dtype, order="C")
    return torch.from_numpy(arr).to(device)


def batch_state_from_numpy(state: Dict, device=None) -> Dict:
    """JAX ``BatchSolver._device_state`` -> this package's.

    The JAX state keeps ``avail``/``total`` as padded [N, R]; the port
    keeps them in the kernel's [R, N] layout as ``avail_t``/``total_t``.
    """
    dev = resolve_device(device)
    return {
        "cost": _t(state["cost"], dev, np.float32),
        "avail_t": _t(np.asarray(state["avail"], np.float32).T, dev),
        "total_t": _t(np.asarray(state["total"], np.float32).T, dev),
        "demand": _t(state["demand"], dev, np.float32),
        "accel_node": _t(state["accel_node"], dev, bool),
        "accel_class": _t(state["accel_class"], dev, bool),
        "thr": torch.tensor(np.float32(state["thr"]), dtype=torch.float32,
                            device=dev),
        "shape": tuple(state["shape"]), "pads": tuple(state["pads"]),
    }


def runtime_state_from_numpy(state: Dict, demand: np.ndarray,
                             accel: np.ndarray, device=None) -> Dict:
    """JAX ``DeviceRuntimeSolver._state`` plus its demand rows
    (``_demand_host``, ``_accel_host``) -> this package's.

    Returns ``{"state", "demand", "accel", "zero_cost"}``: the port's
    ``_state`` dict and the device tensors its solver keeps beside it.
    The JAX state must be single-device (``n_shards == 1``)."""
    if state.get("n_shards", 1) != 1:
        raise ValueError("the port has one card: a sharded JAX state "
                         "cannot be carried over")
    dev = resolve_device(device)
    host = {k: state[k] for k in ("version", "node_ids", "columns",
                                  "node_index", "n_pad", "r_pad",
                                  "het_active")}
    host["node_ids"] = list(host["node_ids"])
    host["columns"] = dict(host["columns"])
    host["node_index"] = dict(host["node_index"])
    out_state = {
        **host,
        "het_cpu": np.asarray(state["het_cpu"], np.float32),
        "het_accel": np.asarray(state["het_accel"], np.float32),
        "avail_t": _t(state["avail_t"], dev, np.float32),
        "total_t": _t(state["total_t"], dev, np.float32),
        "accel_node": _t(state["accel_node"], dev, bool),
    }
    demand = np.asarray(demand, np.float32)
    return {
        "state": out_state,
        "demand": _t(demand, dev),
        "accel": _t(accel, dev, bool),
        "zero_cost": torch.zeros((demand.shape[0], host["n_pad"]),
                                 dtype=torch.float32, device=dev),
    }
