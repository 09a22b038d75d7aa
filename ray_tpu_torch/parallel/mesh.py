"""Device meshes over ``torch.distributed``, the counterpart of
``ray_tpu/parallel/mesh.py``.

The JAX package expresses parallelism as a ``jax.sharding.Mesh`` with
named axes and lets XLA insert the collectives.  The port builds a
``torch.distributed.device_mesh.DeviceMesh`` with the same five named
axes, in the same order, over the default process group (which the
caller initialises: NCCL on the card, gloo on the CPU), and the model
code issues the collectives itself (``parallel/collectives.py``).

Axis conventions, as in the reference:
  * ``dp`` -- data parallel (batch rows; gradients summed over it)
  * ``sp`` -- context parallel (sequence; ring attention)
  * ``pp`` -- pipeline stages (``parallel/pipeline.py``)
  * ``ep`` -- expert parallel (MoE experts sharded)
  * ``tp`` -- tensor parallel (heads, FFN hidden, vocabulary)

The mesh is ``arange(size).reshape(dp, sp, pp, ep, tp)``: rank r holds
the coordinates of JAX's device r in ``build_mesh``'s array, tp
innermost.  A sharding spec is a tuple with one entry per tensor
dimension, an axis name or ``None`` (the port's ``PartitionSpec``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ray_tpu_torch._private.device import resolve_device

AXES = ("dp", "sp", "pp", "ep", "tp")

Axes = Union[str, Sequence[str]]


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1
    ep: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.tp * self.sp * self.pp * self.ep

    def axis_sizes(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp, "sp": self.sp,
                "pp": self.pp, "ep": self.ep}


def infer_mesh_config(n_devices: int, *, tp: Optional[int] = None,
                      sp: int = 1, pp: int = 1, ep: int = 1) -> MeshConfig:
    """Pick (dp, tp) to fill ``n_devices`` given fixed sp/pp/ep.

    tp defaults to min(n_remaining, 4) rounded down to a power of two.
    """
    rem = n_devices // (sp * pp * ep)
    if rem < 1:
        raise ValueError(f"{n_devices} devices can't fit sp={sp} pp={pp} "
                         f"ep={ep}")
    if tp is None:
        tp = 1
        while tp * 2 <= min(rem, 4) and rem % (tp * 2) == 0:
            tp *= 2
    dp = rem // tp
    if dp * tp * sp * pp * ep != n_devices:
        raise ValueError(
            f"dp({dp})*tp({tp})*sp({sp})*pp({pp})*ep({ep}) != {n_devices}")
    return MeshConfig(dp=dp, tp=tp, sp=sp, pp=pp, ep=ep)


def build_mesh(config: MeshConfig, device=None):
    """A ``DeviceMesh`` with all five axes over the first ``config.size``
    ranks of the default process group (size-1 axes issue no
    collective).  ``device=None`` means the card, on a NCCL world;
    ``device="cpu"`` a gloo world.  Raises without a card (unless told
    the CPU), without an initialised process group, on a backend that
    does not serve the device, and when the world has fewer ranks than
    ``config.size``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("build_mesh needs torch.distributed's default "
                           "process group; initialise it first")
    backend = str(dist.get_backend())
    want = "nccl" if dev.type == "cuda" else "gloo"
    if want not in backend:
        raise RuntimeError(f"a {dev.type} mesh needs the {want} backend; "
                           f"the default process group runs {backend}")
    world = dist.get_world_size()
    if world < config.size:
        raise ValueError(f"Need {config.size} devices, have {world}")
    shape = (config.dp, config.sp, config.pp, config.ep, config.tp)
    return DeviceMesh(dev.type, torch.arange(config.size).view(shape),
                      mesh_dim_names=AXES)


def single_device_mesh(device=None):
    """A mesh of one: rank 0 of the default process group."""
    return build_mesh(MeshConfig(), device)


def check_mesh(mesh) -> None:
    """Raises unless ``mesh`` is a mesh of :func:`build_mesh`."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names != AXES:
        raise TypeError(f"mesh must be a DeviceMesh with axes {AXES} "
                        f"(parallel.mesh.build_mesh), not {type(mesh)}")


def _names(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes: Axes) -> int:
    """The number of ranks along ``axes`` (1 without a mesh)."""
    if mesh is None:
        return 1
    n = 1
    for name in _names(axes):
        n *= mesh.shape[AXES.index(name)]
    return n


def axis_index(mesh, axes: Axes) -> int:
    """This rank's coordinate along ``axes``, row-major over several
    (0 without a mesh)."""
    if mesh is None:
        return 0
    idx = 0
    for name in _names(axes):
        idx = idx * mesh.shape[AXES.index(name)] + mesh.get_local_rank(name)
    return idx


def axis_group(mesh, axes: Axes):
    """The process group of this rank along ``axes`` (several axes: one
    group over all of them, its ranks in row-major coordinate order), or
    ``None`` where the axes span one rank: no collective is issued
    there, as XLA issues none.  Groups over several axes are made on
    first use, by every rank of the mesh in the same order, and kept on
    the mesh."""
    import torch.distributed as dist

    names = tuple(n for n in _names(axes) if axis_size(mesh, n) > 1)
    if not names:
        return None
    if len(names) == 1:
        return mesh.get_group(names[0])
    groups = mesh.__dict__.setdefault("_ray_tpu_groups", {})
    if names not in groups:
        dims = [AXES.index(n) for n in names]
        rest = [d for d in range(len(AXES)) if d not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(
            -1, axis_size(mesh, names))
        mine = None
        for row in ranks.tolist():
            group = dist.new_group(row)
            if dist.get_rank() in row:
                mine = group
        groups[names] = mine
    return groups[names]


def shard(t: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec``: each
    dimension named by an axis is cut into that axis's size in equal
    parts and the part at this rank's coordinate kept (a copy, so the
    global tensor can be freed)."""
    for dim, name in enumerate(spec):
        if name is not None and axis_size(mesh, name) > 1:
            n = axis_size(mesh, name)
            if t.shape[dim] % n:
                raise ValueError(f"dimension {dim} of size {t.shape[dim]} "
                                 f"does not divide over {name} = {n}")
            t = t.chunk(n, dim)[axis_index(mesh, name)]
    return t.contiguous()


def shard_tree(tree, specs, mesh):
    """:func:`shard` over a tree of tensors and its tree of specs."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shard(tree, specs, mesh)
