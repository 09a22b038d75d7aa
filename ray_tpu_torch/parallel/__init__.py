"""Parallelism of the port: device meshes over ``torch.distributed``,
their collectives, and the pipeline schedule."""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig, build_mesh, infer_mesh_config, single_device_mesh)
