"""ray_tpu_torch.data: distributed datasets on the object store.

The port of ``ray_tpu.data`` (reference ``python/ray/data/``: Dataset,
DatasetPipeline, read_api, GroupedDataset) on the port's tasks, actors
and objects.  Blocks are the reference's numpy columns and lists;
``Dataset.to_torch(device=...)`` takes the place of ``to_jax``
(ROADMAP C.26).  See the module docstrings for the per-file map.
"""

from ray_tpu_torch.data.block import (  # noqa: F401
    Block, BlockAccessor, BlockMetadata)
from ray_tpu_torch.data.dataset import Dataset, GroupedDataset  # noqa: F401
from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline  # noqa: F401
from ray_tpu_torch.data.impl.compute import (  # noqa: F401
    ActorPoolStrategy, TaskPoolStrategy)
from ray_tpu_torch.data.read_api import (  # noqa: F401
    from_arrow, from_items, from_numpy, from_pandas, range, range_table,
    read_binary_files, read_csv, read_json, read_numpy, read_parquet,
    read_text)

__all__ = [
    "ActorPoolStrategy", "Block", "BlockAccessor", "BlockMetadata",
    "Dataset", "DatasetPipeline", "GroupedDataset", "TaskPoolStrategy",
    "from_arrow", "from_items", "from_numpy", "from_pandas", "range",
    "range_table", "read_binary_files", "read_csv", "read_json",
    "read_numpy", "read_parquet", "read_text",
]
