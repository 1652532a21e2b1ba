"""The gallery mesh: gallery rows sharded over the devices of one process
(counterpart of ``centroids_reid_tpu/parallel/``'s retrieval half)."""

from .mesh import (
    GALLERY_AXIS,
    Mesh,
    local_devices,
    make_retrieval_mesh,
    on_device,
    shard_width,
    split_rows,
)
from .retrieval import (
    make_sharded_row_gather,
    shard_select_merge,
    sharded_topk,
    sharded_topk_tensors,
)

__all__ = [
    "GALLERY_AXIS",
    "Mesh",
    "local_devices",
    "make_retrieval_mesh",
    "make_sharded_row_gather",
    "on_device",
    "shard_select_merge",
    "shard_width",
    "sharded_topk",
    "sharded_topk_tensors",
    "split_rows",
]
