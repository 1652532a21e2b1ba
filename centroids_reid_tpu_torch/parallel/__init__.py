"""Devices and processes (counterpart of ``centroids_reid_tpu/parallel/``):
the gallery mesh, gallery rows sharded over the devices of one process,
and the process group of data-parallel training and evaluation over
``torch.distributed``."""

from .mesh import (
    GALLERY_AXIS,
    Mesh,
    all_reduce_,
    any_process,
    barrier,
    distributed,
    local_devices,
    local_groups,
    make_retrieval_mesh,
    on_device,
    process_allgather,
    process_count,
    process_device,
    process_index,
    replicate,
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
    "all_reduce_",
    "any_process",
    "barrier",
    "distributed",
    "local_devices",
    "local_groups",
    "make_retrieval_mesh",
    "make_sharded_row_gather",
    "on_device",
    "process_allgather",
    "process_count",
    "process_device",
    "process_index",
    "replicate",
    "shard_select_merge",
    "shard_width",
    "sharded_topk",
    "sharded_topk_tensors",
    "split_rows",
]
