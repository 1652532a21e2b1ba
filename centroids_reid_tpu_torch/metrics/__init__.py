from .centroids import (
    CentroidEvalSet,
    build_camera_aware_centroids,
    build_centroid_eval_set,
    build_plain_centroids,
)
from .eval_reid import K_LIST, ReidMetrics, camid_sets_to_bitmask, eval_func
from .r1_map import R1mAP, compute_distmat, l2_normalize_rows
from .streaming_eval import (
    StreamRanks,
    compute_stream_ranks,
    eval_func_streaming,
    eval_func_streaming_reranked,
)

__all__ = [
    "CentroidEvalSet",
    "build_camera_aware_centroids",
    "build_centroid_eval_set",
    "build_plain_centroids",
    "K_LIST",
    "ReidMetrics",
    "camid_sets_to_bitmask",
    "eval_func",
    "R1mAP",
    "compute_distmat",
    "l2_normalize_rows",
    "StreamRanks",
    "compute_stream_ranks",
    "eval_func_streaming",
    "eval_func_streaming_reranked",
]
