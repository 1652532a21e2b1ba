from .retrieval import (
    LAUNCHES,
    kpass_topk,
    kpass_topk_plain,
    reset_launch_counts,
    scores,
    scores_plain,
    stream_topk,
    stream_topk_plain,
    topk_retrieval,
    topk_select,
)

__all__ = [
    "LAUNCHES",
    "kpass_topk",
    "kpass_topk_plain",
    "reset_launch_counts",
    "scores",
    "scores_plain",
    "stream_topk",
    "stream_topk_plain",
    "topk_retrieval",
    "topk_select",
]
