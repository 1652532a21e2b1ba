from . import (
    _build,
    add_norm,
    int8_conv,
    rerank,
    retrieval,
    retrieval_int8,
    stream_rank,
    window_attn,
)
from .int8_conv import (
    conv3x3_requant,
    conv3x3_requant_plain,
    matmul_requant,
    matmul_requant_plain,
)
from .rerank import rerank_distmat, rerank_topk
from .retrieval import (
    kpass_topk,
    kpass_topk_plain,
    scores,
    scores_plain,
    stream_topk,
    stream_topk_plain,
    topk_retrieval,
    topk_select,
)
from .retrieval_int8 import (
    Int8Gallery,
    quantize_gallery,
    scores_i8,
    scores_i8_plain,
    topk_retrieval_int8,
    topk_select_int8,
)
from .stream_rank import (
    stream_count,
    stream_count_plain,
    stream_extract,
    stream_extract_plain,
)
from .window_attn import window_attention, window_attention_plain


def launch_counts() -> dict:
    """Kernel launches since the last reset, by wrapper name."""
    return dict(_build.LAUNCHES)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    _build.LAUNCHES.update(dict.fromkeys(_build.LAUNCHES, 0))


__all__ = [
    "Int8Gallery",
    "conv3x3_requant",
    "conv3x3_requant_plain",
    "kpass_topk",
    "kpass_topk_plain",
    "launch_counts",
    "matmul_requant",
    "matmul_requant_plain",
    "quantize_gallery",
    "rerank_distmat",
    "rerank_topk",
    "reset_launch_counts",
    "scores",
    "scores_i8",
    "scores_i8_plain",
    "scores_plain",
    "stream_count",
    "stream_count_plain",
    "stream_extract",
    "stream_extract_plain",
    "stream_topk",
    "stream_topk_plain",
    "topk_retrieval",
    "topk_retrieval_int8",
    "topk_select",
    "topk_select_int8",
    "window_attention",
    "window_attention_plain",
]
