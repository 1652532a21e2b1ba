from . import int8_conv, retrieval, retrieval_int8
from .int8_conv import (
    conv3x3_requant,
    conv3x3_requant_plain,
    matmul_requant,
    matmul_requant_plain,
)
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

_MODULES = (retrieval, retrieval_int8, int8_conv)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by wrapper name."""
    return {name: n for m in _MODULES for name, n in m.LAUNCHES.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for m in _MODULES:
        m.reset_launch_counts()


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
    "reset_launch_counts",
    "scores",
    "scores_i8",
    "scores_i8_plain",
    "scores_plain",
    "stream_topk",
    "stream_topk_plain",
    "topk_retrieval",
    "topk_retrieval_int8",
    "topk_select",
    "topk_select_int8",
]
