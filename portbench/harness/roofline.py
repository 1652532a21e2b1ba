"""The yardstick's arithmetic: the published peaks of one H100 SXM and
the least time a kernel could take, for the readers of shares of a peak
or of a roofline.

Peaks are NVIDIA's data sheet for the SXM part, dense (no sparsity), at
the full 700 W: a card set to a lower power limit reads a lower share, so
every run prints the card's limit beside its shares."""

from __future__ import annotations

from typing import Tuple

PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
              "fp32": 67e12, "fp8": 1979e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


def nbytes(*tensors) -> int:
    """Bytes of ``tensors``, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_s(moved_bytes: float, ops: float, kind: str) -> Tuple[float, str]:
    """(the least seconds, "bytes" or "operations"): the larger of the
    bytes moved (each input read once, each output written once) over the
    HBM rate and the operations over the dense peak of ``kind``."""
    by_bytes = moved_bytes / HBM_BYTES_PER_S
    by_ops = ops / PEAK_FLOPS[kind]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")
