"""mlp_ms.dino (ms): device time an evaluation of the kernels launched
inside the spans ``dino.mlp`` (``models/dinov2.py``: every block's SwiGLU
FFN, ``w12``, the gate ``silu(x1) * x2`` and ``w3``; the LayerNorm sites
around it are outside), matched to the span by each event's launch. Over
the device-only window's evaluations. A program without the span reads
None. Source: program_span, on the device trace's events."""

from harness.embedspans import launched_ms

SOURCE = "program_span"


def read(obs):
    return launched_ms(obs, "dino.mlp")
