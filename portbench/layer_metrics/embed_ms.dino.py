"""embed_ms.dino (ms): device time an evaluation of the kernels, copies
and sets launched inside the span ``embed`` (``engine/evaluate.py::
extract_embeddings``: DINOv2's trunk over every batch and its outputs'
copies to the host), matched to the span by each event's launch. Over the
device-only window's evaluations. A program without the span reads None.
Source: program_span, on the device trace's events."""

from harness.embedspans import launched_ms

SOURCE = "program_span"


def read(obs):
    return launched_ms(obs)
