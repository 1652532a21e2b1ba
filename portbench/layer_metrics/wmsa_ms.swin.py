"""wmsa_ms.swin (ms): device time an evaluation of the kernels launched
inside the spans ``swin.wmsa`` (``models/swin.py``: every block's window
attention from pad to crop: the pad, the roll and partition, the mask,
qkv, attention, proj and the gather back), matched to the span by each
event's launch. Over the device-only window's evaluations. A program
without the span reads None. Source: program_span, on the device trace's
events."""

from harness.embedspans import launched_ms

SOURCE = "program_span"


def read(obs):
    return launched_ms(obs, "swin.wmsa")
