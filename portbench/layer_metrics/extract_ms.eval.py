"""extract_ms.eval (ms): device time an evaluation of the kernels, copies
and sets launched inside the span ``eval.extract`` (the extract pass of
``metrics/streaming_eval.py`` over every gallery tile, its GEMMs
included), matched to the span by each event's launch. Over the
device-only window's evaluations. Source: program_span, on the device
trace's events."""

from harness.spans import launched_ms

SOURCE = "program_span"


def read(obs):
    return launched_ms(obs, "eval.extract")
