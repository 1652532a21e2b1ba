"""positives_ms.eval (ms): host wall of the span ``eval.positives`` an
evaluation, the positives table (``metrics/streaming_eval.py::
_positives_table``: each query's hits in Python over the gallery rows),
over the device-only window's evaluations. Source: program_span."""

from harness.spans import span_ms

SOURCE = "program_span"


def read(obs):
    return span_ms(obs, "eval.positives")
