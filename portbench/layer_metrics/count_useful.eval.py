"""count_useful.eval (%): 100 x ``eval.pairs_useful`` / ``eval.pairs_compared``,
the program's counters (``metrics/streaming_eval.py::
compute_stream_ranks``): the count pass's (hit, gallery row) compares
that a real hit makes against a real row, over all it makes with the
query rows, H and the gallery rows padded. Source: program_counter."""

from harness.spans import counts

SOURCE = "program_counter"


def read(obs):
    c = counts()
    if not c.get("eval.pairs_compared"):
        return None
    return 100.0 * c.get("eval.pairs_useful", 0) / c["eval.pairs_compared"]
