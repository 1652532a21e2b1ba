"""count_searched.eval (%): 100 x ``eval.entries_searched`` /
``eval.entries_scanned``, the program's counters (``metrics/
streaming_eval.py::compute_stream_ranks``): of the (query, gallery row)
pairs the count pass scans, the share whose row lies under the query's
farthest hit and goes to the search among its sorted hits. A program
without the counters reads None. Source: program_counter."""

from harness.spans import counts

SOURCE = "program_counter"


def read(obs):
    c = counts()
    if not c.get("eval.entries_scanned"):
        return None
    return 100.0 * c.get("eval.entries_searched", 0) \
        / c["eval.entries_scanned"]
