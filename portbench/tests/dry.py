"""Cells shrunk to run on the CPU in a few seconds: the harness's dry mode
for tests. The run's own look for a card is skipped (``device="cpu"``);
everything else (set-up, window, the readers, the check) runs as on the
card, at small sizes."""

from __future__ import annotations

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

import run as bench_run  # noqa: E402


def shrink(cell) -> None:
    """The cell's sizes cut for the CPU, in place."""
    c, t = cell.config, cell.traffic
    if t["driver"] == "evalstream":
        c["gallery"] = dict(c["gallery"], query=40, gallery=200,
                            distractors=4000, pids=20)
        t.update(trace_evals=1)


def cell(workload: str, seed: int = 2**31 + 11, trace: bool = False,
         seconds: float = 1.0, scratch: str = "", base: str = BENCH,
         root: str = ROOT):
    bench = bench_run.benchmark(root)
    c = bench_run.make_cell(bench, workload, seed, seconds, trace,
                            time.perf_counter(), base=base, device="cpu",
                            scratch=scratch)
    shrink(c)
    return bench, c


def measure(workload: str, scratch: str, **kw):
    """(result line as a dict, Outcome) of a dry run."""
    import json

    base = kw.pop("base", BENCH)
    root = kw.pop("root", ROOT)
    bench, c = cell(workload, scratch=scratch, base=base, root=root, **kw)
    line, out = bench_run.measure(bench, c, base=base)
    return json.loads(line), out
