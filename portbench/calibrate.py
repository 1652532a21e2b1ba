"""Readings from which a cell's limits for ``correct`` are set: the sound
program's compared numbers over many seeds, the control's (the plain
reference in the next lower precision, put in the program's place) and
each planted fault's, at the cell's own size, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 12 \
        --controls 3 --faults 3 [--first-seed N] [--out file.json]

Prints one JSON line per seed and, at the end, for each number the
largest sound reading and the smallest control and fault readings."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import run as bench_run  # noqa: E402
from harness import common  # noqa: E402


def summary(rows: list) -> dict:
    out = {}
    for key in rows[0]["program"]:
        entry = {"program_max": max(r["program"][key] for r in rows)}
        for kind in sorted({k for r in rows for k in r if k not in
                            ("seed", "program")}):
            vals = [r[kind][key] for r in rows if kind in r]
            entry[f"{kind}_min"] = min(vals)
        out[key] = entry
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    bench = bench_run.benchmark()
    with tempfile.TemporaryDirectory(prefix="portbench-cal-") as scratch:
        cells = [bench_run.make_cell(bench, args.workload,
                                     args.first_seed + 7919 * i, 0, False,
                                     T0, scratch=scratch)
                 for i in range(args.seeds)]
        common.require_cards(cells[0].chips)
        driver = importlib.import_module(
            f"harness.{cells[0].traffic['driver']}")
        rows = driver.calibrate(cells, args.controls, args.faults)
    for r in rows:
        print(json.dumps(r))
    result = {"workload": args.workload, "gpu": common.gpu_kind(),
              "summary": summary(rows)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, **result}, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
