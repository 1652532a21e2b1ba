"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its
configuration is ``portbench/configs/<config>.json``, its traffic mix
``portbench/traffic/<traffic>.json`` (whose ``driver`` names the module of
``portbench/harness/`` that runs it), its limits for ``correct``
``portbench/limits/<workload>.json``, and each per-layer metric a reader
``portbench/layer_metrics/<metric>.py``. Adding a cell, a mix, a
configuration or a metric adds files and entries and edits none.

With ``--trace 0`` the run measures the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics over a traced window. Either way it
checks what the timed path produced against the plain reference under
``portbench/reference/`` and prints, as its last line, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` when traced), with each compared number beside its limit
under ``checks``, last. The same numbers close standard error.

The run needs as many CUDA cards as the cell asks for; it never falls
back to the CPU."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, List  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _paths() -> None:
    for p in (ROOT, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)


_paths()

from harness import common  # noqa: E402


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: with ``trace`` the
    per-layer ones that list it (or, without a ``workloads`` key, that
    move an end-to-end metric it reports), else its end-to-end ones."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


def reader(name: str, base: str = HERE):
    """``layer_metrics/<name>.py``'s ``read(observed) -> float | None``."""
    path = os.path.join(base, "layer_metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "layer_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_cell(bench: dict, workload: str, seed: int, seconds: float,
              trace: bool, t0: float, base: str = HERE,
              device: str = "cuda", scratch: str = "") -> common.Cell:
    w = find(bench["workloads"], workload, "workload")
    config = load_json(os.path.join(base, "configs", f"{w['config']}.json"))
    traffic = load_json(os.path.join(base, "traffic",
                                     f"{w['traffic']}.json"))
    limits = load_json(os.path.join(base, "limits", f"{workload}.json"))
    return common.Cell(workload, config, traffic, limits, int(w["chips"]),
                       int(seed), float(seconds), bool(trace), t0, device,
                       scratch)


def measure(bench: dict, cell: common.Cell, base: str = HERE) -> tuple:
    """Run ``cell`` with its traffic's driver and read its metrics: (the
    result line, the driver's ``Outcome``)."""
    driver = importlib.import_module(f"harness.{cell.traffic['driver']}")
    out = driver.run(cell)
    metrics: Dict[str, tuple] = {}
    for m in cell_metrics(bench, cell.name, cell.trace):
        if cell.trace:
            value = reader(m["name"], base).read(out.observed)
        else:
            value = out.end_to_end.get(m["name"])
        if value is not None:
            metrics[m["name"]] = (float(value), m["unit"])
    count = cell.chips if cell.device == "cuda" else 0
    return common.result_line(cell, out, metrics, count), out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for k, v in common.cache_dirs(ROOT).items():
        os.environ[k] = v
        os.makedirs(v, exist_ok=True)
    bench = benchmark()
    with tempfile.TemporaryDirectory(prefix="portbench-") as scratch:
        cell = make_cell(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace), T0, scratch=scratch)
        try:
            common.require_cards(cell.chips)
        except common.NoCard as e:
            print(f"portbench: {e}", file=sys.stderr)
            return 3
        line, out = measure(bench, cell)
    found = common.blocked_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; the port and "
              f"the harness must import neither JAX nor the JAX package",
              file=sys.stderr)
        return 4
    for text in common.check_lines(out.checks):
        print(text, file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
