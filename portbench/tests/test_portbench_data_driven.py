"""The harness is driven by data: a configuration, a traffic mix, a cell
and a per-layer metric are added as new files and new entries of
``BENCHMARK.json`` alone, and a dry run finds and runs them, with no file
of the benchmark edited."""

import hashlib
import json
import os
import shutil
from unittest import mock

import dry


def _digests(base):
    out = {}
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py") or f.endswith(".json"):
                p = os.path.join(d, f)
                out[os.path.relpath(p, base)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_new_config_mix_cell_and_metric(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(dry.BENCH, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(dry.ROOT, "BENCHMARK.json"), tmp_path)
    before = _digests(base)

    cfg = json.load(open(base / "configs" / "market-r50.json"))
    cfg["name"] = "market-r50-four-cams"
    cfg["gallery"]["cams"] = 4
    (base / "configs" / "market-r50-four-cams.json").write_text(
        json.dumps(cfg))
    (base / "traffic" / "eval-few.json").write_text(json.dumps(
        {"driver": "evalstream", "distance_passes": 2, "trace_evals": 2,
         "band": 1e-5}))
    (base / "limits" / "market-r50-four-cams-few.json").write_text(
        json.dumps(json.load(open(base / "limits"
                                  / "market-r50-eval500k.json"))))
    (base / "layer_metrics" / "traced_evals.eval.py").write_text(
        'SOURCE = "program_counter"\n\n\n'
        'def read(obs):\n    return obs.get("evals")\n')
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    bench["configs"].append({"name": "market-r50-four-cams",
                             "source": cfg["source"],
                             "file": "portbench/configs/"
                                     "market-r50-four-cams.json",
                             "reduced": [], "why": "a test's configuration"})
    bench["workloads"].append({"name": "market-r50-four-cams-few",
                               "config": "market-r50-four-cams",
                               "traffic": "eval-few", "chips": 1,
                               "why": "a test's cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "eval_s":
            m["workloads"].append("market-r50-four-cams-few")
    bench["per_layer"].append({
        "name": "traced_evals.eval", "unit": "evaluations",
        "better": "higher", "source": "program_counter",
        "layer": "evaluator (metrics/r1_map.py)", "moves": "eval_s",
        "workloads": ["market-r50-four-cams-few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    from centroids_reid_tpu_torch.metrics import r1_map

    # stream at the dry size, as the cell does at its own
    with mock.patch.object(r1_map, "_STREAMING_CELLS", 0):
        line, out = dry.measure("market-r50-four-cams-few", str(tmp_path),
                                trace=True, base=str(base),
                                root=str(tmp_path))
        assert line["correct"] is True
        # the dry mode traces one evaluation (dry.shrink)
        assert line["metrics"]["traced_evals.eval"]["value"] == 1
        assert "eval_mfu" in line["metrics"]
        line, out = dry.measure("market-r50-four-cams-few", str(tmp_path),
                                base=str(base), root=str(tmp_path))
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "eval_s"}
    after = _digests(base)
    assert all(after[k] == v for k, v in before.items())
