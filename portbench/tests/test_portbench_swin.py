"""Dry runs of ``market-swin-eval`` on the CPU, shrunk here (``dry.shrink``
knows the streaming cell alone): Swin at tiny widths through the model's
constructor, a few dozen images, fp32 (the CPU's bf16 autocast is not the
card's). A sound run is correct and reports exactly its end-to-end
metrics, a traced one its readers and no streaming or ``.vit`` one; each
planted fault fails; a port without the backbone fails at once; the span
readers charge device time to the spans by launch; no file the benchmark
had changes, and ``BENCHMARK.json`` only by its appended entries."""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import pytest

import dry
from harness import evalembed_swin
from harness.trace import Trace
from test_portbench_data_driven import _digests

from centroids_reid_tpu_torch.models import swin as S
from centroids_reid_tpu_torch.utils import profiling

CELL = "market-swin-eval"
TINY = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8))
STREAMING = ("eval_count_ms", "eval_mfu", "positives_ms.eval",
             "host_idle_ms.eval", "extract_ms.eval", "count_ms.eval",
             "count_useful.eval", "count_searched.eval")
VIT = ("embed_ms.vit", "jpm_ms.vit", "device_idle.vit")
PARENT = "65456bd608eac7248f358413946ba515bb9578fe"   # before the cell


def shrink(cell) -> None:
    """64x32 images (every stage pads: 16x8 -> 21x14 ... 2x1 -> 7x7), C
    32, depths [2, 2, 2, 2], heads [1, 2, 4, 8] (at C 16 dropping the bias
    moves the features less than the cell's limits); 12 queries and 60
    gallery images over 40 ids, so that APs stay small as at the cell's
    750 ids; batch 16."""
    c = cell.config
    c["gallery"] = dict(c["gallery"], query=12, gallery=60, pids=40)
    c["published"] = dict(c["published"], input_hw=[64, 32], embed_dim=32,
                          depths=[2, 2, 2, 2], num_heads=[1, 2, 4, 8])
    opts = c["opts"]["eval"]
    for k, v in {"INPUT.SIZE_TRAIN": "[64, 32]",
                 "INPUT.SIZE_TEST": "[64, 32]", "TEST.IMS_PER_BATCH": "16",
                 "MODEL.BACKBONE_EMB_SIZE": "256",
                 "USE_MIXED_PRECISION": "False"}.items():
        opts[opts.index(k) + 1] = v
    cell.traffic.update(trace_evals=1, check_rows=20)


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setitem(S.SWIN_WIDTHS, "swin_base_patch4_window7_224", TINY)


def measure(scratch, trace=False, seed=2**31 + 11, base=dry.BENCH,
            root=dry.ROOT):
    bench = dry.bench_run.benchmark(root)
    cell = dry.bench_run.make_cell(bench, CELL, seed, 0.5, trace,
                                   time.perf_counter(), base=base,
                                   device="cpu", scratch=scratch)
    shrink(cell)
    line, out = dry.bench_run.measure(bench, cell, base=base)
    return json.loads(line), out


def test_sound_runs(tiny, tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(dry.BENCH, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(dry.ROOT, "BENCHMARK.json"), tmp_path)
    before = _digests(base)
    line, _ = measure(str(tmp_path), base=str(base), root=str(tmp_path))
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "eval_s"}
    assert set(line["checks"]) == {"emb_rel_err", "emb_cos_gap",
                                   "ap_outside"}
    line, out = measure(str(tmp_path), trace=True, base=str(base),
                        root=str(tmp_path))
    assert line["correct"] is True
    got = set(line["metrics"])
    # no device events on the CPU: the span readers read None, not 0
    assert got == {"embed_mfu", "device_idle.eval"}
    assert not got & set(STREAMING + VIT)
    for name in ("embed_ms.swin", "wmsa_ms.swin"):
        assert dry.bench_run.reader(name, str(base)).read(
            out.observed) is None
    counts = out.observed["counts"]
    assert counts["embed.images"] == 72 and counts["embed.rows"] == 80
    assert counts["vit.norms"] > 0 and "vit.norms_fused" not in counts
    assert counts["swin.window_tokens"] > counts["swin.tokens"] > 0
    assert _digests(base) == before


@pytest.mark.parametrize("kind", evalembed_swin.FAULTS)
def test_faults_fail(tiny, tmp_path, kind):
    with evalembed_swin._plant(kind):
        line, _ = measure(str(tmp_path))
    assert line["correct"] is False


def test_calibration_reads_the_controls(tiny, tmp_path):
    """One seed of ``calibrate``: the program, both controls (fp8 linears
    in the reference, the trunk wholly in bf16) and each fault, each
    reading every check; the bf16 trunk reads farther from the reference
    than the fp32 program."""
    bench = dry.bench_run.benchmark()
    cell = dry.bench_run.make_cell(bench, CELL, 2**31 + 5, 0.5, False,
                                   time.perf_counter(), device="cpu",
                                   scratch=str(tmp_path))
    shrink(cell)
    row, = evalembed_swin.calibrate([cell], 1, 1)
    keys = {"program", "control", "control_bf16"} | {
        f"fault_{k}" for k in evalembed_swin.FAULTS}
    assert set(row) == keys | {"seed"}
    for k in keys:
        assert set(cell.limits) <= set(row[k])
    assert (row["control_bf16"]["emb_rel_err"]
            > 10 * row["program"]["emb_rel_err"])


def test_a_port_without_the_backbone_fails_at_once(tmp_path, monkeypatch):
    import centroids_reid_tpu_torch.models as models

    monkeypatch.delattr(models, "swin")
    monkeypatch.setitem(sys.modules, "centroids_reid_tpu_torch.models.swin",
                        None)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="no Swin backbone"):
        measure(str(tmp_path))
    assert time.perf_counter() - t0 < 10


def test_span_readers_charge_launches_to_spans(tiny):
    """On a trace made from the recorded spans: a kernel launched inside
    each ``swin.wmsa`` span (2 ms) and one inside each ``embed`` root
    outside it (1 ms); one launched outside every root is not charged."""
    from harness.embedspans import embeds

    with tempfile.TemporaryDirectory() as d:
        _, out = measure(d, trace=True)
    obs = out.observed
    spans = {s.index: s for s in profiling.spans()}
    roots = [s for s in spans.values() if s.name == "embed"]
    events, n = [], 0

    def launch(t, dur):
        nonlocal n
        n += 1
        events.append({"cat": "cuda_runtime", "ts": t, "dur": 1, "tid": 1,
                       "args": {"correlation": n}})
        events.append({"cat": "kernel", "ts": t + 5, "dur": dur,
                       "args": {"correlation": n}})

    for r in roots:
        launch(r.start + 0.001 * (r.end - r.start), 1000.0)
    wmsa = [s for s in spans.values() if s.name == "swin.wmsa"]
    for s in wmsa:
        launch((s.start + s.end) / 2, 2000.0)
    launch(max(r.end for r in roots) + 10.0, 5000.0)
    obs = dict(obs, trace=Trace(events, 1.0))
    evs = embeds(obs)
    assert len(evs) == len(roots) == 2
    per = len(wmsa) / 2
    read = dry.bench_run.reader
    assert read("wmsa_ms.swin").read(obs) == pytest.approx(2.0 * per)
    assert read("embed_ms.swin").read(obs) == pytest.approx(1.0 + 2.0 * per)


def _at_parent(path):
    proc = subprocess.run(["git", "show", f"{PARENT}:{path}"], cwd=dry.ROOT,
                          capture_output=True, timeout=60)
    return proc.stdout if proc.returncode == 0 else None


def test_no_file_the_benchmark_had_changes():
    """Every file under ``portbench/`` at the commit before this cell is
    byte for byte the same; ``BENCHMARK.json`` differs only by the cell's
    configuration, cell and readers appended and by the cell appended to
    the lists of ``eval_s``, ``embed_mfu`` and ``device_idle.eval``."""
    proc = subprocess.run(["git", "ls-tree", "-r", "--name-only", PARENT,
                           "portbench"], cwd=dry.ROOT, capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        pytest.skip("needs the repository's history (git)")
    for path in proc.stdout.split():
        with open(os.path.join(dry.ROOT, path), "rb") as f:
            assert f.read() == _at_parent(path), path
    old = json.loads(_at_parent("BENCHMARK.json"))
    new = json.loads(open(os.path.join(dry.ROOT, "BENCHMARK.json")).read())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert new[key][:len(old[key])] == [
            _appended(e, CELL) for e in old[key]], key
    assert {k: v for k, v in new.items() if k not in (
        "configs", "workloads", "end_to_end", "per_layer")} == {
        k: v for k, v in old.items() if k not in (
            "configs", "workloads", "end_to_end", "per_layer")}
    assert [e["name"] for e in new["configs"][len(old["configs"]):]] == [
        "market-swin-solider"]
    assert [e["name"] for e in new["workloads"][len(old["workloads"]):]] \
        == [CELL]
    assert [e["name"] for e in new["per_layer"][len(old["per_layer"]):]] \
        == ["embed_ms.swin", "wmsa_ms.swin"]
    assert len(new["end_to_end"]) == len(old["end_to_end"])


def _appended(entry, cell):
    """``entry`` with ``cell`` appended to its ``workloads`` where this
    cell's metrics list it."""
    if entry["name"] in ("eval_s", "embed_mfu", "device_idle.eval"):
        return dict(entry, workloads=entry["workloads"] + [cell])
    return entry
