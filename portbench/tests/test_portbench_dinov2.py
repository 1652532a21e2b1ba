"""Dry runs of ``market-dinov2g-eval`` on the CPU, shrunk here
(``dry.shrink`` knows the streaming cell alone): DINOv2 at a small width
through the model's constructor, a few dozen images, fp32 (the CPU's bf16
autocast is not the card's). A sound run is correct and reports exactly
its end-to-end metrics, a traced one its readers that read on the CPU;
each planted fault fails; a port without the backbone fails at once; the
FLOP count is the published 385.39 GFLOP; the three readers read None
without their span or counter and charge device time as they say on a
synthetic trace; no file the benchmark had changes, and
``BENCHMARK.json`` only by its appended entries."""

import json
import os
import subprocess
import sys
import tempfile
import time

import pytest

import dry
from harness import dinov2_flops, evalembed_dinov2
from harness.roofline import HBM_BYTES_PER_S
from harness.trace import Trace

from centroids_reid_tpu_torch.models import dinov2 as D
from centroids_reid_tpu_torch.utils import profiling

CELL = "market-dinov2g-eval"
# ViT-B's widths at depth 6 (at D 512 or less, or fewer blocks, the
# registers and the grid's antialias move the features less than the
# cell's limits); the published 37x37 grid, resized to 4x2
SMALL = dict(embed_dim=768, depth=6, num_heads=12, mlp_ratio=4.0,
             patch_size=14, grid=37, num_register_tokens=4)
READERS = ("embed_ms.dino", "mlp_ms.dino", "norm_bw.dino")
PARENT = "7959a76c6e7ebb9f261fa868636489575e1c8bff"   # before the cell


def shrink(cell) -> None:
    """56x28 images (4x2 patches, 13 tokens), D 768, depth 6, 12 heads;
    12 queries and 60 gallery images over 40 ids, so that APs stay small
    as at the cell's 750 ids; batch 16."""
    c = cell.config
    c["gallery"] = dict(c["gallery"], query=12, gallery=60, pids=40)
    c["input_hw"] = [56, 28]
    c["published"] = dict(c["published"], embed_dim=768, depth=6,
                          num_heads=12, ffn_hidden=2048)
    opts = c["opts"]["eval"]
    for k, v in {"INPUT.SIZE_TRAIN": "[56, 28]",
                 "INPUT.SIZE_TEST": "[56, 28]", "TEST.IMS_PER_BATCH": "16",
                 "MODEL.BACKBONE_EMB_SIZE": "768",
                 "USE_MIXED_PRECISION": "False"}.items():
        opts[opts.index(k) + 1] = v
    cell.traffic.update(trace_evals=1, check_rows=20)


@pytest.fixture()
def small(monkeypatch):
    monkeypatch.setitem(D.DINOV2_WIDTHS, "dinov2_vitg14_reg", SMALL)


def measure(scratch, trace=False, seed=2**31 + 11, base=dry.BENCH,
            root=dry.ROOT):
    bench = dry.bench_run.benchmark(root)
    cell = dry.bench_run.make_cell(bench, CELL, seed, 0.5, trace,
                                   time.perf_counter(), base=base,
                                   device="cpu", scratch=scratch)
    shrink(cell)
    line, out = dry.bench_run.measure(bench, cell, base=base)
    return json.loads(line), out


def test_sound_runs(small, tmp_path):
    line, _ = measure(str(tmp_path))
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "eval_s"}
    assert set(line["checks"]) == {"emb_rel_err", "emb_cos_gap",
                                   "ap_outside"}
    line, out = measure(str(tmp_path), trace=True)
    assert line["correct"] is True
    # no device events on the CPU: the span readers and K8's read None
    assert set(line["metrics"]) == {"embed_mfu", "device_idle.eval"}
    for name in READERS:
        assert dry.bench_run.reader(name).read(out.observed) is None
    counts = out.observed["counts"]
    assert counts["embed.images"] == 72 and counts["embed.rows"] == 80
    assert counts["dino.tokens"] == 80 * 13
    assert counts["vit.norms"] == 80 * 13 * 13
    assert "vit.norms_fused" not in counts


@pytest.mark.parametrize("kind", evalembed_dinov2.FAULTS)
def test_faults_fail(small, tmp_path, kind):
    with evalembed_dinov2._plant(kind):
        line, _ = measure(str(tmp_path))
    assert line["correct"] is False


def test_calibration_reads_the_controls(small, tmp_path):
    """One seed of ``calibrate``: the program, both controls (fp8 linears
    in the reference, the trunk wholly in bf16) and each fault, each
    reading every check; the bf16 trunk and every fault read farther from
    the reference than the fp32 program."""
    bench = dry.bench_run.benchmark()
    cell = dry.bench_run.make_cell(bench, CELL, 2**31 + 5, 0.5, False,
                                   time.perf_counter(), device="cpu",
                                   scratch=str(tmp_path))
    shrink(cell)
    row, = evalembed_dinov2.calibrate([cell], 1, 1)
    keys = {"program", "control", "control_bf16"} | {
        f"fault_{k}" for k in evalembed_dinov2.FAULTS}
    assert set(row) == keys | {"seed"}
    for k in keys:
        assert set(cell.limits) <= set(row[k])
    for k in keys - {"program", "control"}:
        assert row[k]["emb_rel_err"] > 10 * row["program"]["emb_rel_err"], k


def test_a_port_without_the_backbone_fails_at_once(tmp_path, monkeypatch):
    import centroids_reid_tpu_torch.models as models

    monkeypatch.delattr(models, "dinov2", raising=False)
    monkeypatch.setitem(sys.modules,
                        "centroids_reid_tpu_torch.models.dinov2", None)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match="no DINOv2 backbone"):
        measure(str(tmp_path))
    assert time.perf_counter() - t0 < 10


def test_flops_and_bytes_at_the_published_widths():
    """385.39 GFLOP an image at 252x126 (167 tokens): per block qkv 2.364,
    proj 0.788, w12 4.203, w3 2.101, attention 0.171 GFLOP; the patch
    conv 0.293. K8 moves 6 + 79 x 12 + 14 B an element of a token over
    its 81 sites."""
    with open(os.path.join(dry.BENCH, "configs",
                           "market-dinov2-vitg14-reg.json")) as f:
        config = json.load(f)
    w, hw = config["published"], config["input_hw"]
    assert dinov2_flops.tokens(w, hw) == 167
    assert w["ffn_hidden"] == D.swiglu_hidden(w["embed_dim"],
                                              w["mlp_ratio"]) == 4096
    assert dinov2_flops.flops_per_image(w, hw) / 1e9 == pytest.approx(
        385.39, abs=0.005)
    rows = 81 * 3_249_152
    assert dinov2_flops.norm_bytes(w, rows) == 3_249_152 * 1536 * (
        6 + 79 * 12 + 14)


def _obs(counts, events):
    return {"counts": counts, "trace": Trace(events, 1.0),
            "widths": {"embed_dim": 1536, "depth": 40},
            "window_s": 1.0}


def test_readers_on_a_synthetic_trace(small):
    """``norm_bw.dino`` reads None without ``vit.norms_fused`` or without
    K8's events, 100 % on a trace whose K8 time is the bytes' bound, and
    less on a slower one; the span readers read None without the program's
    spans, and charge each event to ``embed`` or ``dino.mlp`` by its
    launch."""
    read = dry.bench_run.reader
    rows = 81 * 256 * 167
    bound_us = dinov2_flops.norm_bytes({"embed_dim": 1536, "depth": 40},
                                       rows) / HBM_BYTES_PER_S * 1e6
    k8 = [{"cat": "kernel", "ts": 0, "dur": bound_us,
           "name": "void (anonymous namespace)::add_norm_kernel<1536, "
                   "false, 2, true, true>(Params)", "args": {}}]
    norm = read("norm_bw.dino")
    assert norm.read(_obs({}, k8)) is None
    assert norm.read(_obs({"vit.norms_fused": rows}, [])) is None
    assert norm.read(_obs({"vit.norms_fused": rows}, k8)) == \
        pytest.approx(100.0)
    slow = [dict(k8[0], dur=1.25 * bound_us)]
    assert norm.read(_obs({"vit.norms_fused": rows}, slow)) == \
        pytest.approx(80.0)

    profiling.reset()
    assert read("mlp_ms.dino").read(_obs({}, k8)) is None
    assert read("embed_ms.dino").read(_obs({}, k8)) is None
    with tempfile.TemporaryDirectory() as d:
        _, out = measure(d, trace=True)
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
    mlp = [s for s in spans.values() if s.name == "dino.mlp"]
    for s in mlp:
        launch((s.start + s.end) / 2, 2000.0)
    launch(max(r.end for r in roots) + 10.0, 5000.0)
    obs = dict(out.observed, trace=Trace(events, 1.0))
    per = len(mlp) / len(roots)
    assert len(roots) == 2 and per == 5 * 6   # 5 batches, 6 blocks
    assert read("mlp_ms.dino").read(obs) == pytest.approx(2.0 * per)
    assert read("embed_ms.dino").read(obs) == pytest.approx(1.0 + 2.0 * per)


def _at_parent(path):
    proc = subprocess.run(["git", "show", f"{PARENT}:{path}"], cwd=dry.ROOT,
                          capture_output=True, timeout=60)
    return proc.stdout if proc.returncode == 0 else None


def test_no_file_the_benchmark_had_changes():
    """Every file under ``portbench/`` at the commit before this cell is
    byte for byte the same; ``BENCHMARK.json`` differs only by the cell's
    configuration, cell and readers appended and by the cell appended to
    the lists of ``eval_s``, ``embed_mfu`` and ``device_idle.eval``, with
    whatever later cells append after them left out of the comparison."""
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
        assert [_prefix(e, o) for e, o in zip(new[key], old[key])] == [
            _appended(e) for e in old[key]], key
    rest = ("configs", "workloads", "end_to_end", "per_layer")
    assert {k: v for k, v in new.items() if k not in rest} == {
        k: v for k, v in old.items() if k not in rest}
    assert [e["name"] for e in new["configs"][len(old["configs"]):]][
        :1] == ["market-dinov2-vitg14-reg"]
    assert [e["name"] for e in new["workloads"][len(old["workloads"]):]][
        :1] == [CELL]
    added = new["per_layer"][len(old["per_layer"]):][:len(READERS)]
    assert [e["name"] for e in added] == list(READERS)
    assert all(e["workloads"][:1] == [CELL] and e["moves"] == "eval_s"
               for e in added)
    assert len(new["end_to_end"]) == len(old["end_to_end"])


def _prefix(entry, old):
    """``entry`` with its ``workloads`` cut to one past ``old``'s: what
    this cell left, without the cells that later ones append."""
    if "workloads" in old:
        return dict(entry, workloads=entry["workloads"][
            :len(old["workloads"]) + 1])
    return entry


def _appended(entry):
    """``entry`` with this cell appended to its ``workloads`` where this
    cell's metrics list it."""
    if entry["name"] in ("eval_s", "embed_mfu", "device_idle.eval"):
        return dict(entry, workloads=entry["workloads"] + [CELL])
    return entry
