"""A run that finds no card fails and prints no result; so does a run in a
directory that holds only ``BENCHMARK.json`` and the benchmark's files."""

import os
import shutil
import subprocess
import sys

import dry

RUN = os.path.join(dry.BENCH, "run.py")


def _run(cwd, run_py, env=None):
    return subprocess.run(
        [sys.executable, run_py, "--workload", "market-r50-eval500k", "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=120, env=env)


def _no_result(proc):
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert not lines or not lines[-1].startswith("{")


def test_no_card_fails_without_a_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run(dry.ROOT, RUN, env)
    _no_result(proc)
    assert "no CPU fallback" in proc.stderr or "is false" in proc.stderr


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(os.path.join(dry.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(dry.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    proc = _run(tmp_path, str(tmp_path / "portbench" / "run.py"), env)
    _no_result(proc)
