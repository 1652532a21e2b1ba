"""Nothing a cell runs imports JAX or the JAX package, compared by whole
top-level names (``centroids_reid_tpu_torch`` is the port, not a match);
the plain reference imports nothing of the port either."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

import dry

PROBE = r"""
import json, sys
sys.path[:0] = [{root!r}, {bench!r}, {tests!r}]
import dry
from harness import common
from centroids_reid_tpu_torch.metrics import r1_map
r1_map._STREAMING_CELLS = 0   # stream at the dry size, as the cell does
line, out = dry.measure({workload!r}, {scratch!r})
print(json.dumps({{"blocked": common.blocked_modules(),
                   "port": "centroids_reid_tpu_torch" in sys.modules,
                   "correct": line["correct"]}}))
"""


@pytest.mark.parametrize("workload", ["market-r50-eval500k"])
def test_a_cell_loads_no_jax(workload, tmp_path):
    code = PROBE.format(root=dry.ROOT, bench=dry.BENCH, tests=dry.HERE,
                        workload=workload, scratch=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["blocked"] == [] and got["port"] and got["correct"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_port_or_jax():
    files = glob.glob(os.path.join(dry.BENCH, "reference", "*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "centroids_reid_tpu",
                               "centroids_reid_tpu_torch", "harness"), (f, name)
    code = (f"import sys; sys.path.insert(0, {dry.BENCH!r}); "
            "import reference.rmap; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    loaded = set(eval(proc.stdout))
    assert not loaded & {"jax", "jaxlib", "flax", "centroids_reid_tpu",
                         "centroids_reid_tpu_torch"}


def test_no_benchmark_file_imports_jax():
    for f in glob.glob(os.path.join(dry.BENCH, "**", "*.py"),
                       recursive=True):
        for name in _imports(f):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "centroids_reid_tpu"), (f, name)
