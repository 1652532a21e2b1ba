"""The port's real entry point over processes: ``torchrun --standalone
--nproc_per_node 2 -m centroids_reid_tpu_torch.engine.runner --device cpu``
(gloo) with ``TPU.NUM_GROUPS 0`` trains as the runner does in one process
at ``TPU.NUM_GROUPS 2`` (resnet18 at 32x16, 2 epochs, one CPU thread a
process): one ``version_N`` directory with rank 0's ``config.yml``, one
best checkpoint, one ring entry, one metrics stream, the final state and
every epoch's losses equal bit for bit. A set ``WORLD_SIZE`` whose process
group cannot be initialised raises; nothing falls back to one process."""

import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from conftest import cpu_subprocess_env
from centroids_reid_tpu_torch.engine import runner
from test_torch_dist_fit import assert_same_run, fit_opts
from test_torch_train_fit import data_root  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = ["-m", "centroids_reid_tpu_torch.engine.runner", "--device", "cpu"]


def test_torchrun_trains_as_one_process(data_root, tmp_path):  # noqa: F811
    env = cpu_subprocess_env(OMP_NUM_THREADS="1")
    out = {n: str(tmp_path / n) for n in ("dist", "one")}
    cmds = {
        "dist": [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc_per_node", "2", *RUNNER,
                 *fit_opts(data_root, 0, "OUTPUT_DIR", out["dist"])],
        "one": [sys.executable, *RUNNER,
                *fit_opts(data_root, 2, "OUTPUT_DIR", out["one"])]}
    procs = {n: subprocess.Popen(c, env=env, cwd=_REPO, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for n, c in cmds.items()}
    logs = {}
    try:
        for n, p in procs.items():
            logs[n] = p.communicate(timeout=240)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for n, p in procs.items():
        assert p.returncode == 0, logs[n][-4000:]
    assert logs["dist"].count("torch.distributed initialised: 2 processes "
                              "(gloo)") == 1, logs["dist"][-4000:]
    runs = os.path.join(out["dist"], "train_ctl_model")
    assert os.listdir(runs) == ["version_0"]
    version = os.path.join(runs, "version_0")
    assert os.path.isfile(os.path.join(version, "config.yml"))
    assert_same_run(version, os.path.join(out["one"], "train_ctl_model",
                                          "version_0"))


def test_a_failed_initialisation_raises(monkeypatch):
    """``WORLD_SIZE`` set without the rest of ``torchrun``'s environment:
    the process group cannot form, and the runner raises rather than run
    alone."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises((ValueError, RuntimeError), match="MASTER_ADDR"):
        runner.maybe_initialize_distributed("cpu")
    assert not dist.is_initialized()
    monkeypatch.delenv("WORLD_SIZE")
    assert runner.maybe_initialize_distributed("cpu") is False
