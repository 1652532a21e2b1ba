"""Processes of the port over ``torch.distributed`` (gloo, CPU) for the
tests: ``launch`` (``start`` + ``wait``) starts one worker process per
rank and returns what each wrote; a worker joins the group through a file
store (no port to pick, so concurrent tests cannot collide), runs one task
with one CPU thread and writes its results to an ``.npz``. A worker
imports only the port (with ``block_jax`` importing jax, flax, optax,
orbax, tensorstore or the JAX package raises). ``world`` 1 with ``group`` False runs the task in one
process without a process group: the one-process reference.

    python tests/fixtures/torch_dist_worker.py '<json spec>'

Tasks: ``step`` (one train step of this rank's groups from a saved state
and batch), ``fit`` (``engine.fit.fit``, optionally with a SIGTERM to
rank 0 at the start of an epoch), ``extract`` (the sharded extraction
against the full one), ``only_test`` (``runner.run_single`` with
``TEST.ONLY_TEST``), ``checkpoint`` (a ``CheckpointManager(use_async=True)``
saving two bests and two ring entries).
"""

import json
import os
import subprocess
import sys
import uuid

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
           "centroids_reid_tpu")


def start(tmp_path, spec: dict, world: int, env: dict, group: bool = True):
    """Start ``spec`` on ``world`` worker processes (ranks 0..world-1);
    ``wait`` for them."""
    tag = uuid.uuid4().hex[:8]
    env = dict(env, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p]))
    procs, outs = [], []
    for rank in range(world):
        out = os.path.join(str(tmp_path), f"worker_{tag}_{rank}.npz")
        full = dict(spec, rank=rank, world=world, group=group, out=out,
                    store=os.path.join(str(tmp_path), f"store_{tag}"))
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, json.dumps(full)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs, outs


def wait(started, timeout: float = 240) -> list:
    """Each rank's results (a dict of arrays, its output under ``log``).
    Fails, with the workers' output, if one exits non-zero or outlives
    ``timeout`` s."""
    import numpy as np

    procs, outs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
    results = []
    for out, log in zip(outs, logs):
        with np.load(out) as z:
            results.append(dict(z, log=log))
    return results


def launch(tmp_path, spec: dict, world: int, env: dict, group: bool = True,
           timeout: float = 240) -> list:
    """``start`` then ``wait``."""
    return wait(start(tmp_path, spec, world, env, group), timeout)


# --------------------------------------------------------------------------
# worker side


def _cfg(opts):
    from centroids_reid_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_list(list(opts))
    return cfg


def task_step(spec) -> dict:
    """One train step of this rank's groups of the saved batch, from the
    saved model state and centers."""
    import torch

    from centroids_reid_tpu_torch.engine.state import TrainState
    from centroids_reid_tpu_torch.engine.steps import make_train_step
    from centroids_reid_tpu_torch.models import create_model
    from centroids_reid_tpu_torch.parallel import local_groups
    from centroids_reid_tpu_torch.solver import build_optimizers

    cfg = _cfg(spec["opts"])
    blob = torch.load(spec["input"], weights_only=True)
    num_classes = int(blob["num_classes"])
    model = create_model(cfg, num_classes=num_classes,
                         generator=torch.Generator().manual_seed(0))
    model.load_state_dict(blob["model"])
    centers = torch.nn.Parameter(blob["centers"].clone())
    state = TrainState(model, centers, build_optimizers(model, centers, cfg))
    g0, gl = local_groups(blob["images"].shape[0])
    out = {}
    for bad in spec.get("refused_groups", ()):
        try:
            local_groups(bad)
        except ValueError as e:
            out[f"refused_{bad}"] = str(e)
    metrics = make_train_step(state, cfg, num_classes, spec["mode"])(
        *(blob[k][g0:g0 + gl] for k in ("images", "labels", "is_real")))
    out.update({f"metric.{k}": v.numpy() for k, v in metrics.items()})
    out.update({f"grad.{n}": p.grad.numpy() for n, p in
                model.named_parameters() if p.grad is not None})
    out["grad.centers"] = centers.grad.numpy()
    out.update({f"state.{k}": v.numpy() for k, v in
                model.state_dict().items()})
    out["state.centers"] = centers.detach().numpy()
    return out


def _sigterm_at(epoch: int):
    """Rank 0 signals itself at the start of ``epoch`` (``lr_for_epoch``
    runs there, inside the preemption guard)."""
    import signal

    from centroids_reid_tpu_torch.engine import fit as FIT
    from centroids_reid_tpu_torch.parallel import process_index

    lr_for_epoch = FIT.lr_for_epoch

    def hook(e, cfg):
        if e == epoch and process_index() == 0:
            os.kill(os.getpid(), signal.SIGTERM)
        return lr_for_epoch(e, cfg)

    FIT.lr_for_epoch = hook


def task_fit(spec) -> dict:
    """``fit`` on the CPU into ``log_dir``; returns its metrics."""
    from centroids_reid_tpu_torch.engine import fit as FIT

    if spec.get("sigterm_epoch") is not None:
        _sigterm_at(spec["sigterm_epoch"])
    cfg = _cfg(spec["opts"])
    cfg.LOG_DIR = spec["log_dir"]
    out = FIT.fit(cfg, "ctl", spec["log_dir"], seed=cfg.REPRODUCIBLE_SEED,
                  device="cpu")
    return {f"metric.{k}": v for k, v in out.items()}


def task_extract(spec) -> dict:
    """The sharded extraction, then the full one with the same store; the
    number of images this rank decoded before the full extraction."""
    import torch

    from centroids_reid_tpu_torch.data import EvalLoader, init_dataset
    from centroids_reid_tpu_torch.engine.evaluate import (
        _shared_store,
        extract_embeddings,
        extract_embeddings_sharded,
    )
    from centroids_reid_tpu_torch.models import create_model

    cfg = _cfg(spec["opts"])
    dataset = init_dataset("market1501", cfg)
    model = create_model(cfg, num_classes=dataset.num_classes,
                         generator=torch.Generator().manual_seed(0)).eval()
    store = _shared_store(dataset, cfg)
    emb, pids, camids = extract_embeddings_sharded(model, cfg, dataset.val,
                                                   store)
    decoded = len(store._cache)
    ref = extract_embeddings(model, cfg, EvalLoader(dataset.val, cfg,
                                                    store=store))
    return {"emb": emb, "pids": pids, "camids": camids, "decoded": decoded,
            "ref_emb": ref[0], "ref_pids": ref[1], "ref_camids": ref[2],
            "records": len(dataset.val)}


def task_only_test(spec) -> dict:
    from centroids_reid_tpu_torch.engine import runner

    cfg = _cfg(spec["opts"])
    cfg.LOG_DIR = spec["log_dir"]
    out = runner.run_single(cfg, "ctl", "test", device="cpu")
    return {f"metric.{k}": v for k, v in out.items()}


def task_checkpoint(spec) -> dict:
    """Two best and two ring saves of a small train state (a linear layer,
    its centers and optimizers) through ``CheckpointManager(use_async=True)``
    into ``log_dir``: whether the manager writes from a thread, whether
    each save had committed and whether the previous entry was gone when it
    returned, and what is left after ``close()``."""
    import numpy as np
    import torch

    from centroids_reid_tpu_torch.engine.checkpoint import CheckpointManager
    from centroids_reid_tpu_torch.engine.state import TrainState
    from centroids_reid_tpu_torch.solver import build_optimizers

    cfg = _cfg(spec["opts"])
    torch.manual_seed(0)
    model = torch.nn.Linear(8, 4)
    centers = torch.nn.Parameter(torch.zeros(3, 4))
    state = TrainState(model, centers, build_optimizers(model, centers, cfg))
    mgr = CheckpointManager(spec["log_dir"], n_saved=1, use_async=True)
    committed, pruned = [], []
    for epoch, metric in ((0, 0.5), (1, 0.7)):
        mgr.save_if_best(epoch, state, metric)
        committed.append(os.path.isfile(os.path.join(
            mgr.best_dir, f"epoch={epoch}", "state.pt")))
        pruned.append(os.listdir(mgr.best_dir) == [f"epoch={epoch}"])
        path = mgr.save_periodic(epoch, state)
        committed.append(os.path.isfile(os.path.join(path, "state.pt")))
        pruned.append(os.listdir(mgr.auto_dir)
                      == [f"checkpoint_epoch{epoch}"])
    mgr.close()
    return {"async": np.asarray(mgr._async),
            "committed": np.asarray(committed), "pruned": np.asarray(pruned),
            "best": np.asarray(sorted(os.listdir(mgr.best_dir))),
            "ring": np.asarray(sorted(os.listdir(mgr.auto_dir)))}


TASKS = {"step": task_step, "fit": task_fit, "extract": task_extract,
         "only_test": task_only_test, "checkpoint": task_checkpoint}


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None


def main(spec: dict) -> int:
    if spec.get("block_jax"):
        sys.meta_path.insert(0, _Block())
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if spec["group"]:
        dist.init_process_group(
            "gloo", init_method="file://" + spec["store"], rank=spec["rank"],
            world_size=spec["world"],
            timeout=datetime.timedelta(seconds=spec.get("timeout", 120)))
    try:
        out = TASKS[spec["task"]](spec)
    finally:
        if spec["group"]:
            dist.destroy_process_group()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    out["jax_modules"] = np.asarray(len(loaded))
    np.savez(spec["out"], **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(json.loads(sys.argv[1])))
