"""The smaller pieces of the JAX package's training API, each against its
JAX counterpart on the CPU:

* ``engine.evaluate.evaluate_on_train`` (the "Train mAP" diagnostic) on one
  reference-format ``.pth`` (resnet18, 32x16, fp32) and one Market-1501
  layout, with and without centroids: the same keys, Top-k equal and mAP
  within 1e-6 (the embeddings differ only by the fp32 conv order, as in
  ``test_torch_eval.py``);
* ``solver.current_learning_rate``: the model optimizer's LR, equal to the
  JAX package's (which stores it in float32) within 1e-7 relative;
* ``TrainLoader.steps_per_epoch``: equal step counts;
* ``PreemptionGuard.signalled``: the local flag, as the JAX guard's;
* ``utils.step_marker``: a profiler range named with the step.
"""

import os
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu_torch.config import get_default_cfg
from test_torch_eval import small_cfg, write_reference_pth


def _write_market_with_train(root, n_pids=6, hw=(32, 16), seed=3):
    """A Market-1501 layout whose train split holds 4 images of each pid
    on cameras 1-4 (so a train query keeps positives on other cameras);
    each pid a base colour with per-image shifts and noise."""
    base = root / "market1501"
    rng = np.random.RandomState(seed)
    colors = rng.randint(40, 215, (n_pids, 3))
    for sub in ("bounding_box_train", "query", "bounding_box_test"):
        (base / sub).mkdir(parents=True)

    def write(subdir, pid, camid, i):
        shift = rng.randint(-45, 46, (1, 1, 3))
        arr = np.clip(colors[pid] + shift
                      + rng.randint(-20, 20, (*hw, 3)), 0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(
            base / subdir / f"{pid + 1:04d}_c{camid}s1_{i:06d}_00.jpg")

    for pid in range(n_pids):
        for i in range(4):
            write("bounding_box_train", pid, 1 + i, i)
        write("query", pid, 1, 100)
        for i in range(2):
            write("bounding_box_test", pid, 2 + i, 200 + i)
    return str(root)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_api")
    return (write_reference_pth(tmp / "reid.pth"),
            _write_market_with_train(tmp / "data"), tmp)


@pytest.mark.parametrize("use_centroids", [True, False])
def test_evaluate_on_train_matches_jax(setup, use_centroids):
    from centroids_reid_tpu.data import init_dataset as jinit
    from centroids_reid_tpu.engine import evaluate_on_train as jeval_on_train
    from centroids_reid_tpu.engine.runner import (
        load_model_for_test as jload,
    )
    from centroids_reid_tpu_torch.data import init_dataset
    from centroids_reid_tpu_torch.engine import (
        evaluate_on_train,
        load_model_for_test,
    )

    pth, data, tmp = setup
    jcfg = small_cfg(jax_default_cfg, pth, data, str(tmp / "jax_logs"))
    jds = jinit(jcfg.DATASETS.NAMES, jcfg)
    jmodel, params, stats = jload(jcfg, jds)
    ref = jeval_on_train(jcfg, jmodel, params, stats, jds,
                         use_centroids=use_centroids)

    cfg = small_cfg(get_default_cfg, pth, data, str(tmp / "port_logs"))
    model = load_model_for_test(cfg, device="cpu")
    model.train()
    got = evaluate_on_train(cfg, model, init_dataset(cfg.DATASETS.NAMES, cfg),
                            use_centroids=use_centroids)
    assert model.training              # its mode is restored
    assert sorted(got) == sorted(ref)
    assert "Train mAP" in got and "Train Top-1" in got
    for key in ref:
        if key == "Train mAP":
            assert abs(got[key] - float(ref[key])) <= 1e-6, key
        else:
            assert got[key] == ref[key], key
    assert 0.0 < got["Train mAP"] <= 1.0


def test_current_learning_rate_matches_jax():
    import jax.numpy as jnp

    from centroids_reid_tpu.solver import build as jbuild
    from centroids_reid_tpu_torch.models import create_model
    from centroids_reid_tpu_torch.solver import (
        build_optimizers,
        current_learning_rate,
        lr_for_epoch,
        set_learning_rate,
    )

    cfg, jcfg = get_default_cfg(), jax_default_cfg()
    for c in (cfg, jcfg):
        c.MODEL.NAME = "resnet18"
        c.SOLVER.USE_WARMUP_LR = True
    model = create_model(cfg, num_classes=4)
    centers = torch.nn.Parameter(torch.zeros(4, 512))
    opts = build_optimizers(model, centers, cfg)
    params = {"model": {"w": jnp.zeros(3)}, "centers": jnp.zeros((4, 3))}
    tx, _ = jbuild.build_optimizer(params, jcfg)
    opt_state = tx.init(params)
    assert current_learning_rate(opts) == cfg.SOLVER.BASE_LR
    for epoch in (0, 3, 9, 40, 80):
        lr = lr_for_epoch(epoch, cfg)
        set_learning_rate(opts, lr)
        opt_state = jbuild.set_learning_rate(opt_state, lr)
        got = current_learning_rate(opts)
        assert got == lr
        assert abs(got - jbuild.current_learning_rate(opt_state)) <= 1e-7 * lr


@pytest.mark.parametrize("resampling", [True, False])
def test_steps_per_epoch_matches_jax(setup, resampling):
    from centroids_reid_tpu.data import TrainLoader as JTrainLoader
    from centroids_reid_tpu.data import init_dataset as jinit
    from centroids_reid_tpu_torch.data import TrainLoader, init_dataset

    _, data, tmp = setup
    counts = []
    for make, init, loader in ((jax_default_cfg, jinit, JTrainLoader),
                               (get_default_cfg, init_dataset, TrainLoader)):
        cfg = small_cfg(make, "", data, str(tmp))
        cfg.SOLVER.IMS_PER_BATCH = 2
        cfg.DATALOADER.NUM_INSTANCE = 2
        cfg.DATALOADER.USE_RESAMPLING = resampling
        tl = loader(init(cfg.DATASETS.NAMES, cfg), cfg, num_groups=2)
        counts.append([tl.steps_per_epoch(e) for e in range(3)]
                      + [tl.steps_per_epoch()])
    assert counts[0] == counts[1]
    assert all(n > 0 for n in counts[1])


def test_signalled_is_the_local_flag():
    from centroids_reid_tpu.utils.preemption import (
        PreemptionGuard as JGuard,
    )
    from centroids_reid_tpu_torch.utils import PreemptionGuard

    seen = []
    for guard_cls in (JGuard, PreemptionGuard):
        with guard_cls() as guard:
            before = guard.signalled
            os.kill(os.getpid(), signal.SIGTERM)
            seen.append((before, guard.signalled, guard.should_stop(1)))
        assert not guard_cls(enabled=False).signalled
    assert seen == [(False, True, True)] * 2


def test_step_marker_names_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile

    from centroids_reid_tpu_torch.utils import step_marker

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for step in range(2):
            with step_marker("train", step):
                torch.ones(4).add_(1)
    names = [e.name for e in prof.events()]
    assert "train#0" in names and "train#1" in names
