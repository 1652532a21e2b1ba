"""Three config knobs the port now honours, on the CPU:

* ``TPU.MATMUL_PRECISION`` (``engine/runner.py::run_single``, as the
  reference's ``run_single`` applies ``jax_default_matmul_precision``):
  ``default`` leaves the TF32 switches, ``highest`` / ``float32`` turn TF32
  off for matmuls and cuDNN, ``tensorfloat32`` turns it on, for the whole
  run, and the switches come back afterwards, also when the run raises;
  JAX's values without a cuBLAS / cuDNN counterpart raise ``ValueError``
  naming the values honoured.
* ``TPU.DEBUG_NANS`` (the train step): a NaN or an infinity in a loss term
  or a gradient raises ``FloatingPointError`` naming it, before the
  optimizers step; off, the step runs on without the check.
* ``LoadedRetriever`` refuses a re-ranking artifact whose meta lacks
  ``distance``; without re-ranking it assumes euclidean and warns.
"""

import copy
import io
import logging

import numpy as np
import pytest
import torch

from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.engine import runner
from centroids_reid_tpu_torch.engine import steps as TSTEPS
from centroids_reid_tpu_torch.engine.state import TrainState
from centroids_reid_tpu_torch.solver import build_optimizers
from test_torch_train_step import C, _batch, _cfgs, _port_model_and_centers


def _switches():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.mark.parametrize("value,inside", [
    ("default", None),
    ("highest", (False, False, "highest")),
    ("float32", (False, False, "highest")),
    ("tensorfloat32", (True, True, "high")),
])
def test_matmul_precision_holds_for_the_run(monkeypatch, value, inside):
    before = _switches()
    seen = []
    monkeypatch.setattr(runner, "_run_single",
                        lambda *a: seen.append(_switches()) or {"ok": 1.0})
    cfg = get_default_cfg()
    cfg.TPU.MATMUL_PRECISION = value
    assert runner.run_single(cfg, "ctl", "x", device="cpu") == {"ok": 1.0}
    assert seen == [inside or before]
    assert _switches() == before

    def fail(*a):
        seen.append(_switches())
        raise RuntimeError("the run failed")

    monkeypatch.setattr(runner, "_run_single", fail)
    with pytest.raises(RuntimeError, match="run failed"):
        runner.run_single(cfg, "ctl", "x", device="cpu")
    assert seen[-1] == (inside or before) and _switches() == before


@pytest.mark.parametrize("value", ["high", "bfloat16", "bfloat16_3x",
                                   "fastest"])
def test_matmul_precision_refuses_what_cuda_cannot_compute(value):
    cfg = get_default_cfg()
    cfg.TPU.MATMUL_PRECISION = value
    with pytest.raises(ValueError, match="default, float32, highest, "
                                         "tensorfloat32"):
        runner.run_single(cfg, "ctl", "x", device="cpu")


def _step(debug_nans: bool, poison=None):
    _, cfg = _cfgs("ctl")
    cfg.TPU.DEBUG_NANS = debug_nans
    model, centers = (copy.deepcopy(t) for t in _port_model_and_centers()[:2])
    centers = torch.nn.Parameter(centers)
    state = TrainState(model, centers, build_optimizers(model, centers, cfg))
    imgs, labels, is_real = (torch.from_numpy(a)[None] for a in _batch(3))
    if poison == "images":
        imgs[0, 0, 0, 0, 0] = float("nan")
    elif poison == "fc_query":
        with torch.no_grad():
            model.fc_query.weight[0, 0] = float("inf")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = TSTEPS.make_train_step(state, cfg, C, "ctl")
    return step, (imgs, labels, is_real), model, before


@pytest.mark.parametrize("poison,names", [
    ("images", "loss term query_triplet"),
    ("fc_query", "loss term query_xent"),
])
def test_debug_nans_raises_naming_the_value(poison, names):
    step, batch, model, before = _step(True, poison)
    with pytest.raises(FloatingPointError, match=names):
        step(*batch)
    # raised before the optimizers stepped
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n


def test_debug_nans_names_a_gradient():
    """A finite loss whose gradient is not: the first such parameter."""
    step, batch, model, _ = _step(True)
    hook = model.backbone.layer4[1].conv2.weight.register_hook(
        lambda g: torch.full_like(g, float("nan")))
    try:
        with pytest.raises(FloatingPointError,
                           match="gradient of backbone.layer4.1.conv2"):
            step(*batch)
    finally:
        hook.remove()


def test_debug_nans_off_adds_no_check(monkeypatch):
    def refuse(*a):
        raise AssertionError("checked with TPU.DEBUG_NANS off")

    monkeypatch.setattr(TSTEPS, "_check_finite", refuse)
    step, batch, _, _ = _step(False, "images")
    metrics = step(*batch)
    assert not np.isfinite(metrics["loss"].item())
    monkeypatch.undo()
    on, batch_on, _, _ = _step(True)
    off, batch_off, _, _ = _step(False)
    m_on, m_off = on(*batch_on), off(*batch_off)
    assert all(torch.equal(m_on[k], m_off[k]) for k in m_on)


def _retriever(meta_extra, **kw):
    from centroids_reid_tpu_torch.inference.export import LoadedRetriever

    buf = io.BytesIO()
    rng = np.random.RandomState(0)
    np.savez(buf, gallery=rng.randn(6, 8).astype(np.float32),
             paths=np.array([f"g{i}" for i in range(6)]))
    meta = {"rank_stage": "live", "batch_size": 2, "k": 3, **meta_extra}
    return LoadedRetriever(None, meta, buf.getvalue(), "cpu",
                           use_bf16_kernel=False, **kw)


def test_retriever_without_distance(caplog):
    with pytest.raises(ValueError, match="lacks 'distance'"):
        _retriever({}, rerank_window=4)
    for dist in ("euclidean", "cosine"):
        assert _retriever({"distance": dist}, rerank_window=4)._dist == dist
    with caplog.at_level(logging.WARNING):
        ret = _retriever({})
    assert "assuming euclidean" in caplog.text and ret._dist == "euclidean"
    d, idx = ret._rank(torch.from_numpy(
        np.random.RandomState(1).randn(2, 8).astype(np.float32)))
    assert d.shape == idx.shape == (2, 3)
