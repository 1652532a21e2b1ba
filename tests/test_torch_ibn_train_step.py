"""The port's train step on a ResNet50-IBN-a trunk against the JAX
package's ``make_train_step`` on the CPU: resnet50_ibn_a's widths with its
depth cut to one bottleneck per stage (layers 1-3 carry IBN: InstanceNorm
on half of ``bn1``'s channels, the stem ReLU kept), 32x32 images, P = 4,
K = 4 with one mock slot, both packages on one set of weights (the port's
random model with randomised BN and IN parameters and BN statistics,
carried into the JAX trees by ``convert_full_state_dict``).

Held as ``test_torch_train_step.py`` holds resnet18, for ctl and base:

* the features, each loss term and each metric: rtol 1e-4;
* every parameter's gradient, the IN affine parameters and the centers
  included: relative L2 error <= 1e-4 per tensor;
* the BNNeck running statistics to 1e-6; the trunk's (the IBN layers' BN
  halves included) as there, after correcting the running variance for
  ``nn.BatchNorm2d``'s unbiased batch variance.

In fp32 the features, losses, metrics and statistics are held against the
JAX package's fp32 step. Its fp32 trunk gradients are not: at this size
they lie farther than 1e-4 (relative L2 per tensor) from the same JAX step
run with its trunk in float64 (``ReidModel(dtype=float64)`` under
``jax.enable_x64``), while the port's fp32 gradient
lies within 1e-4 of it; and its fp32 features carry enough of that
rounding that a BNNeck running variance can lie more than 1e-6 from the
port's. So the gradients are held per tensor with both steps in float64
(the JAX step's losses and BNNeck stay fp32, as it casts the features),
and the port's fp32 gradient as a whole (every tensor in one vector) and
its BNNeck statistics against the JAX float64 step: relative L2 <= 1e-4,
and 1e-6. The three-step chain runs in
float64, each port step from the JAX state of that step
(``test_torch_ibn_train_steps.py``).

InstanceNorm has no running statistics and normalises each sample over
its own H x W, so a mock slot's pixels cannot reach another row's IN
output: ``test_mock_rows_do_not_reach_other_rows_instance_norm`` changes
the mock slot and finds every other row's IN half unchanged bit for bit
(the BN half, whose batch statistics take every row in both packages,
moves).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu.engine import steps as JSTEPS
from centroids_reid_tpu.engine.state import TrainState as JaxTrainState
from centroids_reid_tpu.models import create_model as jax_create_model
from centroids_reid_tpu.models import resnet as JR
from centroids_reid_tpu.models.convert import convert_full_state_dict
from centroids_reid_tpu.solver import build_optimizer
from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.engine import steps as TSTEPS
from centroids_reid_tpu_torch.engine.state import TrainState
from centroids_reid_tpu_torch.models import create_model, from_jax_params
from centroids_reid_tpu_torch.models import resnet as TR
from centroids_reid_tpu_torch.solver import build_optimizers
from test_torch_train_step import _bn_input_sizes, _capture, _rel_l2

P, K, C, HW = 4, 4, 8, (32, 32)
ARCH = "resnet50_ibn_a_cut"
EMB = 2048


@pytest.fixture(scope="module", autouse=True)
def ibn_cut():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JR, TR):
            mp.setitem(mod._ARCHS, ARCH, dict(
                block=mod.Bottleneck, layers=(1, 1, 1, 1), ibn=True,
                emb=EMB))
        yield
    _jax_step.cache_clear()
    _port_model_and_centers.cache_clear()


def _cfgs(mode):
    out = []
    for make in (jax_default_cfg, get_default_cfg):
        cfg = make()
        cfg.MODEL.NAME = ARCH
        cfg.USE_MIXED_PRECISION = False
        cfg.INPUT.SIZE_TRAIN = list(HW)
        cfg.SOLVER.IMS_PER_BATCH = P
        cfg.DATALOADER.NUM_INSTANCE = K
        cfg.TPU.NUM_GROUPS = 1
        out.append(cfg)
    return out


@functools.lru_cache(maxsize=None)
def _jax_step(mode, dtype="float32"):
    """The JAX step (jitted; its model's compute dtype ``dtype``, float64
    under ``jax.enable_x64``), its capturing transform and features fn."""
    jcfg, _ = _cfgs(mode)
    jmodel = jax_create_model(jcfg, num_classes=C).clone(
        dtype=getattr(jnp, dtype))
    params = _port_model_and_centers()[2]
    tx = _capture(build_optimizer(params, jcfg)[0])
    step = jax.jit(JSTEPS.make_train_step(jmodel, tx, jcfg, C, mode))
    features = jax.jit(lambda p, s, x: jmodel.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        method=jmodel.features, mutable=["batch_stats"])[0])
    return step, tx, features


def _x64(dtype):
    return jax.enable_x64(dtype == "float64")


@functools.lru_cache(maxsize=None)
def _port_model_and_centers():
    """The port's IBN-a model with random BN and IN parameters and BN
    statistics, its centers, and the JAX trees of the same weights."""
    _, cfg = _cfgs("ctl")
    model = create_model(cfg, num_classes=C,
                         generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    n_in = 0
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d,
                              torch.nn.InstanceNorm2d)):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, n)))
            if isinstance(m, torch.nn.InstanceNorm2d):
                n_in += 1
            elif isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, n)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, n)))
        model.fc_query.weight.normal_(0, 0.05,
                                      generator=torch.Generator().manual_seed(2))
    assert n_in == 3                    # layers 1-3, one bottleneck each
    centers = torch.from_numpy(rng.randn(C, EMB).astype(np.float32))
    conv = convert_full_state_dict(model.state_dict())
    params = {"model": conv["params"], "centers": centers.numpy()}
    return model, centers, params, conv["batch_stats"]


def _batch(seed):
    rng = np.random.RandomState(seed)
    imgs = rng.randn(P * K, *HW, 3).astype(np.float32)
    labels = np.repeat(rng.choice(C, P, replace=False), K).astype(np.int64)
    is_real = np.ones(P * K, bool)
    is_real[2 * K - 1] = False          # the last slot of pid 2 is a mock
    imgs[~is_real] = 0.0
    return imgs, labels, is_real


def _port_state(params, batch_stats, cfg, dtype="float32"):
    model = copy.deepcopy(_port_model_and_centers()[0])
    sd = from_jax_params(params["model"], batch_stats)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all("num_batches" in k for k in missing)
    model.to(getattr(torch, dtype))
    centers = torch.nn.Parameter(torch.from_numpy(
        np.array(params["centers"], dtype)))
    return TrainState(model, centers, build_optimizers(model, centers, cfg))


def _port_grads(state):
    grads = {n: p.grad.double().numpy()
             for n, p in state.model.named_parameters() if p.grad is not None}
    grads["centers"] = state.centers.grad.double().numpy()
    return grads


def _jax_grads(new_jstate, cfg):
    """The captured JAX gradients under the port's names, the centers'
    scaled as the port's optimizer scales them before its SGD step."""
    jgrads = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          new_jstate.opt_state[1])
    grads = {k: v.double().numpy()
             for k, v in from_jax_params(jgrads["model"], {}).items()}
    grads["centers"] = jgrads["centers"] / cfg.SOLVER.CENTER_LOSS_WEIGHT
    return grads


def _check_step(mode, jstate, batch, dtype, jfeatures=False, exact=None):
    """One port step from ``jstate`` against one JAX step, both computing
    in ``dtype``; returns the JAX state after it. With ``exact``, the
    state after the JAX float64 step from the same state, the gradients
    (as a whole) and the BNNeck statistics are held against that step
    instead."""
    jcfg, cfg = _cfgs(mode)
    jstep, _, jfeat_fn = _jax_step(mode, dtype)
    imgs, labels, is_real = batch
    imgs = imgs.astype(dtype)
    with _x64(dtype):
        jbatch = {"images": jnp.asarray(imgs[None]),
                  "labels": jnp.asarray(labels[None].astype(np.int32)),
                  "is_real": jnp.asarray(is_real[None])}
        new_jstate, jmetrics = jstep(jstate, jbatch)
        if jfeatures:
            ref = np.asarray(jfeat_fn(jstate.params["model"],
                                      jstate.batch_stats, jnp.asarray(imgs)))
    jmetrics = {k: float(v) for k, v in jmetrics.items()}

    state = _port_state(jstate.params, jstate.batch_stats, cfg, dtype)
    model = state.model
    x = torch.from_numpy(imgs)
    if jfeatures:
        with torch.no_grad():
            got = copy.deepcopy(model).train().features(
                x.permute(0, 3, 1, 2)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    sizes = _bn_input_sizes(model, x.permute(0, 3, 1, 2))
    assert any(".bn1.BN" in k for k in sizes)
    old = {k: v.clone() for k, v in model.state_dict().items()}

    step = TSTEPS.make_train_step(state, cfg, C, mode)
    metrics = step(x[None], torch.from_numpy(labels)[None],
                   torch.from_numpy(is_real)[None])
    assert set(metrics) == set(jmetrics)
    for name, ref in jmetrics.items():
        np.testing.assert_allclose(metrics[name].item(), ref, rtol=1e-4,
                                   atol=1e-7, err_msg=name)

    grads = _port_grads(state)
    assert model.bn.bias.grad is None    # the frozen BNNeck bias
    assert sum(".IN." in n for n in grads) == 6   # 3 IN layers' affine
    if exact is None:
        jgrads = _jax_grads(new_jstate, cfg)
        for name, g in grads.items():
            err = _rel_l2(g, jgrads[name])
            assert err <= 1e-4, (name, err)
    else:
        jgrads = _jax_grads(exact, cfg)
        names = sorted(grads)

        def whole(g):
            return np.concatenate([g[n].ravel() for n in names])

        assert _rel_l2(whole(grads), whole(jgrads)) <= 1e-4

    new_stats = from_jax_params({}, jax.tree.map(np.asarray,
                                                 new_jstate.batch_stats))
    neck = new_stats if exact is None else from_jax_params(
        {}, jax.tree.map(np.asarray, exact.batch_stats))
    sd = {k: v.double().numpy() for k, v in model.state_dict().items()}
    assert not any(".IN." in k for k in new_stats)   # IN keeps no statistics
    for key in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(sd[key], neck[key].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    for prefix, n in sizes.items():
        jmean = new_stats[prefix + ".running_mean"].numpy()
        np.testing.assert_allclose(sd[prefix + ".running_mean"], jmean,
                                   rtol=1e-4, atol=1e-4 * np.abs(jmean).max())
        old_var = old[prefix + ".running_var"].double().numpy()
        biased = (new_stats[prefix + ".running_var"].numpy()
                  - 0.9 * old_var) / 0.1
        want = 0.9 * old_var + 0.1 * biased * n / (n - 1)
        np.testing.assert_allclose(sd[prefix + ".running_var"], want,
                                   rtol=1e-4, err_msg=prefix)
    return new_jstate


def _initial_jax_state(mode, dtype="float32"):
    _, tx, _ = _jax_step(mode, dtype)
    _, _, params, stats = _port_model_and_centers()
    with _x64(dtype):
        cast = functools.partial(jax.tree.map,
                                 lambda a: jnp.asarray(np.asarray(a, dtype)))
        params, stats = cast(params), cast(stats)
        return JaxTrainState(params=params, batch_stats=stats,
                             opt_state=tx.init(params),
                             step=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("mode", ["ctl", "base"])
def test_one_ibn_step_matches_jax(mode):
    """float64 against the JAX float64 step (gradients per tensor), then
    fp32 against the JAX fp32 step (the gradient as a whole and the BNNeck
    statistics against the JAX float64 step)."""
    new64 = _check_step(mode, _initial_jax_state(mode, "float64"),
                        _batch(0), "float64", jfeatures=True)
    _check_step(mode, _initial_jax_state(mode), _batch(0), "float32",
                jfeatures=True, exact=new64)


def test_mock_rows_do_not_reach_other_rows_instance_norm():
    """Each IBN layer of the model in train mode, on a batch of its input
    width whose mock slot is zero, then with noise in the mock slot: the IN
    half of every other row is equal bit for bit, the BN half is not; the
    zero mock row's IN half is finite (its bias)."""
    model = copy.deepcopy(_port_model_and_centers()[0]).train()
    real = torch.from_numpy(_batch(0)[2])
    layers = [m for m in model.modules() if isinstance(m, TR.IBN)]
    assert len(layers) == 3
    for i, ibn in enumerate(layers):
        width = ibn.half + ibn.BN.num_features
        gen = torch.Generator().manual_seed(5 + i)
        x = torch.randn(P * K, width, 8, 8, generator=gen)
        x[~real] = 0.0
        x2 = x.clone()
        x2[~real] = torch.randn(int((~real).sum()), width, 8, 8,
                                generator=gen) * 7
        with torch.no_grad():
            a, b = ibn(x), ibn(x2)
        h = ibn.half
        assert torch.equal(a[real, :h], b[real, :h])
        assert not torch.equal(a[real, h:], b[real, h:])
        assert torch.isfinite(a[~real, :h]).all()
        torch.testing.assert_close(
            a[~real, :h], ibn.IN.bias[None, :, None, None].expand(
                int((~real).sum()), h, 8, 8), rtol=0, atol=0)
