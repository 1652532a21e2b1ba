"""The port's train step (``engine/steps.py``) against the JAX package's
``make_train_step`` on the CPU: resnet18 at 32x16, P = 4, K = 4 with one
mock slot, fp32, both packages on one set of weights (the port's random
model with randomised BN parameters and statistics, carried into the JAX
trees by the JAX package's ``convert_full_state_dict``).

Held, for ctl and base, after one step and along three steps:

* the features, each loss term and each metric: rtol 1e-4;
* every parameter's gradient, the centers' included: relative L2 error
  <= 1e-4 per tensor (the JAX gradients are captured by wrapping its optax
  transform);
* the BNNeck running statistics: to 1e-6 (rtol and atol);
* the trunk's running statistics: the mean to rtol 1e-4; the variance
  after correcting for the one deliberate difference, the unbiased batch
  variance of ``nn.BatchNorm2d`` against Flax's biased one (n / (n - 1),
  n = rows x H x W of the layer's input).

Parameters are not compared after an Adam step: its first update is about
``lr * sign(g)``, so a gradient near 0 turns a rounding difference into a
difference of up to ``2 * lr``. Along three steps each port step starts
from the JAX state of that step; ``tests/test_torch_train_solver.py`` holds
the optimizers on identical gradients.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu.engine import steps as JSTEPS
from centroids_reid_tpu.engine.state import TrainState as JaxTrainState
from centroids_reid_tpu.models import create_model as jax_create_model
from centroids_reid_tpu.models.convert import convert_full_state_dict
from centroids_reid_tpu.solver import build_optimizer
from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.engine import steps as TSTEPS
from centroids_reid_tpu_torch.engine.state import TrainState
from centroids_reid_tpu_torch.models import create_model, from_jax_params
from centroids_reid_tpu_torch.solver import build_optimizers

P, K, C, HW = 4, 4, 8, (32, 16)


def _cfgs(mode):
    out = []
    for make in (jax_default_cfg, get_default_cfg):
        cfg = make()
        cfg.MODEL.NAME = "resnet18"
        cfg.USE_MIXED_PRECISION = False
        cfg.INPUT.SIZE_TRAIN = list(HW)
        cfg.SOLVER.IMS_PER_BATCH = P
        cfg.DATALOADER.NUM_INSTANCE = K
        cfg.TPU.NUM_GROUPS = 1
        out.append(cfg)
    return out


def _capture(tx):
    """``tx`` whose state also holds the last gradients it was given."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@functools.lru_cache(maxsize=None)
def _jax_step(mode):
    jcfg, _ = _cfgs(mode)
    jmodel = jax_create_model(jcfg, num_classes=C)
    params = _port_model_and_centers()[2]
    tx = _capture(build_optimizer(params, jcfg)[0])
    step = jax.jit(JSTEPS.make_train_step(jmodel, tx, jcfg, C, mode))
    features = jax.jit(lambda p, s, x: jmodel.apply(
        {"params": p, "batch_stats": s}, x, train=True,
        method=jmodel.features, mutable=["batch_stats"])[0])
    return step, tx, features


@functools.lru_cache(maxsize=None)
def _port_model_and_centers():
    """The port's model with random BN parameters and statistics, its
    centers, and the JAX params tree / batch stats of the same weights."""
    _, cfg = _cfgs("ctl")
    model = create_model(cfg, num_classes=C,
                         generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, n)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.5, n)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, n)))
        model.fc_query.weight.normal_(0, 0.05,
                                      generator=torch.Generator().manual_seed(2))
    centers = torch.from_numpy(rng.randn(C, 512).astype(np.float32))
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


def _port_state(params, batch_stats, cfg):
    """A port ``TrainState`` holding the JAX state."""
    model = copy.deepcopy(_port_model_and_centers()[0])
    sd = from_jax_params(params["model"], batch_stats)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all("num_batches" in k for k in missing)
    centers = torch.nn.Parameter(torch.from_numpy(
        np.array(params["centers"], np.float32)))
    return TrainState(model, centers, build_optimizers(model, centers, cfg))


def _rel_l2(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _bn_input_sizes(model, x):
    """rows x H x W of each trunk BN's input, by state-dict prefix."""
    sizes, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: sizes.__setitem__(
                    name, inp[0].shape[0] * inp[0].shape[2]
                    * inp[0].shape[3])))
    with torch.no_grad():
        copy.deepcopy(model).train().features(x)
    # the hooks were copied with the model; drop the originals
    for h in hooks:
        h.remove()
    return sizes


def _check_step(mode, jstate, batch, jfeatures=None):
    """One port step from ``jstate`` against one JAX step; returns the JAX
    state after it."""
    jcfg, cfg = _cfgs(mode)
    jstep, _, jfeat_fn = _jax_step(mode)
    imgs, labels, is_real = batch
    jbatch = {"images": jnp.asarray(imgs[None]),
              "labels": jnp.asarray(labels[None].astype(np.int32)),
              "is_real": jnp.asarray(is_real[None])}
    new_jstate, jmetrics = jstep(jstate, jbatch)
    jgrads = jax.tree.map(np.asarray, new_jstate.opt_state[1])

    state = _port_state(jstate.params, jstate.batch_stats, cfg)
    model, centers = state.model, state.centers
    x = torch.from_numpy(imgs)
    if jfeatures:
        ref = np.asarray(jfeat_fn(jstate.params["model"], jstate.batch_stats,
                                  jnp.asarray(imgs)))
        with torch.no_grad():
            got = copy.deepcopy(model).train().features(
                x.permute(0, 3, 1, 2)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    sizes = _bn_input_sizes(model, x.permute(0, 3, 1, 2))
    old = {k: v.clone() for k, v in model.state_dict().items()}

    step = TSTEPS.make_train_step(state, cfg, C, mode)
    metrics = step(x[None], torch.from_numpy(labels)[None],
                   torch.from_numpy(is_real)[None])
    assert set(metrics) == set(jmetrics)
    for name, ref in jmetrics.items():
        np.testing.assert_allclose(metrics[name].item(), float(ref),
                                   rtol=1e-4, atol=1e-7, err_msg=name)

    gsd = from_jax_params(jgrads["model"], {})
    for name, p in model.named_parameters():
        if p.requires_grad:
            err = _rel_l2(p.grad.numpy(), gsd[name].numpy())
            assert err <= 1e-4, (name, err)
        else:
            assert name == "bn.bias" and p.grad is None
    scale = 1.0 / cfg.SOLVER.CENTER_LOSS_WEIGHT   # applied before the SGD
    assert _rel_l2(centers.grad.numpy(),
                   jgrads["centers"] * np.float32(scale)) <= 1e-4

    new_stats = from_jax_params({}, jax.tree.map(np.asarray,
                                                 new_jstate.batch_stats))
    sd = model.state_dict()
    for key in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(sd[key].numpy(), new_stats[key].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    for prefix, n in sizes.items():
        jmean = new_stats[prefix + ".running_mean"].numpy()
        np.testing.assert_allclose(sd[prefix + ".running_mean"].numpy(), jmean,
                                   rtol=1e-4, atol=1e-4 * np.abs(jmean).max())
        old_var = old[prefix + ".running_var"].numpy()
        biased = (new_stats[prefix + ".running_var"].numpy()
                  - 0.9 * old_var) / 0.1
        want = 0.9 * old_var + 0.1 * biased * n / (n - 1)
        np.testing.assert_allclose(sd[prefix + ".running_var"].numpy(), want,
                                   rtol=1e-4, err_msg=prefix)
    return new_jstate


def _initial_jax_state(mode):
    _, tx, _ = _jax_step(mode)
    _, _, params, stats = _port_model_and_centers()
    return JaxTrainState(params=params, batch_stats=stats,
                         opt_state=tx.init(params),
                         step=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("mode", ["ctl", "base"])
def test_one_step_matches_jax(mode):
    _check_step(mode, _initial_jax_state(mode), _batch(0), jfeatures=True)


@pytest.mark.parametrize("mode", ["ctl", "base"])
def test_three_steps_match_jax(mode):
    state = _initial_jax_state(mode)
    for t in range(3):
        state = _check_step(mode, state, _batch(10 + t))
    assert int(state.step) == 3


def test_masked_bnneck_matches_jax():
    rng = np.random.RandomState(4)
    feat = rng.randn(16, 12).astype(np.float32) * 3 + 1
    is_real = rng.rand(16) > 0.25
    w = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    b = rng.normal(0, 0.1, 12).astype(np.float32)
    rm = rng.normal(0, 1, 12).astype(np.float32)
    rv = rng.uniform(0.5, 2, 12).astype(np.float32)

    def jfn(f):
        out, stats = JSTEPS._masked_bnneck(
            f, jnp.asarray(is_real), {"scale": w, "bias": b},
            {"mean": rm, "var": rv})
        return (out * out).sum(), (out, stats)

    jg, (jout, jstats) = jax.grad(jfn, has_aux=True)(jnp.asarray(feat))
    tf = torch.from_numpy(feat).requires_grad_(True)
    out, (mean, var) = TSTEPS.masked_bnneck(
        tf, torch.from_numpy(is_real), torch.from_numpy(w), torch.from_numpy(b),
        torch.from_numpy(rm), torch.from_numpy(rv))
    (out * out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), jg, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), jstats["mean"], atol=1e-6)
    np.testing.assert_allclose(var.numpy(), jstats["var"], atol=1e-6)


def test_step_refuses_groups_and_unknown_modes():
    """Unknown modes, and a batch without its group axis (the step takes
    [G, P*K, ...] batches at every ``TPU.NUM_GROUPS``)."""
    _, cfg = _cfgs("ctl")
    model, centers, _ = _port_model_and_centers()[:3]
    model = copy.deepcopy(model)
    centers = torch.nn.Parameter(centers.clone())
    state = TrainState(model, centers, build_optimizers(model, centers, cfg))
    with pytest.raises(ValueError, match="mode"):
        TSTEPS.make_train_step(state, cfg, C, "triplet")
    imgs, labels, is_real = (torch.from_numpy(a) for a in _batch(0))
    step = TSTEPS.make_train_step(state, cfg, C, "ctl")
    with pytest.raises(ValueError, match="group-major"):
        step(imgs, labels, is_real)
    with pytest.raises(ValueError, match="group-major"):
        step(imgs[None], labels, is_real[None])


@pytest.mark.parametrize("mode", ["ctl", "base"])
def test_float64_step_stays_float64(mode):
    """A float64 model steps in float64 end to end (the features, BNNeck,
    losses, gradients and centers), so a float64 step can witness an fp32
    one; at this size the two agree to 1e-5 (losses) and 1e-4 (gradients,
    relative L2)."""
    _, cfg = _cfgs(mode)
    imgs, labels, is_real = _batch(5)
    base, centers0 = _port_model_and_centers()[:2]
    out = {}
    for dtype in (torch.float32, torch.float64):
        model = copy.deepcopy(base).to(dtype)
        centers = torch.nn.Parameter(centers0.clone().to(dtype))
        state = TrainState(model, centers, build_optimizers(model, centers,
                                                            cfg))
        metrics = TSTEPS.make_train_step(state, cfg, C, mode)(
            torch.from_numpy(imgs).to(dtype)[None],
            torch.from_numpy(labels)[None], torch.from_numpy(is_real)[None])
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        grads["centers"] = centers.grad
        assert all(v.dtype == dtype for v in metrics.values())
        assert all(g.dtype == dtype for g in grads.values())
        assert model.bn.running_var.dtype == dtype
        out[dtype] = metrics, grads
    (m32, g32), (m64, g64) = out[torch.float32], out[torch.float64]
    for name in m64:
        np.testing.assert_allclose(m32[name].item(), m64[name].item(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    for name in g64:
        err = _rel_l2(g32[name].double().numpy(), g64[name].numpy())
        assert err <= 1e-4, (name, err)
