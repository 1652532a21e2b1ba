"""The port's solver against the JAX package's on the CPU: the epoch LR
schedule equal for every epoch, and the optimizers fed the same gradients.

Three updates of Adam (coupled weight decay) + the center SGD must equal
the same updates computed in float64 (rtol 1e-6, with an absolute floor of
1e-6 of each tensor's largest magnitude), and the optax ``multi_transform``
of ``centroids_reid_tpu/solver/build.py`` to rtol 2e-5 (absolute floor
2e-5 of the largest magnitude): optax rounds Adam's bias correction
``1 - 0.999^t`` to float32, a relative error of 1.3e-5 of every update at
t = 1 (``torch.optim.Adam`` keeps it in float64). The BNNeck bias stays
frozen. Parameters are compared after
the updates because both sides get identical gradients: Adam's first
update is about ``lr * sign(g)``, so after a train step two gradients that
differ by rounding may move a parameter by up to ``2 * lr``
(tests/test_torch_train_step.py compares gradients instead)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu.engine.state import create_train_state
from centroids_reid_tpu.models import create_model as jax_create_model
from centroids_reid_tpu.solver import build as JS
from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.models import ReidModel, from_jax_train_state
from centroids_reid_tpu_torch.solver import build as TS

NUM_CLASSES = 8


@pytest.mark.parametrize("scheduler", ["multistep_lr", "cosine_annealing"])
@pytest.mark.parametrize("warmup", [True, False])
def test_lr_for_epoch_equals_jax(scheduler, warmup):
    cfgs = []
    for make in (jax_default_cfg, get_default_cfg):
        cfg = make()
        cfg.SOLVER.LR_SCHEDULER_NAME = scheduler
        cfg.SOLVER.USE_WARMUP_LR = warmup
        cfg.SOLVER.MIN_LR = 1e-6
        cfgs.append(cfg)
    lrs = [TS.lr_for_epoch(e, cfgs[1]) for e in range(cfgs[1].SOLVER.MAX_EPOCHS)]
    assert lrs == [JS.lr_for_epoch(e, cfgs[0])
                   for e in range(cfgs[0].SOLVER.MAX_EPOCHS)]
    assert len(set(lrs)) > 2


def test_unknown_optimizer_and_scheduler_are_refused():
    cfg = get_default_cfg()
    cfg.SOLVER.LR_SCHEDULER_NAME = "step"
    with pytest.raises(NotImplementedError, match="scheduler"):
        TS.lr_for_epoch(0, cfg)
    cfg.SOLVER.OPTIMIZER_NAME = "SGD"
    model = ReidModel("resnet18", num_classes=NUM_CLASSES)
    with pytest.raises(NotImplementedError, match="optimizer"):
        TS.build_optimizers(model, torch.nn.Parameter(torch.zeros(8, 512)),
                            cfg)


def _grads(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: rng.normal(0, 1e-2, np.shape(x)).astype(np.float32), params)


def test_optimizers_equal_optax_on_the_same_gradients():
    jcfg = jax_default_cfg()
    jcfg.MODEL.NAME = "resnet18"
    jcfg.USE_MIXED_PRECISION = False
    jcfg.INPUT.SIZE_TRAIN = [32, 16]
    jmodel = jax_create_model(jcfg, num_classes=NUM_CLASSES)
    state, tx = create_train_state(jcfg, jmodel, NUM_CLASSES, seed=0)
    params, opt_state = state.params, state.opt_state

    cfg = get_default_cfg()
    model = ReidModel("resnet18", num_classes=NUM_CLASSES)
    sd, centers = from_jax_train_state(params, state.batch_stats)
    model.load_state_dict(sd, strict=False)
    centers = torch.nn.Parameter(centers)
    opts = TS.build_optimizers(model, centers, cfg)
    bias0 = model.bn.bias.detach().clone()

    # the float64 reference: Adam with coupled decay, the center SGD
    wd, c_lr = cfg.SOLVER.WEIGHT_DECAY, cfg.SOLVER.CENTER_LR
    f64 = {n: p.detach().double().numpy().copy()
           for n, p in model.named_parameters() if p.requires_grad}
    f64["centers"] = centers.detach().double().numpy().copy()
    moments = {n: (np.zeros_like(a), np.zeros_like(a)) for n, a in f64.items()}

    for it, lr in enumerate((3.5e-5, 1e-4, 7e-5)):
        JS.set_learning_rate(opt_state, lr)
        TS.set_learning_rate(opts, lr)
        assert [g["lr"] for g in opts.model.param_groups] == [lr]
        grads = _grads(params, it)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        gsd, gcenters = from_jax_train_state(grads, {})
        t = it + 1
        for n, a in f64.items():
            if n == "centers":
                a -= c_lr * gcenters.double().numpy() / cfg.SOLVER.CENTER_LOSS_WEIGHT
                continue
            g = gsd[n].double().numpy() + wd * a
            m, v = moments[n]
            m[...] = 0.9 * m + 0.1 * g
            v[...] = 0.999 * v + 0.001 * g * g
            a -= lr * (m / (1 - 0.9 ** t)) / (
                np.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
        opts.zero_grad()
        for name, p in model.named_parameters():
            if p.requires_grad:
                p.grad = gsd[name].clone()
        centers.grad = gcenters.clone()
        opts.step()

    ref_sd, ref_centers = from_jax_train_state(jax.tree.map(np.asarray, params),
                                               state.batch_stats)
    got = dict(model.named_parameters())
    got["centers"] = centers
    ref_sd["centers"] = ref_centers
    for name, exact in f64.items():
        mine = got[name].detach().numpy()
        np.testing.assert_allclose(mine, exact, rtol=1e-6,
                                   atol=1e-6 * np.abs(exact).max(),
                                   err_msg=name)
        optax_ref = ref_sd[name].numpy()
        np.testing.assert_allclose(mine, optax_ref, rtol=2e-5,
                                   atol=2e-5 * np.abs(optax_ref).max(),
                                   err_msg=name)
    assert torch.equal(model.bn.bias, bias0)
    np.testing.assert_array_equal(
        np.asarray(params["model"]["bnneck"]["bias"]), bias0.numpy())
    # the weights moved: the comparison is not of untouched ones
    before = from_jax_train_state(state.params, state.batch_stats)[0]
    assert not torch.equal(got["fc_query.weight"], before["fc_query.weight"])
