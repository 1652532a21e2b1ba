"""An ImageNet backbone file in the reference ResNet-IBN-a layout (the
published ``r50_ibn_a.pth`` that ``configs/320_resnet50_ibn_a.yml`` names:
``bn1.IN.weight`` / ``.bias`` and ``bn1.BN.*`` with running statistics and
``num_batches_tracked`` in the bottlenecks of layers 1-3, plain BN in
layer 4, the ``fc`` head) through the port's ``backbone_state_dict`` and
the JAX package's ``convert_backbone_state_dict``, each as its ``fit``
loads ``MODEL.PRETRAIN_PATH``. resnet50_ibn_a's widths with the depth cut
to one bottleneck per stage, seeded random values, 64x64 images, fp32 on
the CPU: the two packages' embeddings of the loaded trunk agree within
1e-5 (relative to the embedding scale), in the plain layout, nested under
``state_dict`` and with the ``backbone.base.`` prefix. Neither package
strips a ``module.`` prefix (a ``DataParallel`` save): such a file leaves
both trunks as they were."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu.models import resnet as JR
from centroids_reid_tpu.models.convert import (
    convert_backbone_state_dict,
    graft,
)
from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.models import create_model, from_jax_params
from centroids_reid_tpu_torch.models import resnet as TR
from centroids_reid_tpu_torch.models.convert import backbone_state_dict

ARCH = "resnet50_ibn_a_cut"


@pytest.fixture(scope="module", autouse=True)
def ibn_cut():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JR, TR):
            mp.setitem(mod._ARCHS, ARCH, dict(
                block=mod.Bottleneck, layers=(1, 1, 1, 1), ibn=True,
                emb=2048))
        yield


def _reference_file(seed=0):
    """The cut trunk's state dict in the reference IBN-a layout, every
    value seeded random (BN variances positive), with the ImageNet head."""
    cfg = get_default_cfg()
    cfg.MODEL.NAME = ARCH
    trunk = create_model(cfg).backbone.state_dict()
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in trunk.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(1000, dtype=torch.int64)
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 2, v.shape)).float()
        elif k.endswith(("running_mean", ".bias")):
            sd[k] = torch.from_numpy(rng.normal(0, 0.1, v.shape)).float()
        elif v.dim() == 1:
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape)).float()
        else:
            fan_in = np.prod(v.shape[1:])
            sd[k] = torch.from_numpy(rng.normal(
                0, np.sqrt(2 / fan_in), v.shape)).float()
    sd["fc.weight"] = torch.from_numpy(rng.normal(0, 0.01, (1000, 2048))
                                       ).float()
    sd["fc.bias"] = torch.zeros(1000)
    assert "layer1.0.bn1.IN.weight" in sd and "layer3.0.bn1.BN.running_var" \
        in sd and "layer4.0.bn1.running_var" in sd
    return sd


def _jax_embed_loaded(raw, x):
    """The JAX package's fit flow: a fresh model, the converted file grafted
    over its backbone; then ``embed``."""
    from centroids_reid_tpu.models import create_model as jcreate

    cfg = jax_default_cfg()
    cfg.MODEL.NAME = ARCH
    cfg.USE_MIXED_PRECISION = False
    model = jcreate(cfg)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    bb_params, bb_stats = convert_backbone_state_dict(raw)
    params = graft(v["params"], {"backbone": bb_params})
    stats = graft(v["batch_stats"], {"backbone": bb_stats})
    emb = jax.jit(lambda p, s, x: model.apply(
        {"params": p, "batch_stats": s}, x, method=model.embed))(
        params, stats, jnp.asarray(x))
    return np.asarray(emb), params, stats


def _port_embed_loaded(raw, x):
    """The port's fit flow (``build_model_and_state``): a fresh model, the
    converted file loaded key by key over its backbone; then ``embed``."""
    cfg = get_default_cfg()
    cfg.MODEL.NAME = ARCH
    cfg.USE_MIXED_PRECISION = False
    model = create_model(cfg, generator=torch.Generator().manual_seed(0))
    model.backbone.load_state_dict(backbone_state_dict(raw), strict=False)
    with torch.no_grad():
        return model.eval().embed(torch.from_numpy(x).permute(0, 3, 1, 2)
                                  ).numpy(), model


@pytest.mark.parametrize("layout", ["plain", "state_dict", "backbone.base."])
def test_ibn_backbone_file_converts_as_in_jax(layout):
    raw = _reference_file()
    if layout == "state_dict":
        raw = {"state_dict": raw}
    elif layout != "plain":
        raw = {layout + k: v for k, v in raw.items()}
    x = np.random.RandomState(4).randn(3, 64, 64, 3).astype(np.float32)
    ref, params, stats = _jax_embed_loaded(raw, x)
    got, model = _port_embed_loaded(raw, x)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * scale)
    # every trunk tensor of the file arrived, IN affine included, in both
    plain = _reference_file()
    loaded = model.backbone.state_dict()
    jax_trunk = from_jax_params(params["backbone"], stats["backbone"])
    for k, v in plain.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(loaded[k], v), k
        assert torch.equal(jax_trunk[k], v), k


def test_module_prefix_is_left_alone_by_both():
    raw = {"module." + k: v for k, v in _reference_file().items()}
    sd = backbone_state_dict(raw)
    assert all(k.startswith("module.") for k in sd)
    cfg = get_default_cfg()
    cfg.MODEL.NAME = ARCH
    model = create_model(cfg)
    before = {k: v.clone() for k, v in model.backbone.state_dict().items()}
    missing, unexpected = model.backbone.load_state_dict(sd, strict=False)
    assert sorted(unexpected) == sorted(sd)
    assert all(torch.equal(model.backbone.state_dict()[k], v)
               for k, v in before.items())
    params, stats = convert_backbone_state_dict(raw)
    assert list(params) == ["module"] and list(stats) == ["module"]
