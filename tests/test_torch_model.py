"""The port's model (centroids_reid_tpu_torch/models) against the JAX
package's ``ReidModel.embed`` on the same weights.

Weights cross with ``from_jax_params`` (test_torch_convert.py covers the
reference-format loaders). Both packages run in fp32 on
the CPU, so embeddings differ only by conv/reduction order: rtol 1e-4 and
an absolute floor of 1e-4 of the embedding scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroids_reid_tpu.models import baseline as JB
from centroids_reid_tpu.models import resnet as JR
from centroids_reid_tpu_torch.models import ReidModel, from_jax_params
from centroids_reid_tpu_torch.models import resnet as TR
from torch_oracle import randomize_params, randomize_stats

# depth cut to one block per stage, widths as published
_TEST_ARCHS = {
    "t_bottleneck": ("Bottleneck", False, 2048),
    "t_ibn": ("Bottleneck", True, 2048),
    "t_basic": ("BasicBlock", False, 512),
}


@pytest.fixture(autouse=True)
def small_archs(monkeypatch):
    for name, (block, ibn, emb) in _TEST_ARCHS.items():
        for mod in (JR, TR):
            monkeypatch.setitem(mod._ARCHS, name, dict(
                block=getattr(mod, block), layers=(1, 1, 1, 1), ibn=ibn,
                emb=emb))


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


def _jax_embed(model, params, stats, x):
    fn = jax.jit(lambda p, s, x: model.apply(
        {"params": p, "batch_stats": s}, x, method=model.embed))
    return np.asarray(fn(params, stats, jnp.asarray(x)))


def _jax_model(name, seed=0):
    model = JB.ReidModel(backbone_name=name, last_stride=1)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 32, 3)))
    params, stats = v["params"], v["batch_stats"]
    params = randomize_params(jax.tree.map(np.asarray, params), seed)
    stats = randomize_stats(jax.tree.map(np.asarray, stats), seed + 1)
    return model, params, stats


def _port_model(name, sd, mixed_precision=False):
    model = ReidModel(name, last_stride=1, mixed_precision=mixed_precision)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert unexpected == []
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return model.eval()


def _x(n=3, seed=5):
    return np.random.RandomState(seed).randn(n, 64, 32, 3).astype(np.float32)


@pytest.mark.parametrize("name", sorted(_TEST_ARCHS))
def test_embed_matches_jax_fp32(name):
    """Bottleneck, IBN-a (IN/BN split, stem ReLU) and BasicBlock trunks,
    last stride 1, 64x32 input, randomised weights and BN statistics."""
    jmodel, params, stats = _jax_model(name)
    x = _x()
    ref = _jax_embed(jmodel, params, stats, x)
    model = _port_model(name, from_jax_params(params, stats))
    with torch.no_grad():
        got = model.embed(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)


def test_embed_mixed_precision_near_fp32():
    """bf16 autocast trunk, fp32 output: each embedding points the same
    way as the fp32 one (cosine > 0.999; bf16 keeps ~3 digits)."""
    _, params, stats = _jax_model("t_bottleneck")
    sd = from_jax_params(params, stats)
    x = torch.from_numpy(_x()).permute(0, 3, 1, 2)
    with torch.no_grad():
        e32 = _port_model("t_bottleneck", sd).embed(x)
        e16 = _port_model("t_bottleneck", sd, mixed_precision=True).embed(x)
    assert e16.dtype == torch.float32
    cos = torch.nn.functional.cosine_similarity(e16, e32, dim=1)
    assert (cos > 0.999).all(), cos
