"""The port's int8 PTQ embed on an IBN-a trunk against the JAX package's:
the InstanceNorm half of each IBN layer runs in the int8 domain after its
own requantization point (``.pre``). resnet50_ibn_a's widths with its
depth cut to one bottleneck per stage (layers 1-3 carry IBN, layer 4 plain
BN), 32x16 images. Tolerances as in test_torch_quantized.py."""

import pytest

from centroids_reid_tpu.models import resnet as JR
from centroids_reid_tpu_torch.models import resnet as TR
from test_torch_quantized import (
    build_models,
    check_calibration,
    check_folded_fp_embed,
    check_jax_artifact,
    check_unfused_bf16_engine,
)

_CUT = "resnet50_ibn_a_cut"


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JR, TR):
            mp.setitem(mod._ARCHS, _CUT, dict(
                block=mod.Bottleneck, layers=(1, 1, 1, 1), ibn=True,
                emb=2048))
        m = build_models(_CUT, tmp_path_factory.mktemp("int8_ibn"))
        assert any(k.endswith(".pre") for k in m["jq"].qtree["act_scales"])
        yield m


def test_folded_fp_embed_matches_jax(models):
    check_folded_fp_embed(models)


def test_jax_artifact_loads_into_the_port(models):
    check_jax_artifact(models)


def test_calibration_matches_jax(models):
    check_calibration(models)


def test_unfused_bf16_engine_matches_jax_default(models, tmp_path):
    check_unfused_bf16_engine(models, tmp_path)
