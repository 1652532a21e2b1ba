"""The port's int8 PTQ embed (centroids_reid_tpu_torch/models/quantized.py)
against the JAX package's on the same weights (resnet18 here, IBN-a in
test_torch_quantized_ibn.py; 32x16 images), with the JAX fused kernels in
interpret mode.

Tolerances:
* the folded fp32 embed differs from the JAX one only by conv and
  reduction order: rtol 1e-4, absolute floor 1e-4 of the embedding scale;
* on one artifact the int8 engines agree in every integer accumulator.
  They differ where XLA's CPU compiler fuses the reference's
  ``acc * scale + bias`` into one multiply-add (one rounding instead of
  two), which moves an activation by one quantum where it sits on a
  rounding boundary: embeddings within rtol 1e-3 of the embedding scale,
  cosine > 0.99999 (bf16 accumulators: see the test);
* calibration observes fp32 activations that differ by summation order:
  act scales rtol 1e-5. Scales that differ in the seventh digit move
  boundary values by one quantum at every requantization point, so two
  independently calibrated embeds agree to cosine > 0.999."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroids_reid_tpu.models import baseline as JB
from centroids_reid_tpu.models import quantized as JQ
from centroids_reid_tpu.models.convert import convert_full_state_dict
from centroids_reid_tpu_torch.models import ReidModel
from centroids_reid_tpu_torch.models import quantized as TQ
from centroids_reid_tpu_torch.models.resnet import random_init_

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
HW = (32, 16)


def imgs(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, *HW, 3), np.uint8)


def _random_port_model(name, seed=0):
    """The reference random init, then every norm's affine parameters and
    running statistics drawn at random, so folding has work to do."""
    port = ReidModel(name, last_stride=1)
    random_init_(port, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed + 1)
    with torch.no_grad():
        for mod in port.modules():
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d,
                                torch.nn.InstanceNorm2d)):
                n = mod.weight.shape[0]
                mod.weight.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, n).astype(np.float32)))
                mod.bias.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, n).astype(np.float32)))
            if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                mod.running_mean.copy_(torch.from_numpy(
                    rng.normal(0, 0.1, n).astype(np.float32)))
                mod.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, n).astype(np.float32)))
    return port.eval()


def build_models(name, tmp_dir):
    """One set of weights in both packages (carried to JAX by its own
    reference-checkpoint converter), plus a JAX int8 artifact on the fused
    kernels (int32 accumulators) and its embeddings of 3 images."""
    port = _random_port_model(name)
    trees = convert_full_state_dict(port.state_dict())
    model = JB.ReidModel(backbone_name=name, last_stride=1)
    params, stats = trees["params"], trees["batch_stats"]
    calib = [imgs(4, 1)]
    jq = JQ.quantize_reid_model(model, params, stats, calib, MEAN, STD,
                                use_pallas=True, acc_dtype=jnp.int32)
    path = str(tmp_dir / "jax_int8.npz")
    jq.save(path, extra_meta={"origin": "jax"})
    queries = imgs(3, 2)
    return dict(name=name, jax=(model, params, stats), port=port,
                calib=calib, jq=jq, jax_path=path, queries=queries,
                jax_emb=np.asarray(jq(jnp.asarray(queries))))


def _cos(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def _close(got, ref, rtol):
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def check_folded_fp_embed(m):
    x = imgs(4, 0)
    ref = np.asarray(JQ.folded_fp_embed(*m["jax"], MEAN, STD)(jnp.asarray(x)))
    _close(TQ.folded_fp_embed(m["port"], MEAN, STD)(x).numpy(), ref, 1e-4)


def check_jax_artifact(m):
    tq = TQ.QuantizedEmbed.load(m["jax_path"])
    assert tq.extra_meta == {"origin": "jax"}
    assert tq._use_pallas is True and tq._acc_dtype == torch.int32
    got = tq(m["queries"]).numpy()
    assert _cos(got, m["jax_emb"]).min() > 0.99999
    _close(got, m["jax_emb"], 1e-3)


def check_calibration(m):
    """The port folds, calibrates and quantizes its own model on the JAX
    artifact's calibration batch."""
    tq = TQ.quantize_reid_model(m["port"], m["calib"], MEAN, STD,
                                use_pallas=True, acc_dtype=torch.int32)
    ref = m["jq"].qtree["act_scales"]
    got = tq.qtree["act_scales"]
    assert sorted(got) == sorted(ref)
    np.testing.assert_allclose([float(got[k]) for k in sorted(got)],
                               [float(ref[k]) for k in sorted(ref)],
                               rtol=1e-5)
    emb = tq(m["queries"]).numpy()
    assert _cos(emb, m["jax_emb"]).min() > 0.999
    fp = TQ.folded_fp_embed(m["port"], MEAN, STD)(m["queries"]).numpy()
    assert _cos(emb, fp).min() > 0.99


def check_unfused_bf16_engine(m, tmp_dir):
    """The reference's default engine (``use_pallas=False``, bf16
    accumulators, every conv unfused) on one artifact in both packages.

    XLA's CPU compiler drops the reference's round trip of the accumulator
    through bf16 (it allows excess precision), so the JAX engine computes
    with exact accumulators here; the port rounds them to bf16, as the
    engine asks, which moves values by up to half a bf16 step (2^-9
    relative) before requantization: cosine > 0.998. With the exact
    accumulators of the JAX program the port agrees to cosine > 0.99999."""
    jq = JQ.quantize_reid_model(*m["jax"], m["calib"], MEAN, STD)
    path = str(tmp_dir / "jax_int8_bf16.npz")
    jq.save(path)
    tq = TQ.QuantizedEmbed.load(path)
    assert tq._use_pallas is False and tq._acc_dtype == torch.bfloat16
    ref = np.asarray(jq(jnp.asarray(m["queries"])))
    assert _cos(tq(m["queries"]).numpy(), ref).min() > 0.998
    tq._acc_dtype = torch.int32
    assert _cos(tq(m["queries"]).numpy(), ref).min() > 0.99999


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return build_models("resnet18", tmp_path_factory.mktemp("int8"))


def test_folded_fp_embed_matches_jax(models):
    check_folded_fp_embed(models)


def test_jax_artifact_loads_into_the_port(models):
    check_jax_artifact(models)


def test_calibration_matches_jax(models):
    check_calibration(models)


def test_unfused_bf16_engine_matches_jax_default(models, tmp_path):
    check_unfused_bf16_engine(models, tmp_path)


def test_percentile_calibration_matches_jax(models):
    """``calib_percentile`` < 100: the percentile over the strided
    subsample (torch.quantile's linear rule, jnp.percentile's default)."""
    fold = JQ.fold_backbone(*models["jax"], MEAN, STD)
    ref = JQ.calibrate(fold, models["calib"], 99.5)
    got = TQ.calibrate(TQ.fold_backbone(models["port"], MEAN, STD),
                       models["calib"], 99.5)
    assert sorted(got) == sorted(ref)
    np.testing.assert_allclose([got[k] for k in sorted(got)],
                               [ref[k] for k in sorted(ref)], rtol=1e-5)


def test_port_artifact_loads_into_jax(models, tmp_path):
    """The port saves, JAX loads the same arrays, plan and options and
    embeds as the port does; the port reloads its own artifact bit for
    bit."""
    tq = TQ.quantize_reid_model(models["port"], models["calib"], MEAN, STD,
                                use_pallas="large", acc_dtype=torch.int32)
    path = str(tmp_path / "port.npz")
    tq.save(path, extra_meta={"origin": "port"})
    jq = JQ.QuantizedEmbed.load(path)
    assert jq.extra_meta == {"origin": "port"}
    assert jq._static["plan"] == TQ._block_plan("resnet18", 1)
    assert jq._use_pallas == "large" and jq._acc_dtype == jnp.int32
    np.testing.assert_array_equal(
        np.asarray(jq.qtree["blocks"][0]["conv1"]["w"]),
        tq.qtree["blocks"][0]["conv1"]["w"].numpy())
    got = tq(models["queries"]).numpy()
    ref = np.asarray(jq(jnp.asarray(models["queries"])))
    assert _cos(got, ref).min() > 0.99999
    again = TQ.QuantizedEmbed.load(path)
    np.testing.assert_array_equal(again(models["queries"]).numpy(), got)


@pytest.mark.parametrize("use_pallas,fused", [
    (True, {"matmul_requant": 3, "conv3x3_requant": 14}),
    ("large", {"matmul_requant": 0, "conv3x3_requant": 0}),
    (False, {"matmul_requant": 0, "conv3x3_requant": 0}),
])
def test_int8_engine_routes_convs(models, monkeypatch, use_pallas, fused):
    """resnet18 at last stride 1 has 20 convs: the 7x7 stem and 2 stride-2
    3x3 convs (unfused), 3 1x1 downsample convs (K5; two of stride 2, after
    a row slice) and 14 stride-1 3x3 convs (K6). ``"large"`` fuses only
    feature maps of >= 2048 pixels, which 32x16 images never reach."""
    from centroids_reid_tpu_torch.ops import int8_conv

    calls = dict.fromkeys(fused, 0)

    def counted(name):
        real = getattr(int8_conv, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return wrapper

    for name in fused:
        monkeypatch.setattr(int8_conv, name, counted(name))
    tq = TQ.QuantizedEmbed.load(models["jax_path"])
    tq._use_pallas = use_pallas
    tq(models["queries"])
    assert calls == fused


def test_int8_domain_instance_norm_matches_jax():
    """The int8-domain InstanceNorm identity, near-constant inputs included
    (where the eps / s^2 term dominates)."""
    rng = np.random.RandomState(11)
    half = 8
    in_scale = (rng.randn(half) * 0.5 + 1.0).astype(np.float32)
    in_bias = (rng.randn(half) * 0.1).astype(np.float32)
    for z in (rng.randint(-127, 128, (2, 7, 5, half)).astype(np.int8),
              (rng.randint(0, 2, (2, 7, 5, half)) + 3).astype(np.int8)):
        for s in (0.004, 1.0, 37.5):
            ref = np.asarray(JQ._instance_norm_int8_domain(
                jnp.asarray(z), jnp.float32(s), jnp.asarray(in_scale),
                jnp.asarray(in_bias)))
            got = TQ._instance_norm_int8_domain(
                torch.from_numpy(z), torch.tensor(s, dtype=torch.float32),
                torch.from_numpy(in_scale), torch.from_numpy(in_bias))
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                       atol=1e-5)


def test_calibration_requires_batches(models):
    with pytest.raises(ValueError, match="calibration"):
        TQ.quantize_reid_model(models["port"], [], MEAN, STD)
