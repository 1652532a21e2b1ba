"""The port's int8 gallery index (centroids_reid_tpu_torch/ops/
retrieval_int8.py) against the JAX package's, whose score kernel runs in
interpret mode on the CPU.

Inputs are made with numpy and handed to both. Tolerances: quantization is
elementwise IEEE arithmetic, so codes and scales are equal; gn and random
scores differ only by fp32 summation order (rtol 1e-6 / 1e-5); integer
inputs make every dot product an exact fp32 integer, so those scores are
equal. Selection indices are equal; distances are exact fp32 re-scores of
the same rows, which differ only by summation order (1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroids_reid_tpu.ops import retrieval_int8 as J
from centroids_reid_tpu_torch.ops import retrieval_int8 as R


def _gallery(seed, g, d):
    rng = np.random.RandomState(seed)
    gf = rng.randn(g, d).astype(np.float32)
    gf[3] = 0.0                       # an all-zero row: scale floor 1e-30
    gf[5, :4] = [2.54, -2.54, 1.27, 0.5 * 2.54 / 127]  # exact .5 codes
    return gf


def _jgal(gal):
    return J.Int8Gallery(codes=jnp.asarray(gal.codes.numpy()),
                         scale=jnp.asarray(gal.scale.numpy()),
                         gn=jnp.asarray(gal.gn.numpy()))


def test_quantize_gallery_matches_jax():
    gf = _gallery(0, 300, 64)
    ref = J.quantize_gallery(gf)
    got = R.quantize_gallery(torch.from_numpy(gf))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(ref.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_allclose(got.gn.numpy(), np.asarray(ref.gn), rtol=1e-6)
    assert got.codes.dtype == torch.int8 and got.num_rows == 300


@pytest.mark.parametrize("kind", ["integer", "random"])
def test_scores_i8_plain_matches_pallas_interpret(kind):
    """K4: gn - 2 s (q.q8^T) at Qp=128, Gp=1024, D=64, +inf pad columns."""
    rng = np.random.RandomState(1)
    if kind == "integer":
        qf = rng.randint(-3, 4, (128, 64)).astype(np.float32)
    else:
        qf = rng.randn(128, 64).astype(np.float32)
    gal = R.quantize_gallery(torch.from_numpy(_gallery(2, 1024, 64)))
    gn = gal.gn.clone()
    gn[1000:] = float("inf")
    s_row, gn_row = gal.scale[None, :], gn[None, :]
    ref = np.asarray(J._scores_pallas_i8(
        jnp.asarray(qf, jnp.bfloat16), jnp.asarray(gal.codes.numpy()),
        jnp.asarray(s_row.numpy()), jnp.asarray(gn_row.numpy()),
        interpret=True))
    got = R.scores_i8(torch.from_numpy(qf).to(torch.bfloat16), gal.codes,
                      s_row, gn_row).numpy()
    if kind == "integer":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["exact", "capacity"])
@pytest.mark.parametrize("k", [5, 40])
def test_topk_select_int8_matches_jax(mode, k):
    """G = 17408 > 16384, so the hierarchical top-k runs one group-min
    level; k=40 selects 56 candidates, k=5 selects 21."""
    rng = np.random.RandomState(3)
    qf = rng.randn(128, 32).astype(np.float32)
    gf = rng.randn(17408, 32).astype(np.float32)
    gal = R.quantize_gallery(torch.from_numpy(gf))
    gf32 = torch.from_numpy(gf) if mode == "exact" else None
    rv, ri = J.topk_select_int8(
        jnp.asarray(qf), _jgal(gal), None if gf32 is None else jnp.asarray(gf),
        k, use_pallas=True, interpret=True)
    v, i = R.topk_select_int8(torch.from_numpy(qf), gal, gf32, k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode,dist", [("exact", "euclidean"),
                                       ("exact", "cosine"),
                                       ("capacity", "euclidean"),
                                       ("capacity", "cosine")])
def test_topk_retrieval_int8_matches_jax(mode, dist):
    """Q=7 and G=3000 exercise the query and gallery padding (to 128 and
    3072 rows); cosine quantizes the normalised rows, as the reference
    documents."""
    rng = np.random.RandomState(4)
    qf = rng.randn(7, 32).astype(np.float32)
    gf = rng.randn(3000, 32).astype(np.float32)
    if dist == "cosine":
        gf = gf / np.linalg.norm(gf, axis=1, keepdims=True)
    jgal = J.quantize_gallery(gf)
    gal = R.quantize_gallery(torch.from_numpy(gf))
    exact = mode == "exact"
    rd, ri = J.topk_retrieval_int8(qf, jgal, gf if exact else None, 10,
                                   dist=dist, use_pallas=True, interpret=True)
    d, i = R.topk_retrieval_int8(torch.from_numpy(qf), gal,
                                 torch.from_numpy(gf) if exact else None, 10,
                                 dist=dist)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1e-5)


def test_gallery_padding_never_selected():
    """1500 rows pad to 2048 with +inf gn; none surfaces even at k=50."""
    rng = np.random.RandomState(5)
    qf = torch.from_numpy(rng.randn(128, 32).astype(np.float32))
    gf = torch.from_numpy(rng.randn(1500, 32).astype(np.float32))
    for gf32 in (gf, None):
        _, idx = R.topk_retrieval_int8(qf, R.quantize_gallery(gf), gf32, 50)
        assert (idx < 1500).all()


def test_tiny_gallery_wide_k_matches_jax():
    """g=60 < the default margin of k=50 and far below the 1024 pad: the
    margin clamps to 60, so indices are 50 distinct real rows, equal to the
    JAX package's and to an exact fp32 full sort."""
    rng = np.random.RandomState(7)
    qf = rng.randn(128, 32).astype(np.float32)
    gf = rng.randn(60, 32).astype(np.float32)
    rd, ri = J.topk_retrieval_int8(qf, J.quantize_gallery(gf), gf, 50,
                                   use_pallas=True, interpret=True)
    d, i = R.topk_retrieval_int8(torch.from_numpy(qf),
                                 R.quantize_gallery(torch.from_numpy(gf)),
                                 torch.from_numpy(gf), 50)
    assert all(len(set(row)) == 50 for row in i.tolist())
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1e-5)
    full = ((qf[:, None, :] - gf[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(i, np.argsort(full, axis=1,
                                                kind="stable")[:, :50])


def test_scores_i8_takes_plain_path_only_on_cpu():
    """A CPU tensor runs the plain version and launches nothing; a tensor
    on another non-CUDA device, or on mixed devices, raises."""
    R.reset_launch_counts()
    q = torch.zeros((128, 32), dtype=torch.bfloat16)
    codes = torch.zeros((1024, 32), dtype=torch.int8)
    row = torch.ones((1, 1024))
    R.scores_i8(q, codes, row, row)
    assert R.LAUNCHES == {"scores_i8": 0}
    with pytest.raises(ValueError, match="no retrieval kernel"):
        R.scores_i8(q.to("meta"), codes.to("meta"), row.to("meta"),
                    row.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        R.scores_i8(q, codes.to("meta"), row, row)


def test_margin_beyond_one_kpass_row_is_refused():
    """A margin above 4096 against more than 32768 rows would need K3 over
    a row wider than 32768 columns: refused before any scoring."""
    gal = R.Int8Gallery(torch.zeros((33792, 4), dtype=torch.int8),
                        torch.ones(33792), torch.zeros(33792))
    with pytest.raises(NotImplementedError, match="k=4097"):
        R.topk_select_int8(torch.zeros((128, 4)), gal, None, 4, sel=4097)
