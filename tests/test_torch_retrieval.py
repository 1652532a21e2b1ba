"""The port's retrieval ops (centroids_reid_tpu_torch/ops/retrieval.py)
against the JAX package's Pallas kernels run in interpret mode on the CPU.

Inputs are made with numpy and handed to both. Tolerances: integer-valued
inputs make every dot product an exact fp32 integer, so those comparisons
are exact whatever the summation order; random inputs differ only by fp32
summation order (rtol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroids_reid_tpu.ops import retrieval as J
from centroids_reid_tpu_torch.ops import retrieval as R
from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts
from centroids_reid_tpu_torch.ops import retrieval_int8 as R8


def _int_inputs(rng, q, g, d, lo=-2, hi=3):
    return (rng.randint(lo, hi, (q, d)).astype(np.float32),
            rng.randint(lo, hi, (g, d)).astype(np.float32))


def _gn(gf, real):
    gn = (gf * gf).sum(axis=1).astype(np.float32)
    gn[real:] = np.inf
    return gn[None, :]


def _jbf(x):
    return jnp.asarray(x, jnp.bfloat16)


def _tbf(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("kind", ["integer", "random"])
def test_scores_plain_matches_pallas_interpret(kind):
    """K1: gn - 2 q.g^T at Qp=128, Gp=2048, D=64, with +inf pad columns."""
    rng = np.random.RandomState(0)
    if kind == "integer":
        qf, gf = _int_inputs(rng, 128, 2048, 64)
    else:
        qf = rng.randn(128, 64).astype(np.float32)
        gf = rng.randn(2048, 64).astype(np.float32)
    gn = _gn(gf, 2000)
    ref = np.asarray(J._scores_pallas_maybe_interpret(
        _jbf(qf), _jbf(gf), jnp.asarray(gn), interpret=True))
    got = R.scores(_tbf(qf), _tbf(gf), torch.from_numpy(gn)).numpy()
    if kind == "integer":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("finite", ["pads", "sparse"])
def test_stream_topk_plain_matches_packed_merge_interpret(k, finite):
    """K2: (bf16 score, column) order with heavy ties and +inf pad columns;
    values at bf16 resolution. Exact on integer inputs. "sparse" leaves 10
    finite columns, so at k > 10 the TPU kernel's initial (+inf, column 0)
    entries fill the tail of every row."""
    rng = np.random.RandomState(1)
    qf, gf = _int_inputs(rng, 128, 2048, 64)
    gn = _gn(gf, 1900)
    if finite == "sparse":
        gn[:] = np.inf
        gn[0, 5:25:2] = 1.0
    val, idx = J._topk_pallas(_jbf(qf), _jbf(gf), jnp.asarray(gn), k,
                              interpret=True, packed=True)
    v, i = R.stream_topk(_tbf(qf), _tbf(gf), torch.from_numpy(gn), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(v.numpy(), np.asarray(val))


@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("finite", ["pads", "sparse"])
def test_stream_topk_unpacked_matches_merge_interpret(k, finite):
    """K2u: the exact fp32 (score, column) order with heavy ties and +inf
    pad columns, against the TPU kernel's unpacked merge; values and
    indices exact on integer inputs. "sparse" leaves 10 finite columns:
    at k > 10 the +inf tail is a stated divergence. The port's +inf slots
    take column 0 (the initial entries); the TPU kernel repeats the column
    of the row's minimum over its first gallery tile, because its merge
    leaves each taken entry in the buffer at +inf. Values agree there."""
    rng = np.random.RandomState(1)
    qf, gf = _int_inputs(rng, 128, 2048, 64)
    gn = _gn(gf, 1900)
    if finite == "sparse":
        gn[:] = np.inf
        gn[0, 5:25:2] = 1.0
    val, idx = J._topk_pallas(_jbf(qf), _jbf(gf), jnp.asarray(gn), k,
                              interpret=True, packed=False)
    v, i = R.stream_topk(_tbf(qf), _tbf(gf), torch.from_numpy(gn), k,
                         packed=False)
    val, idx, v, i = np.asarray(val), np.asarray(idx), v.numpy(), i.numpy()
    np.testing.assert_array_equal(v, val)
    fin = np.isfinite(val)
    np.testing.assert_array_equal(i[fin], idx[fin])
    assert (i[~fin] == 0).all()
    assert fin.all() == (finite == "pads" or k <= 10)


def test_stream_topk_unpacked_random_matches_merge_interpret():
    """K2u on random bf16 inputs: the same indices, values within fp32
    summation order (rtol 1e-5, atol 1e-5, as for K1)."""
    rng = np.random.RandomState(8)
    qf = rng.randn(128, 64).astype(np.float32)
    gf = rng.randn(2048, 64).astype(np.float32)
    gn = _gn(gf, 2000)
    for k in (1, 10, 32):
        val, idx = J._topk_pallas(_jbf(qf), _jbf(gf), jnp.asarray(gn), k,
                                  interpret=True, packed=False)
        v, i = R.stream_topk(_tbf(qf), _tbf(gf), torch.from_numpy(gn), k,
                             packed=False)
        np.testing.assert_array_equal(i.numpy(), np.asarray(idx))
        np.testing.assert_allclose(v.numpy(), np.asarray(val), rtol=1e-5,
                                   atol=1e-5)


def test_kpass_topk_plain_matches_vmem_topk_interpret():
    """K3: the cases of test_ops::test_vmem_topk_interpret_matches_lax_topk
    (tie row, duplicated value, +inf columns, ragged shapes); values and
    indices exact."""
    rng = np.random.RandomState(7)
    for q, w in ((3, 100), (17, 1000), (9, 128)):
        x = rng.randn(q, w).astype(np.float32)
        x[0, :] = 2.0
        if w > 10:
            x[-1, -7:] = np.inf
            x[1, 5] = x[1, 3]
        for k in (1, 4, 32):
            k_eff = min(k, w)
            rv, ri = J._vmem_topk(jnp.asarray(x), k_eff, interpret=True)
            v, i = R.kpass_topk(torch.from_numpy(x), k_eff)
            np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
            np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def _selection_inputs(dtype):
    """G > 16384, so the hierarchical top-k runs one group-min level."""
    rng = np.random.RandomState(2)
    if dtype == "bf16":
        qf, gf = _int_inputs(rng, 128, 17408, 32, lo=-3, hi=4)
    else:
        qf = rng.randn(128, 32).astype(np.float32)
        gf = rng.randn(17408, 32).astype(np.float32)
    return qf, gf, _gn(gf, 17000)


@pytest.mark.parametrize("dtype,k", [("bf16", 10), ("bf16", 100),
                                     ("fp32", 10), ("fp32", 100)])
def test_topk_select_matches_jax(dtype, k):
    """Indices exact on every branch; values exact at bf16 resolution for
    K2 (k <= 32) and to fp32 summation order elsewhere."""
    qf, gf, gn = _selection_inputs(dtype)
    if dtype == "bf16":
        jq, jg, tq, tg = _jbf(qf), _jbf(gf), _tbf(qf), _tbf(gf)
    else:
        jq, jg = jnp.asarray(qf), jnp.asarray(gf)
        tq, tg = torch.from_numpy(qf), torch.from_numpy(gf)
    rv, ri = J.topk_select(jq, jg, jnp.asarray(gn), k, interpret=True)
    v, i = R.topk_select(tq, tg, torch.from_numpy(gn), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,k,dist", [
    ("bf16", 10, "euclidean"), ("bf16", 100, "euclidean"),
    ("fp32", 100, "euclidean"), ("fp32", 10, "cosine"),
])
def test_topk_retrieval_matches_jax(dtype, k, dist):
    """Final distances (re-scored, ||q||^2 added or mapped to |1 - cos|)
    within fp32 summation order; indices exact. Q=7 and G=17000 exercise
    the query and gallery padding."""
    rng = np.random.RandomState(3)
    qf = rng.randn(7, 32).astype(np.float32)
    gf = rng.randn(17000, 32).astype(np.float32)
    if dtype == "bf16":
        qf, gf = (np.round(qf * 2), np.round(gf * 2))
        jq, jg, tq, tg = _jbf(qf), _jbf(gf), _tbf(qf), _tbf(gf)
    else:
        jq, jg = jnp.asarray(qf), jnp.asarray(gf)
        tq, tg = torch.from_numpy(qf), torch.from_numpy(gf)
    rd, ri = J.topk_retrieval(jq, jg, k, dist=dist, use_pallas=True,
                              interpret=True)
    d, i = R.topk_retrieval(tq, tg, k, dist=dist)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("g,k", [(40000, 5000), (32769, 4097),
                                 (32768, 4097), (32769, 4096)])
def test_topk_retrieval_refuses_k_beyond_one_kpass_row(g, k):
    """k > 4096 against more than 32768 gallery rows is answered, as the
    reference answers it: a base case or final pass wider than one K3 row
    (32768 columns) takes a stable sort, the reference's ``lax.top_k``
    there. Integer-valued fp32 rows make every distance an exact integer
    (many ties), so indices and distances must equal the JAX package's
    fp32 path exactly, ties broken by the same positions."""
    rng = np.random.RandomState(5)
    qf = rng.randint(-6, 7, (3, 8)).astype(np.float32)
    gf = rng.randint(-6, 7, (g, 8)).astype(np.float32)
    rd, ri = J.topk_retrieval(jnp.asarray(qf), jnp.asarray(gf), k,
                              use_pallas=False)
    reset_launch_counts()
    d, i = R.topk_retrieval(torch.from_numpy(qf), torch.from_numpy(gf), k)
    assert launch_counts()["kpass_topk"] == 0   # the CPU launches no kernel
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(d, rd)
    assert len(set(i[0])) == k


def test_score_input_checks_refuse_misaligned_views():
    """The kernels read q, g and gn_row with 16-byte loads: a contiguous
    view that starts off a 16-byte boundary is refused before a launch."""
    q = torch.zeros((128, 32), dtype=torch.bfloat16)
    g = torch.zeros((1024, 32), dtype=torch.bfloat16)
    gn = torch.zeros((1, 1024))
    assert R._check_score_inputs(q, g, gn) == (128, 1024, 32)
    q_off = torch.zeros(128 * 32 + 1, dtype=torch.bfloat16)[1:].view(128, 32)
    gn_off = torch.zeros((1, 1028))[:, 1:1025]
    for args in ((q_off, g, gn), (q, g, gn_off)):
        assert all(t.is_contiguous() for t in args)
        with pytest.raises(ValueError, match="16-byte"):
            R._check_score_inputs(*args)


def test_wrappers_take_plain_path_only_on_cpu():
    """A CPU tensor runs the plain version and launches nothing; a tensor
    on another non-CUDA device, or on mixed devices, raises."""
    reset_launch_counts()
    q = torch.zeros((128, 32), dtype=torch.bfloat16)
    g = torch.zeros((1024, 32), dtype=torch.bfloat16)
    gn = torch.zeros((1, 1024))
    R.scores(q, g, gn)
    R.stream_topk(q, g, gn, 4)
    R.stream_topk(q, g, gn, 4, packed=False)
    R.kpass_topk(gn, 4)
    assert not any(launch_counts().values())
    with pytest.raises(ValueError, match="no CUDA kernel"):
        R.kpass_topk(gn.to("meta"), 4)
    with pytest.raises(ValueError, match="different devices"):
        R.scores(q, g.to("meta"), gn)
    for packed in (True, False):
        with pytest.raises(ValueError, match="1 <= k <= 32"):
            R.stream_topk(q, g, gn, 33, packed=packed)


def test_scores_plain_matches_pallas_interpret_d96():
    """K1 at D = 96, a depth that leaves the card kernel a ragged 64-deep
    stage: the plain version equals the TPU kernel in interpret mode on
    integer inputs, +inf pad columns included."""
    rng = np.random.RandomState(10)
    qf, gf = _int_inputs(rng, 128, 2048, 96)
    gn = _gn(gf, 2000)
    ref = np.asarray(J._scores_pallas_maybe_interpret(
        _jbf(qf), _jbf(gf), jnp.asarray(gn), interpret=True))
    got = R.scores(_tbf(qf), _tbf(gf), torch.from_numpy(gn)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_stream_topk_plain_matches_pallas_interpret_d96(k, packed):
    """K2 (packed) and K2u at D = 96 against the TPU kernel in interpret
    mode: values and indices exact on integer inputs (heavy ties)."""
    rng = np.random.RandomState(11)
    qf, gf = _int_inputs(rng, 128, 2048, 96)
    gn = _gn(gf, 1900)
    val, idx = J._topk_pallas(_jbf(qf), _jbf(gf), jnp.asarray(gn), k,
                              interpret=True, packed=packed)
    v, i = R.stream_topk(_tbf(qf), _tbf(gf), torch.from_numpy(gn), k,
                         packed=packed)
    np.testing.assert_array_equal(i.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(v.numpy(), np.asarray(val))


@pytest.mark.parametrize("q,g,sms,want", [
    (128, 100352, 132, 132),     # the serving shape: one block per SM
    (128, 128, 132, 1),          # fewer gallery tiles than SMs
    (128, 4224, 132, 33),
    (256, 25600, 132, 66),       # two query tiles share the SMs
    (128 * 200, 1024, 132, 1),   # more query tiles than SMs
])
def test_stream_splits_fill_one_wave(q, g, sms, want):
    """K2's persistent grid: splits x query tiles fill at most one wave of
    blocks, and every split holds at least one 128-row gallery tile."""
    n = R._stream_splits(q, g, sms)
    assert n == want
    assert 1 <= n <= g // 128
    assert n * (q // 128) <= max(sms, q // 128)


@pytest.mark.parametrize("q,g,d", [(100, 1024, 32), (128, 1000, 32),
                                   (128, 1024, 48)])
def test_score_input_checks_refuse_off_tile_shapes(q, g, d):
    """The kernels' tile contract (Q % 128, G % 128, D % 32) is refused
    before a launch, as it was before the kernels' redesign."""
    with pytest.raises(ValueError, match="Q % 128 == 0, G % 128 == 0"):
        R._check_score_inputs(torch.zeros((q, d), dtype=torch.bfloat16),
                              torch.zeros((g, d), dtype=torch.bfloat16),
                              torch.zeros((1, g)))


@pytest.mark.parametrize("w,k", [(1, 1), (208, 26), (800, 100), (1000, 125),
                                 (4095, 4095), (12544, 100), (32768, 1),
                                 (32768, 4097), (32768, 32768)])
def test_kpass_plan_fits_one_block(w, k):
    """K3's launch plan at the paths' shapes and the contract's corners:
    whole warps, a power-of-two sort of at least k entries, and shared
    memory for the row, the histograms or the sort (where k <= threads,
    the histograms' room holds the k 8-byte entries that are ranked),
    within one block's limit on sm_90."""
    threads, n_sort, smem = R._kpass_plan(w, k)
    assert threads % 32 == 0 and 256 <= threads <= 1024
    assert n_sort >= k and n_sort & (n_sort - 1) == 0 and n_sort < 2 * k
    assert smem >= 4 * w + max(threads // 32 * 1024, 2 * n_sort)
    assert k > threads or threads // 32 * 1024 >= 8 * k
    assert smem <= 232448   # a block's dynamic shared memory on sm_90


def test_kpass_topk_plain_orders_nan_last():
    """K3's plain version, which the card kernel equals: NaNs sort after
    +inf, each with its own column, ties to the lower column. (The TPU
    kernel's ``jnp.min`` propagates NaN instead: a stated divergence.)"""
    x = torch.tensor([[3.0, float("nan"), float("inf"), 1.0, float("nan"),
                       1.0, -0.0, 0.0]])
    v, i = R.kpass_topk(x, 8)
    assert i.tolist() == [[6, 7, 3, 5, 0, 2, 1, 4]]
    assert torch.isnan(v[0, 6:]).all() and v[0, 5] == float("inf")


@pytest.mark.parametrize("q,g,sms,want", [
    (128, 100352, 132, 132),   # the serving shape: 392 tiles, 2.97 a block
    (128, 128, 132, 1),        # G = 128: one half-empty tile
    (128, 34048, 132, 132),    # 133 tiles: a ragged last wave
    (256, 33920, 132, 132),    # two query tiles, a half-empty column
    (128, 12800, 132, 50),     # 50 tiles
])
def test_scores_i8_grid_fills_one_wave(q, g, sms, want):
    """K4's persistent grid over its 256 x 128 output tiles: one block per
    SM at most and never more blocks than tiles."""
    assert R8._scores_i8_blocks(q, g, sms) == want
