"""The CUDA kernels on the card, each against its plain version.

Needs an NVIDIA GPU and nvcc; every test skips without a GPU. This file
imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Integer-valued bf16 inputs make every dot product an exact fp32 integer,
so K1, K2, K2u and K4 must equal their plain versions bit for bit; K3 is
exact by construction; K5 and K6 accumulate exactly in int32 and round
their epilogue op by op, so they equal their plain versions bit for bit.
The evaluation metrics and the wide-row selection run on the card against
the same code on the CPU."""

import numpy as np
import pytest
import torch

from centroids_reid_tpu_torch.ops import int8_conv as C
from centroids_reid_tpu_torch.ops import retrieval as R
from centroids_reid_tpu_torch.ops import retrieval_int8 as R8

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, q=256, g=4096, d=64, real=4000, seed=4):
    rng = np.random.RandomState(seed)
    qf = rng.randint(-2, 3, (q, d)).astype(np.float32)
    gf = rng.randint(-2, 3, (g, d)).astype(np.float32)
    gn = (gf * gf).sum(axis=1)
    gn[real:] = np.inf
    return (torch.from_numpy(qf).to(cuda, torch.bfloat16),
            torch.from_numpy(gf).to(cuda, torch.bfloat16),
            torch.from_numpy(gn[None, :].astype(np.float32)).to(cuda))


# (Q, G, D): the persistent grids' geometry. G = 128 is fewer tiles than
# SMs; 4224 = 33 tiles; 25600 = 200 tiles do not divide evenly among 132
# (or, at Q = 256, 66) splits; Q = 256 is two query tiles; D = 32 and 96
# leave a ragged 64-deep stage that TMA fills with zeros.
GEOMETRY = [(256, 4096, 64), (256, 4224, 64), (128, 128, 64),
            (128, 25600, 32), (256, 25600, 96)]


def _real(g):
    return g - 96 if g > 256 else g - 28


@pytest.mark.parametrize("q,g,d", GEOMETRY)
def test_scores_kernel_exact(cuda, q, g, d):
    qf, gf, gn = _inputs(cuda, q=q, g=g, d=d, real=_real(g))
    R.reset_launch_counts()
    assert torch.equal(R.scores(qf, gf, gn), R.scores_plain(qf, gf, gn))
    torch.cuda.synchronize()
    assert R.LAUNCHES["scores"] == 1


@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("q,g,d", GEOMETRY)
def test_stream_topk_kernel_exact(cuda, k, q, g, d):
    qf, gf, gn = _inputs(cuda, q=q, g=g, d=d, real=_real(g))
    v, i = R.stream_topk(qf, gf, gn, k)
    rv, ri = R.stream_topk_plain(qf, gf, gn, k)
    assert torch.equal(i, ri) and torch.equal(v, rv)


@pytest.mark.parametrize("packed", [True, False])
def test_kernels_exact_at_serving_shape(cuda, packed):
    """[128, 2048] x [100352, 2048], 100,000 real rows: K1 and K2 (or K2u)
    at k = 10 and 32 equal their plain versions bit for bit."""
    qf, gf, gn = _inputs(cuda, q=128, g=100352, d=2048, real=100000, seed=7)
    if packed:
        assert torch.equal(R.scores(qf, gf, gn), R.scores_plain(qf, gf, gn))
    for k in (10, 32):
        v, i = R.stream_topk(qf, gf, gn, k, packed=packed)
        rv, ri = R.stream_topk_plain(qf, gf, gn, k, packed=packed)
        assert torch.equal(i, ri) and torch.equal(v, rv)


def test_stream_grid_fills_one_wave(cuda):
    """K2's grid from the card's SM count: one block per SM at most, and
    one partial list per query row and split."""
    from centroids_reid_tpu_torch.ops import _build

    sms = _build.load().crt_sm_count()
    assert sms == torch.cuda.get_device_properties(0).multi_processor_count
    assert R._stream_splits(128, 100352, sms) == min(sms, 784)
    assert R._stream_splits(256, 128, sms) == 1


def test_stream_topk_kernel_sparse_rows(cuda):
    """Fewer finite columns than k: the tail takes (+inf, column 0), as
    the TPU kernel's initial entries do."""
    q, g, gn = _inputs(cuda)
    gn[:] = float("inf")
    gn[0, 7:27:2] = 1.0
    v, i = R.stream_topk(q, g, gn, 32)
    rv, ri = R.stream_topk_plain(q, g, gn, 32)
    assert torch.equal(i, ri) and torch.equal(v, rv)


@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("q,g,d", GEOMETRY)
def test_stream_topk_unpacked_kernel_exact(cuda, k, q, g, d):
    """K2u: exact fp32 (score, column) order on integer inputs."""
    qf, gf, gn = _inputs(cuda, q=q, g=g, d=d, real=_real(g))
    R.reset_launch_counts()
    v, i = R.stream_topk(qf, gf, gn, k, packed=False)
    rv, ri = R.stream_topk_plain(qf, gf, gn, k, packed=False)
    assert torch.equal(i, ri) and torch.equal(v, rv)
    torch.cuda.synchronize()
    assert R.LAUNCHES["stream_topk_unpacked"] == 1
    assert R.LAUNCHES["stream_topk"] == 0


def test_stream_topk_unpacked_kernel_sparse_rows_and_signed_zero(cuda):
    """Fewer finite columns than k: the tail takes (+inf, column 0); a
    score of -0.0 ties with +0.0 and the column decides."""
    q, g, gn = _inputs(cuda)
    gn[:] = float("inf")
    gn[0, 7:27:2] = 1.0
    v, i = R.stream_topk(q, g, gn, 32, packed=False)
    rv, ri = R.stream_topk_plain(q, g, gn, 32, packed=False)
    assert torch.equal(i, ri) and torch.equal(v, rv)
    zq = torch.zeros_like(q)
    gz = torch.zeros_like(gn)
    gz[0, ::2] = -0.0
    v, i = R.stream_topk(zq, g, gz, 8, packed=False)
    assert torch.equal(i[0].cpu(), torch.arange(8))
    assert (v == 0).all()


def test_topk_retrieval_beyond_one_kpass_row_on_card(cuda):
    """k=5000 against 40,960 rows: the base case on K3, the final pass
    (40,000 columns) as a stable sort; equal to the CPU on integer rows."""
    rng = np.random.RandomState(12)
    qf = rng.randint(-6, 7, (5, 8)).astype(np.float32)
    gf = rng.randint(-6, 7, (40960, 8)).astype(np.float32)
    R.reset_launch_counts()
    d, i = R.topk_retrieval(torch.from_numpy(qf).to(cuda),
                            torch.from_numpy(gf).to(cuda), 5000)
    assert R.LAUNCHES["kpass_topk"] == 1
    rd, ri = R.topk_retrieval(torch.from_numpy(qf), torch.from_numpy(gf),
                              5000)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(d, rd)


def test_service_beyond_one_kpass_row_on_card(cuda):
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService
    from centroids_reid_tpu_torch.models import create_model

    torch.backends.cudnn.allow_tf32 = False
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = [64, 32]
    rng = np.random.RandomState(13)
    gallery = rng.randn(40960, 512).astype(np.float32)
    queries = rng.randint(0, 256, (3, 64, 32, 3)).astype(np.uint8)
    paths = [str(r) for r in range(40960)]
    svc = RetrievalService(cfg, gallery, paths, k=5000, model=create_model(cfg))
    d, i, _ = svc.query_arrays(queries)
    assert svc.device.type == "cuda" and d.shape == (3, 5000)
    assert (np.diff(d, axis=1) >= -1e-5).all()
    assert all(len(set(row)) == 5000 for row in i)


@pytest.mark.parametrize("respect", [False, True])
def test_eval_metrics_on_card_match_cpu(cuda, respect):
    """R1mAP with centroids on the card (distance matrix, stable argsort,
    mask algebra, bitmasks with cameras >= 32) against the CPU."""
    from centroids_reid_tpu_torch.metrics import R1mAP, build_centroid_eval_set

    rng = np.random.RandomState(14)
    emb = np.round(rng.randn(300, 16) * 2).astype(np.float32)
    pids = rng.randint(0, 20, 300)
    camids = rng.choice([0, 1, 2, 33, 40], 300)
    out = {}
    for dev in ("cpu", cuda):
        es = build_centroid_eval_set(torch.from_numpy(emb).to(dev), pids,
                                     camids, 60, respect)
        out[str(dev)] = R1mAP(60, feat_norm=False, device=dev).compute(
            es.embeddings, es.labels, es.camids, respect_camids=respect)
    c, g = out["cpu"], out[str(cuda)]
    np.testing.assert_array_equal(g.cmc, c.cmc)
    np.testing.assert_array_equal(g.all_topk, c.all_topk)
    assert abs(g.mAP - c.mAP) <= 1e-6


@pytest.mark.parametrize("w,k", [(100, 1), (1000, 32), (20000, 100),
                                 (32768, 1024)])
def test_kpass_topk_kernel_exact(cuda, w, k):
    rng = np.random.RandomState(w)
    x = np.round(rng.randn(37, w) * 2).astype(np.float32)   # many ties
    x[:, -min(300, w // 2):] = np.inf
    x[0, :] = 1.5
    xt = torch.from_numpy(x).to(cuda)
    v, i = R.kpass_topk(xt, k)
    rv, ri = R.kpass_topk_plain(xt, k)
    assert torch.equal(i, ri) and torch.equal(v, rv)


def test_hier_topk_on_kernels_matches_plain(cuda):
    """The hierarchical top-k on the card (K3 for the base case and the
    final pass) against the same glue on the CPU's plain versions."""
    rng = np.random.RandomState(9)
    x = np.round(rng.randn(16, 100352) * 4).astype(np.float32)
    x[:, 100000:] = np.inf
    for k in (10, 100):
        v, i = R._hier_topk_build(torch.from_numpy(x).to(cuda), k)
        rv, ri = R._hier_topk_build(torch.from_numpy(x), k)
        assert torch.equal(i.cpu(), ri) and torch.equal(v.cpu(), rv)


def test_wrappers_refuse_bad_inputs_on_cuda(cuda):
    q, g, gn = _inputs(cuda)
    with pytest.raises(TypeError):
        R.scores(q.float(), g, gn)
    with pytest.raises(ValueError, match="Q % 128"):
        R.scores(q[:100], g, gn)
    with pytest.raises(ValueError, match="contiguous"):
        R.kpass_topk(gn.expand(4, -1).t(), 4)
    with pytest.raises(ValueError, match="W <= 32768"):
        R.kpass_topk(torch.zeros((2, 40000), device=cuda), 4)
    # contiguous views that start off a 16-byte boundary
    q_off = torch.zeros(q.numel() + 1, dtype=q.dtype, device=cuda)[1:]
    gn_off = torch.zeros((1, gn.shape[1] + 4), device=cuda)[:, 1:-3]
    for args in ((q_off.view(q.shape), g, gn), (q, g, gn_off)):
        with pytest.raises(ValueError, match="16-byte"):
            R.scores(*args)
        with pytest.raises(ValueError, match="16-byte"):
            R.stream_topk(*args, 10)


@pytest.mark.parametrize("bf16,k", [(True, 5), (True, 40), (False, 40)])
def test_service_on_gpu_matches_cpu(cuda, bf16, k):
    """The whole service on the card (K2 at k=5, K1 + K3 at k=40, the fp32
    gallery on K3) against the same service on the CPU's plain versions:
    fp32 embed with TF32 off, so the embeddings agree to ~1e-6 and the
    rankings are equal."""
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService
    from centroids_reid_tpu_torch.models import create_model

    torch.backends.cudnn.allow_tf32 = False
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = [64, 32]
    rng = np.random.RandomState(11)
    gallery = rng.randn(3000, 512).astype(np.float32)
    queries = rng.randint(0, 256, (6, 64, 32, 3)).astype(np.uint8)
    paths = [str(i) for i in range(3000)]
    out = {}
    for dev in ("cpu", cuda):
        svc = RetrievalService(cfg, gallery, paths, k=k, use_bf16_kernel=bf16,
                               device=dev, model=create_model(cfg))
        out[str(dev)] = svc.query_arrays(queries)
    (dc, ic, _), (dg, ig, _) = out["cpu"], out[str(cuda)]
    np.testing.assert_array_equal(ig, ic)
    np.testing.assert_allclose(dg, dc, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------- int8 path ----

def _int8_gallery(cuda, g=4096, d=64, real=4000, seed=5):
    rng = np.random.RandomState(seed)
    gal = R8.quantize_gallery(
        torch.from_numpy(rng.randn(g, d).astype(np.float32)).to(cuda))
    gn = gal.gn.clone()
    gn[real:] = float("inf")
    return gal.codes, gal.scale[None, :].contiguous(), gn[None, :]


def test_scores_i8_kernel_matches_plain(cuda):
    """Integer-valued queries: exact; unit-scale random queries: fp32
    summation order (rtol 1e-5); +inf pad columns equal."""
    codes, s_row, gn = _int8_gallery(cuda)
    rng = np.random.RandomState(6)
    R8.reset_launch_counts()
    for q in (rng.randint(-3, 4, (256, 64)), rng.randn(256, 64)):
        qf = torch.from_numpy(q.astype(np.float32)).to(cuda, torch.bfloat16)
        got = R8.scores_i8(qf, codes, s_row, gn)
        ref = R8.scores_i8_plain(qf, codes, s_row, gn)
        assert torch.equal(torch.isinf(got), torch.isinf(ref))
        fin = torch.isfinite(ref)
        torch.testing.assert_close(got[fin], ref[fin], rtol=1e-5, atol=1e-5)
        if q.dtype.kind == "i":
            assert torch.equal(got, ref)
    torch.cuda.synchronize()
    assert R8.LAUNCHES["scores_i8"] == 2


@pytest.mark.parametrize("k,exact", [(10, True), (100, True), (10, False)])
def test_int8_retrieval_on_card_matches_cpu(cuda, k, exact):
    """topk_retrieval_int8 on K4 + K3 against the same glue on the CPU's
    plain versions: equal indices, distances to fp32 summation order."""
    rng = np.random.RandomState(12)
    qf = rng.randn(7, 64).astype(np.float32)
    gf = rng.randn(20000, 64).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        g = torch.from_numpy(gf).to(dev)
        out[str(dev)] = R8.topk_retrieval_int8(
            torch.from_numpy(qf).to(dev), R8.quantize_gallery(g),
            g if exact else None, k)
    (dc, ic), (dg, ig) = out["cpu"], out[str(cuda)]
    np.testing.assert_array_equal(ig, ic)
    np.testing.assert_allclose(dg, dc, rtol=1e-5, atol=1e-5)


def _requant_inputs(cuda, m, k, n, with_res, seed, res_shape=None):
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a).to(cuda)

    x = t(rng.randint(-127, 128, (m, k)).astype(np.int8))
    w = t(rng.randint(-127, 128, (k, n)).astype(np.int8))
    scale = t(rng.uniform(0.0002, 0.002, n).astype(np.float32))
    bias = t(rng.uniform(-20, 20, n).astype(np.float32))
    res = (t(rng.randint(-127, 128, res_shape or (m, n)).astype(np.int8))
           if with_res else None)
    rs = torch.tensor(0.37, device=cuda) if with_res else None
    return x, w, scale, bias, res, rs


@pytest.mark.parametrize("m,k,n", [(16384, 64, 256), (1000, 256, 64),
                                   (300, 1024, 128)])
@pytest.mark.parametrize("relu,with_res", [(True, True), (True, False),
                                           (False, False)])
def test_matmul_requant_kernel_exact(cuda, m, k, n, relu, with_res):
    """K5 equals its plain version bit for bit, ragged M included."""
    x, w, scale, bias, res, rs = _requant_inputs(cuda, m, k, n, with_res, m)
    C.reset_launch_counts()
    got = C.matmul_requant(x, w, scale, bias, res=res, res_scale=rs,
                           relu=relu)
    ref = C.matmul_requant_plain(x, w, scale, bias, res=res, res_scale=rs,
                                 relu=relu)
    assert torch.equal(got, ref)
    assert C.LAUNCHES["matmul_requant"] == 1


@pytest.mark.parametrize("b,h,w,k,n", [(8, 64, 32, 64, 64),
                                       (8, 16, 8, 512, 512),
                                       (3, 7, 5, 64, 128)])
@pytest.mark.parametrize("with_res", [True, False])
def test_conv3x3_requant_kernel_exact(cuda, b, h, w, k, n, with_res):
    """K6 equals its plain version bit for bit: zero padding at every
    image border, tiles that span images, ragged M."""
    x, wt, scale, bias, res, rs = _requant_inputs(
        cuda, b * h * w, 9 * k, n, with_res, b * h + k,
        res_shape=(b, h, w, n))
    x = x[:, :k].reshape(b, h, w, k).contiguous()
    wt = wt.reshape(3, 3, k, n)
    got = C.conv3x3_requant(x, wt, scale, bias, res_nhwc=res, res_scale=rs)
    ref = C.conv3x3_requant_plain(x, wt, scale, bias, res_nhwc=res,
                                  res_scale=rs)
    assert torch.equal(got, ref)


# (M, K, N, residual, ReLU): the 16 K5 shapes of one ResNet-50 embed call
# at 8 images of 256x128 (36 launches)
K5_EMBED = [
    (16384, 64, 64, False, True), (16384, 64, 256, False, False),
    (16384, 64, 256, True, True), (16384, 256, 64, False, True),
    (16384, 256, 128, False, True), (4096, 128, 512, True, True),
    (4096, 256, 512, False, False), (4096, 512, 128, False, True),
    (4096, 512, 256, False, True), (1024, 256, 1024, True, True),
    (1024, 512, 1024, False, False), (1024, 1024, 256, False, True),
    (1024, 1024, 512, False, True), (1024, 512, 2048, True, True),
    (1024, 1024, 2048, False, False), (1024, 2048, 512, False, True),
]
# (B, H, W, K -> N = K): the 4 K6 shapes of the same call (14 launches)
K6_EMBED = [(8, 64, 32, 64), (8, 32, 16, 128), (8, 16, 8, 256),
            (8, 16, 8, 512)]


def _k5(cuda, m, k, n, with_res, relu, seed, **kw):
    """K5 and its plain version on one seeded input."""
    x, w, scale, bias, res, rs = _requant_inputs(cuda, m, k, n, with_res,
                                                 seed)
    got = C.matmul_requant(x, w, scale, bias, res=res, res_scale=rs,
                           relu=relu, **kw)
    ref = C.matmul_requant_plain(x, w, scale, bias, res=res, res_scale=rs,
                                 relu=relu)
    return got, ref


def _k6(cuda, b, h, w, k, n, with_res, relu, seed, **kw):
    x, wt, scale, bias, res, rs = _requant_inputs(
        cuda, b * h * w, 9 * k, n, with_res, seed, res_shape=(b, h, w, n))
    x = x[:, :k].reshape(b, h, w, k).contiguous()
    wt = wt.reshape(3, 3, k, n)
    got = C.conv3x3_requant(x, wt, scale, bias, res_nhwc=res, res_scale=rs,
                            relu=relu, **kw)
    ref = C.conv3x3_requant_plain(x, wt, scale, bias, res_nhwc=res,
                                  res_scale=rs, relu=relu)
    return got, ref


@pytest.mark.parametrize("m,k,n,with_res,relu", K5_EMBED + [
    (524288, 64, 256, True, True),     # batch 256: layer 1's conv3
])
def test_matmul_requant_embed_shapes_exact(cuda, m, k, n, with_res, relu):
    """K5 at every shape of a batch-8 embed call and one of batch 256, with
    the plan's tile width and splits: bit for bit."""
    C.reset_launch_counts()
    got, ref = _k5(cuda, m, k, n, with_res, relu, k + n)
    assert torch.equal(got, ref)
    assert C.LAUNCHES["matmul_requant"] == 1


@pytest.mark.parametrize("b,h,w,k", K6_EMBED + [(256, 16, 8, 512)])
def test_conv3x3_requant_embed_shapes_exact(cuda, b, h, w, k):
    """K6 at every shape of a batch-8 embed call (ReLU, no residual, as
    the trunk runs it) and one of batch 256: bit for bit."""
    C.reset_launch_counts()
    got, ref = _k6(cuda, b, h, w, k, k, False, True, b + k)
    assert torch.equal(got, ref)
    assert C.LAUNCHES["conv3x3_requant"] == 1


def _forced_splits(monkeypatch, splits):
    """Run the wrappers at a given split count, or the most the launch
    takes ("max"; at most that count otherwise), with the plan's tile
    width."""
    plan = C._requant_plan

    def forced(m, n, stages, sms):
        bn, _ = plan(m, n, stages, sms)
        cap = C._max_splits(bn, stages)
        return bn, cap if splits == "max" else min(splits, cap)
    monkeypatch.setattr(C, "_requant_plan", forced)


@pytest.mark.parametrize("splits", [1, 2, 4, "max"])
@pytest.mark.parametrize("m,k,n", [(1000, 192, 128), (300, 320, 64),
                                   (1024, 1024, 256), (16384, 256, 256),
                                   (2000, 64, 128)])
def test_matmul_requant_split_k_exact(cuda, monkeypatch, splits, m, k, n):
    """K5 at 1, 2, 4 and the most splits a cluster takes: K = 64 x 3 and
    64 x 5 leave a ragged last 128-deep stage; ragged M; 64- and 128-wide
    tiles (16- to 128-column epilogue slices); each pipeline (64-deep
    stages at K = 64, 128-deep ones at one and at two blocks per SM)."""
    _forced_splits(monkeypatch, splits)
    for with_res, relu in ((True, True), (False, False)):
        got, ref = _k5(cuda, m, k, n, with_res, relu, m + k + n)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("splits", [1, 2, "max"])
@pytest.mark.parametrize("b,h,w,k,n", [(3, 7, 5, 64, 128), (2, 5, 9, 128, 64),
                                       (3, 7, 5, 192, 128),
                                       (8, 16, 8, 256, 256),
                                       (2, 16, 8, 64, 128)])
def test_conv3x3_requant_split_k_exact(cuda, monkeypatch, splits, b, h, w, k,
                                       n):
    """K6 at 1, 2 and the most splits (9 taps x 1 stage leave a ragged
    chunk at 2): tiles that span images and W that does not divide the
    tile (the 2D map and the padding in shared memory), and whole image
    rows (the 4D map: [8,16,8] and [2,16,8])."""
    _forced_splits(monkeypatch, splits)
    for with_res, relu in ((True, True), (False, False), (True, False)):
        got, ref = _k6(cuda, b, h, w, k, n, with_res, relu, b * h * w + k)
        assert torch.equal(got, ref)


def test_requant_split_k_leaves_no_state(cuda):
    """The same split launches twice, with other launches on other tile
    grids between: identical outputs, each equal to the plain version."""
    x, w, scale, bias, res, rs = _requant_inputs(cuda, 1024, 1024, 256, True,
                                                 5)
    ref = C.matmul_requant_plain(x, w, scale, bias, res=res, res_scale=rs)
    first = C.matmul_requant(x, w, scale, bias, res=res, res_scale=rs)
    got6, ref6 = _k6(cuda, 8, 16, 8, 512, 512, False, True, 6)
    got5, ref5 = _k5(cuda, 300, 320, 64, False, True, 7)
    again = C.matmul_requant(x, w, scale, bias, res=res, res_scale=rs)
    torch.cuda.synchronize()
    assert torch.equal(first, ref) and torch.equal(again, first)
    assert torch.equal(got6, ref6) and torch.equal(got5, ref5)


def test_requant_kernels_take_packed_weights(cuda):
    """A packed weight passed in gives the result of the HWIO one."""
    x, w, scale, bias, res, rs = _requant_inputs(cuda, 1000, 9 * 128, 64,
                                                 True, 8, (2, 5, 100, 64))
    x = x[:, :128].reshape(2, 5, 100, 128).contiguous()
    w = w.reshape(3, 3, 128, 64)
    got = C.conv3x3_requant(x, w, scale, bias, res_nhwc=res, res_scale=rs,
                            w_packed=C.pack_weight(w))
    assert torch.equal(got, C.conv3x3_requant_plain(
        x, w, scale, bias, res_nhwc=res, res_scale=rs))


def test_int8_wrappers_refuse_bad_inputs_on_cuda(cuda):
    x, w, scale, bias, res, rs = _requant_inputs(cuda, 256, 128, 128, True, 1)
    with pytest.raises(TypeError):
        C.matmul_requant(x.float(), w, scale, bias)
    with pytest.raises(TypeError):
        C.matmul_requant(x, w, scale.double(), bias)
    with pytest.raises(ValueError, match="K % 64"):
        C.matmul_requant(x[:, :96].contiguous(), w[:96].contiguous(), scale,
                         bias)
    with pytest.raises(ValueError, match="N % 64"):
        C.matmul_requant(x, w[:, :96].contiguous(), scale[:96].contiguous(),
                         bias[:96].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        C.matmul_requant(x.t().contiguous().t(), w, scale, bias)
    with pytest.raises(ValueError, match="res needs res_scale"):
        C.matmul_requant(x, w, scale, bias, res=res)
    with pytest.raises(ValueError, match="NHWC"):
        C.conv3x3_requant(x.reshape(2, 8, 16, 128), w, scale, bias)
    x_off = torch.zeros(x.numel() + 1, dtype=torch.int8, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        C.matmul_requant(x_off.view(x.shape), w, scale, bias)
    wide = torch.zeros((128, 256), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="w_packed must be int8"):
        C.matmul_requant(x, w, scale, bias, w_packed=wide)
    with pytest.raises(ValueError, match="w_packed must be int8"):
        C.matmul_requant(x, w, scale, bias, w_packed=wide.view(torch.uint8))
    with pytest.raises(ValueError, match="w_packed must be contiguous"):
        C.matmul_requant(x, w, scale, bias, w_packed=wide[:, :128])
    with pytest.raises(ValueError, match="w_packed must be int8"):
        C.conv3x3_requant(x.reshape(2, 8, 16, 128),
                          w.repeat(9, 1).reshape(3, 3, 128, 128), scale,
                          bias, w_packed=C.pack_weight(w))
    with pytest.raises(ValueError, match="different devices"):
        C.matmul_requant(x, w, scale, bias, w_packed=C.pack_weight(w).cpu())
    codes, s_row, gn = _int8_gallery(cuda)
    q = torch.zeros((128, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        R8.scores_i8(q.float(), codes, s_row, gn)
    with pytest.raises(ValueError, match="Q % 128"):
        R8.scores_i8(q[:100], codes, s_row, gn)
    gn_off = torch.zeros((1, gn.shape[1] + 4), device=cuda)[:, 1:-3]
    with pytest.raises(ValueError, match="16-byte"):
        R8.scores_i8(q, codes, s_row, gn_off)


def test_int8_service_on_gpu_matches_cpu(cuda):
    """int8 serving on the card (K5 / K6 embed, K4 + K3 selection) against
    the same service on the CPU's plain versions, from one artifact:
    equal indices, close distances."""
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService
    from centroids_reid_tpu_torch.models import create_model
    from centroids_reid_tpu_torch.models.quantized import quantize_reid_model

    torch.backends.cudnn.allow_tf32 = False
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = [64, 32]
    rng = np.random.RandomState(13)
    gallery = rng.randn(3000, 512).astype(np.float32)
    queries = rng.randint(0, 256, (6, 64, 32, 3)).astype(np.uint8)
    paths = [str(i) for i in range(3000)]
    model = create_model(cfg)
    qfn = quantize_reid_model(model, [queries], cfg.INPUT.PIXEL_MEAN,
                              cfg.INPUT.PIXEL_STD, use_pallas=True,
                              acc_dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda):
        svc = RetrievalService(cfg, gallery, paths, k=10, device=dev,
                               model=model, int8_qfn=qfn,
                               use_int8_gallery=True)
        out[str(dev)] = svc.query_arrays(queries)
    (dc, ic, _), (dg, ig, _) = out["cpu"], out[str(cuda)]
    np.testing.assert_array_equal(ig, ic)
    np.testing.assert_allclose(dg, dc, rtol=1e-4, atol=1e-4)


# --------------------------------------------------- K3 radix select ----

def _assert_kpass_exact(xt, k):
    """Indices equal, values bit-equal, NaN equal to NaN."""
    v, i = R.kpass_topk(xt, k)
    rv, ri = R.kpass_topk_plain(xt, k)
    assert torch.equal(i, ri)
    nan = torch.isnan(rv)
    assert torch.equal(torch.isnan(v), nan)
    assert torch.equal(v[~nan], rv[~nan])


# k = W; k = 1 and k > 4096 at W = 32768; W off a multiple of 4 or 32;
# every (W, k) the serving, int8 and CLI paths launch
KPASS_CASES = [(1000, 1000), (33, 33), (32768, 1), (32768, 4097),
               (32768, 32768), (1001, 100), (12547, 100), (77, 5),
               (12544, 100), (800, 100), (12544, 26), (208, 26),
               (12544, 125), (1000, 125)]


@pytest.mark.parametrize("w,k", KPASS_CASES)
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_kpass_topk_radix_exact(cuda, w, k, kind):
    rng = np.random.RandomState(w + k)
    x = rng.randn(128 if w <= 12547 else 9, w).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 2)
        x[:, -min(300, w // 2):] = np.inf
    x[0, :] = 1.5                      # a row of one repeated value
    x[1, :] = np.inf                   # a row of +inf but for a few
    x[1, ::max(1, w // 7)] = -1.0
    R.reset_launch_counts()
    _assert_kpass_exact(torch.from_numpy(x).to(cuda), k)
    torch.cuda.synchronize()
    assert R.LAUNCHES["kpass_topk"] == 1


@pytest.mark.parametrize("w,k", [(800, 100), (12544, 100), (1001, 26),
                                 (32768, 4097)])
def test_kpass_topk_radix_nan_rows(cuda, w, k):
    """NaNs order after +inf in column order, as torch.sort does: rows of
    fewer than k non-NaN values return the NaNs with their own columns."""
    rng = np.random.RandomState(3 * w + k)
    x = rng.randn(6, w).astype(np.float32)
    x[0, :] = np.nan                   # all NaN
    x[1, k // 2:] = np.nan             # fewer than k numbers
    x[2, ::3] = np.nan                 # NaNs among the numbers
    x[3, :] = np.inf
    x[3, 1::2] = np.nan                # +inf and NaN interleaved
    x[4, : k // 3] = -np.inf
    _assert_kpass_exact(torch.from_numpy(x).to(cuda), k)


# ------------------------------------------------- K4 on the TMA ring ----

# (Q, G, D) over K4's 256 x 128 output tiles: D = 32 and 96 leave a ragged
# 64-deep stage; G = 128 is one half-empty tile; 133 and 266 tiles leave
# the 132-block grid a ragged last wave; Q = 256 is two query tiles; G %
# 256 == 128 leaves the last gallery tile half empty
K4_GEOMETRY = [(128, 128, 32), (128, 34048, 96), (256, 33920, 64),
               (128, 4096, 2048), (256, 128, 96)]


@pytest.mark.parametrize("q,g,d", K4_GEOMETRY)
def test_scores_i8_tma_kernel_matches_plain(cuda, q, g, d):
    """Integer queries exact (any scale); unit rows within fp32 summation
    order (rtol 1e-5); +inf pad columns equal."""
    codes, s_row, gn = _int8_gallery(cuda, g=g, d=d, real=g - 28, seed=g + d)
    rng = np.random.RandomState(q + d)
    unit = rng.randn(q, d)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    R8.reset_launch_counts()
    for qv in (rng.randint(-3, 4, (q, d)), unit):
        qf = torch.from_numpy(qv.astype(np.float32)).to(cuda, torch.bfloat16)
        got = R8.scores_i8(qf, codes, s_row, gn)
        ref = R8.scores_i8_plain(qf, codes, s_row, gn)
        assert torch.equal(torch.isinf(got), torch.isinf(ref))
        fin = torch.isfinite(ref)
        if qv.dtype.kind == "i":
            assert torch.equal(got, ref)
        else:
            torch.testing.assert_close(got[fin], ref[fin], rtol=1e-5,
                                       atol=1e-5)
    torch.cuda.synchronize()
    assert R8.LAUNCHES["scores_i8"] == 2


def test_scores_i8_tma_kernel_full_code_range(cuda):
    """Every code in [-127, 127] widens exactly: codes drawn over the whole
    range, integer queries, unit scales, exact."""
    rng = np.random.RandomState(21)
    codes = torch.from_numpy(
        rng.randint(-127, 128, (1024, 256)).astype(np.int8)).to(cuda)
    codes[0, :255] = torch.arange(-127, 128, dtype=torch.int8)
    s_row = torch.ones((1, 1024), device=cuda)
    gn = torch.zeros((1, 1024), device=cuda)
    qf = torch.from_numpy(rng.randint(-2, 3, (128, 256)).astype(np.float32)
                          ).to(cuda, torch.bfloat16)
    assert torch.equal(R8.scores_i8(qf, codes, s_row, gn),
                       R8.scores_i8_plain(qf, codes, s_row, gn))


# ------------------------------------------------------------ training
# The training slice launches no hand-written kernel: these hold its
# PyTorch code on the card against the same code on the CPU.

def test_apply_augment_on_gpu_equals_cpu(cuda):
    """The same draws (made on the CPU) applied on the card and on the CPU:
    equal, mocks zero; the card's own draws stay within their ranges."""
    from centroids_reid_tpu_torch.data import transforms as T

    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.randint(0, 256, (64, 256, 128, 3)).astype(
        np.uint8))
    is_real = torch.from_numpy(rng.rand(64) > 0.2)
    params = T.draw_augment_params(64, torch.Generator().manual_seed(1),
                                   (256, 128), 10, 0.5, 0.5)
    ref = T.apply_augment(imgs, is_real, params, 10, mean, std)
    got = T.apply_augment(imgs.to(cuda), is_real.to(cuda),
                          T.AugmentParams(*(p.to(cuda) for p in params)), 10,
                          mean, std)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-6)
    assert not got[~is_real.to(cuda)].any()
    own = T.draw_augment_params(
        64, torch.Generator(device=cuda).manual_seed(1), (256, 128), 10, 0.5,
        0.5)
    assert all(p.device.type == "cuda" for p in own)
    y0, x0, eh, ew = own.rect.unbind(1)
    assert ((y0 + eh <= 256) & (x0 + ew <= 128)).all()
    assert own.offset.min() >= 0 and own.offset.max() <= 20


def test_masked_bnneck_on_gpu_equals_cpu(cuda):
    from centroids_reid_tpu_torch.engine.steps import masked_bnneck

    rng = np.random.RandomState(2)
    arrays = [rng.randn(256, 2048).astype(np.float32) * 2 + 1,
              rng.rand(256) > 0.1, rng.uniform(0.5, 1.5, 2048),
              rng.normal(0, 0.1, 2048), rng.normal(0, 1, 2048),
              rng.uniform(0.5, 2, 2048)]
    outs = []
    for dev in ("cpu", cuda):
        t = [torch.from_numpy(np.asarray(a)).to(dev) for a in arrays]
        t = [x.float() if x.dtype == torch.float64 else x for x in t]
        feat = t[0].requires_grad_(True)
        out, (mean, var) = masked_bnneck(feat, *t[1:])
        (out * out).sum().backward()
        outs.append([x.detach().cpu() for x in (out, feat.grad, mean, var)])
    for got, ref in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_train_step_on_gpu_equals_cpu(cuda):
    """One resnet18 ctl step (32 images at 64x32, one mock) from one state
    on the card and on the CPU, fp32 with TF32 off: every metric to rtol
    1e-4, every gradient to a relative L2 error of 1e-4, the BNNeck
    running statistics to 1e-5."""
    import copy

    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.engine.state import create_train_state
    from centroids_reid_tpu_torch.engine.steps import make_train_step
    from centroids_reid_tpu_torch.models import create_model

    torch.backends.cudnn.allow_tf32 = False
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.USE_MIXED_PRECISION = False
    cfg.SOLVER.IMS_PER_BATCH, cfg.DATALOADER.NUM_INSTANCE = 8, 4
    model = create_model(cfg, num_classes=10,
                         generator=torch.Generator().manual_seed(0))
    base = create_train_state(cfg, model, 10, torch.Generator().manual_seed(1))
    rng = np.random.RandomState(3)
    imgs = rng.randn(32, 64, 32, 3).astype(np.float32)
    labels = np.repeat(rng.choice(10, 8, replace=False), 4)
    is_real = np.ones(32, bool)
    is_real[7] = False
    imgs[7] = 0
    results = []
    for dev in ("cpu", cuda):
        m = copy.deepcopy(model).to(dev, memory_format=torch.channels_last)
        state = create_train_state(cfg, m, 10, torch.Generator())
        with torch.no_grad():
            state.centers.copy_(base.centers)
        step = make_train_step(state, cfg, 10, "ctl")
        metrics = step(torch.from_numpy(imgs).to(dev),
                       torch.from_numpy(labels).to(dev),
                       torch.from_numpy(is_real).to(dev))
        grads = {n: p.grad.detach().cpu() for n, p in m.named_parameters()
                 if p.grad is not None}
        grads["centers"] = state.centers.grad.cpu()
        results.append((metrics, grads, m.bn.running_mean.cpu(),
                        m.bn.running_var.cpu()))
    (m_cpu, g_cpu, rm_cpu, rv_cpu), (m_gpu, g_gpu, rm_gpu, rv_gpu) = results
    for name in m_cpu:
        torch.testing.assert_close(m_gpu[name].cpu(), m_cpu[name], rtol=1e-4,
                                   atol=1e-7)
    assert g_cpu.keys() == g_gpu.keys()
    for name in g_cpu:
        err = (g_gpu[name] - g_cpu[name]).norm() / g_cpu[name].norm()
        assert err <= 1e-4, (name, float(err))
    torch.testing.assert_close(rm_gpu, rm_cpu, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rv_gpu, rv_cpu, rtol=1e-5, atol=1e-5)
