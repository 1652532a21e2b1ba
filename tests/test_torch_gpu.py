"""The CUDA kernels on the card, each against its plain version.

Needs an NVIDIA GPU and nvcc; every test skips without a GPU. This file
imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Integer-valued bf16 inputs make every dot product an exact fp32 integer,
so K1, K2, K2u and K4 must equal their plain versions bit for bit; K3 is
exact by construction; K5 and K6 accumulate exactly in int32 and round
their epilogue op by op, so they equal their plain versions bit for bit;
K7's fp32 euclidean distances of integer rows are exact, so its extracted
distances and ranks equal its plain versions' bit for bit; K8's residual
sum equals PyTorch's add bit for bit, and its LayerNorm, whose statistics
are summed in another order, lies within one bf16 ulp of the eager ops.
The evaluation metrics and the wide-row selection run on the card against
the same code on the CPU, the serving artifacts against the live path."""

import numpy as np
import pytest
import torch

from centroids_reid_tpu_torch.ops import int8_conv as C
from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts
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
    reset_launch_counts()
    assert torch.equal(R.scores(qf, gf, gn), R.scores_plain(qf, gf, gn))
    torch.cuda.synchronize()
    assert launch_counts()["scores"] == 1


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
    assert _build.sm_count(torch.cuda.current_device()) == sms
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
    reset_launch_counts()
    v, i = R.stream_topk(qf, gf, gn, k, packed=False)
    rv, ri = R.stream_topk_plain(qf, gf, gn, k, packed=False)
    assert torch.equal(i, ri) and torch.equal(v, rv)
    torch.cuda.synchronize()
    assert launch_counts()["stream_topk_unpacked"] == 1
    assert launch_counts()["stream_topk"] == 0


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
    reset_launch_counts()
    d, i = R.topk_retrieval(torch.from_numpy(qf).to(cuda),
                            torch.from_numpy(gf).to(cuda), 5000)
    assert launch_counts()["kpass_topk"] == 1
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
    reset_launch_counts()
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
    assert launch_counts()["scores_i8"] == 2


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
    reset_launch_counts()
    got = C.matmul_requant(x, w, scale, bias, res=res, res_scale=rs,
                           relu=relu)
    ref = C.matmul_requant_plain(x, w, scale, bias, res=res, res_scale=rs,
                                 relu=relu)
    assert torch.equal(got, ref)
    assert launch_counts()["matmul_requant"] == 1


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
    reset_launch_counts()
    got, ref = _k5(cuda, m, k, n, with_res, relu, k + n)
    assert torch.equal(got, ref)
    assert launch_counts()["matmul_requant"] == 1


@pytest.mark.parametrize("b,h,w,k", K6_EMBED + [(256, 16, 8, 512)])
def test_conv3x3_requant_embed_shapes_exact(cuda, b, h, w, k):
    """K6 at every shape of a batch-8 embed call (ReLU, no residual, as
    the trunk runs it) and one of batch 256: bit for bit."""
    reset_launch_counts()
    got, ref = _k6(cuda, b, h, w, k, k, False, True, b + k)
    assert torch.equal(got, ref)
    assert launch_counts()["conv3x3_requant"] == 1


# (M, K, N, residual, ReLU): the 10 K5 shapes of one ResNet50-IBN-a embed
# call at 8 images of 320x320 (23 launches; the IBN conv1s of layers 1-3
# run unfused): feature maps of 80x80, 40x40 and 20x20
K5_IBN320 = [
    (51200, 64, 256, False, False), (51200, 64, 256, True, True),
    (12800, 256, 512, False, False), (12800, 128, 512, True, True),
    (3200, 512, 1024, False, False), (3200, 256, 1024, True, True),
    (3200, 1024, 512, False, True), (3200, 1024, 2048, False, False),
    (3200, 512, 2048, True, True), (3200, 2048, 512, False, True),
]
# (B, H, W, K -> N = K): its 4 K6 shapes (14 launches); no width divides
# the kernel's 128-row tile, so every one loads rows through the 2D map
# and zeroes the padding rows in shared memory
K6_IBN320 = [(8, 80, 80, 64), (8, 40, 40, 128), (8, 20, 20, 256),
             (8, 20, 20, 512)]


@pytest.mark.parametrize("m,k,n,with_res,relu", K5_IBN320 + [
    (1638400, 64, 256, True, True),    # batch 256: layer 1's conv3
])
def test_matmul_requant_ibn320_shapes_exact(cuda, m, k, n, with_res, relu):
    """K5 at every shape of a batch-8 IBN-a 320x320 embed call and one of
    batch 256: bit for bit."""
    reset_launch_counts()
    got, ref = _k5(cuda, m, k, n, with_res, relu, k + n + 1)
    assert torch.equal(got, ref)
    assert launch_counts()["matmul_requant"] == 1


@pytest.mark.parametrize("b,h,w,k", K6_IBN320 + [(256, 80, 80, 64)])
def test_conv3x3_requant_ibn320_shapes_exact(cuda, b, h, w, k):
    """K6 at every shape of a batch-8 IBN-a 320x320 embed call (ReLU, no
    residual) and layer 1's at batch 256: bit for bit."""
    reset_launch_counts()
    got, ref = _k6(cuda, b, h, w, k, k, False, True, b + h + k)
    assert torch.equal(got, ref)
    assert launch_counts()["conv3x3_requant"] == 1


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
    reset_launch_counts()
    _assert_kpass_exact(torch.from_numpy(x).to(cuda), k)
    torch.cuda.synchronize()
    assert launch_counts()["kpass_topk"] == 1


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
    reset_launch_counts()
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
    assert launch_counts()["scores_i8"] == 2


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


def _step_on_gpu_and_cpu(cuda, groups: int, dtype, tol: float):
    """One resnet18 ctl step of ``groups`` groups of 32 images at 64x32
    (one mock a group) from one state on the card and on the CPU, in
    ``dtype`` (TF32 off): every metric to rtol ``tol``, every gradient to a
    relative L2 error of ``tol``, the BNNeck and trunk running statistics
    to ``tol / 10``."""
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
    cfg.TPU.NUM_GROUPS = groups
    model = create_model(cfg, num_classes=10,
                         generator=torch.Generator().manual_seed(0))
    base = create_train_state(cfg, model, 10, torch.Generator().manual_seed(1))
    rng = np.random.RandomState(3)
    imgs = rng.randn(groups, 32, 64, 32, 3)
    labels = np.stack([np.repeat(rng.choice(10, 8, replace=False), 4)
                       for _ in range(groups)])
    is_real = np.ones((groups, 32), bool)
    is_real[:, 7] = False
    imgs[:, 7] = 0
    results = []
    for dev in ("cpu", cuda):
        m = copy.deepcopy(model).to(dev, dtype,
                                    memory_format=torch.channels_last)
        state = create_train_state(cfg, m, 10, torch.Generator())
        with torch.no_grad():
            state.centers.copy_(base.centers)
        step = make_train_step(state, cfg, 10, "ctl")
        metrics = step(torch.from_numpy(imgs).to(dev, dtype),
                       torch.from_numpy(labels).to(dev),
                       torch.from_numpy(is_real).to(dev))
        grads = {n: p.grad.detach().cpu() for n, p in m.named_parameters()
                 if p.grad is not None}
        grads["centers"] = state.centers.grad.cpu()
        stats = {k: v.cpu() for k, v in m.state_dict().items()
                 if "running" in k}
        results.append((metrics, grads, stats))
    (m_cpu, g_cpu, s_cpu), (m_gpu, g_gpu, s_gpu) = results
    bad = [f"metric {n}: {float(m_gpu[n].cpu())} vs {float(m_cpu[n])}"
           for n in m_cpu if not torch.allclose(
               m_gpu[n].cpu(), m_cpu[n], rtol=tol, atol=1e-7 * tol / 1e-4)]
    assert g_cpu.keys() == g_gpu.keys()
    errs = {n: float((g_gpu[n] - g_cpu[n]).norm() / g_cpu[n].norm())
            for n in g_cpu}
    bad += [f"gradient {n}: {e:.3e}" for n, e in errs.items() if e > tol]
    assert s_cpu.keys() == s_gpu.keys()
    bad += [f"statistic {n}: {float((s_gpu[n] - s_cpu[n]).abs().max()):.3e}"
            for n in s_cpu if not torch.allclose(s_gpu[n], s_cpu[n],
                                                 rtol=tol / 10,
                                                 atol=tol / 10)]
    assert not bad, bad


def test_train_step_on_gpu_equals_cpu(cuda):
    _step_on_gpu_and_cpu(cuda, 1, torch.float32, 1e-4)


def test_train_step_of_two_groups_on_gpu_equals_cpu(cuda):
    """``TPU.NUM_GROUPS`` 2: the group loop on the card as on the CPU, in
    float64 (the step keeps it end to end). In fp32 this random trunk's
    early gradients differ by 3-4e-4 between card and CPU at G = 2, the
    rounding of the two groups' sum; float64 tests the implementations."""
    _step_on_gpu_and_cpu(cuda, 2, torch.float64, 1e-9)


# ------------------------------------------------------------ re-ranking ----

def _same_ranking(vals, idx, ref_idx, tol=1e-5):
    """Per row of ascending ``vals``: ``idx`` equals ``ref_idx`` wherever
    neighbouring values differ by more than ``tol``; the same set of
    indices within a run of closer values."""
    for v, i, ri in zip(np.asarray(vals), np.asarray(idx),
                        np.asarray(ref_idx)):
        cuts = np.nonzero(np.diff(v) > tol)[0] + 1
        for a, b in zip(np.split(i, cuts), np.split(ri, cuts)):
            assert sorted(a) == sorted(b), (v, i, ri)


def _integer_clusters(seed, n, d=64, clusters=40):
    """Clustered small-integer rows: every euclidean distance is an exact
    fp32 integer on both devices, so the ranks are equal."""
    rng = np.random.RandomState(seed)
    centers = rng.randint(-4, 5, (clusters, d))
    return (centers[rng.randint(0, clusters, n)]
            + rng.randint(-1, 2, (n, d))).astype(np.float32)


@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
def test_rerank_distmat_on_card_matches_cpu(cuda, dist):
    """The dense re-ranker on the card (ranks on K3) against the CPU:
    values within 1e-5, stable ranks equal."""
    from centroids_reid_tpu_torch.ops import rerank_distmat

    f = (_integer_clusters(20, 1200) if dist == "euclidean"
         else np.random.RandomState(20).randn(1200, 64).astype(np.float32))
    reset_launch_counts()
    g = rerank_distmat(f[:200], f[200:], dist=dist, device=cuda)
    torch.cuda.synchronize()
    assert g.device.type == "cuda" and launch_counts()["kpass_topk"] == 1
    g = g.cpu().numpy()
    c = rerank_distmat(f[:200], f[200:], dist=dist, device="cpu").numpy()
    np.testing.assert_allclose(g, c, rtol=0, atol=1e-5)
    og, oc = (np.argsort(x, 1, kind="stable") for x in (g, c))
    _same_ranking(np.take_along_axis(g, og, 1), og, oc)


def test_rerank_topk_on_card_matches_cpu(cuda):
    """Windowed re-ranking on the card (exact fp32 window on the
    hierarchical top-k, local ranks on K3) against the CPU."""
    from centroids_reid_tpu_torch.ops import rerank_topk

    f = _integer_clusters(21, 5100)
    d, i = rerank_topk(f[:100], f[100:], r=100, device=cuda)
    rd, ri = rerank_topk(f[:100], f[100:], r=100, device="cpu")
    assert d.device.type == "cuda" and d.shape == (100, 100)
    np.testing.assert_allclose(d.cpu().numpy(), rd.numpy(), rtol=0,
                               atol=1e-5)
    _same_ranking(d.cpu().numpy(), i.cpu().numpy(), ri.numpy())


def test_windowed_core_on_card_matches_cpu(cuda):
    """``_windowed`` on the same candidate windows of random unit rows, fp32
    local distances with TF32 off, card against CPU."""
    from centroids_reid_tpu_torch.ops import rerank as RR

    rng = np.random.RandomState(22)
    g = rng.randn(3000, 256).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[:40] + 0.1 * rng.randn(40, 256).astype(np.float32)
    d0 = (g * g).sum(1)[None, :] - 2.0 * q @ g.T
    idx = torch.from_numpy(np.argsort(d0, 1, kind="stable")[:, :100])
    out = {}
    for dev in ("cpu", cuda):
        out[str(dev)] = RR._windowed(
            torch.from_numpy(q).to(dev), torch.from_numpy(g).to(dev),
            idx.to(dev), 0.3, 21, 11, 6, 32, "euclidean").cpu()
    c, k = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(k.numpy(), c.numpy(), rtol=0, atol=1e-5)
    kv, ko = torch.sort(k, dim=1, stable=True)
    _same_ranking(kv.numpy(), ko.numpy(),
                  torch.sort(c, dim=1, stable=True)[1].numpy())


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_reranked_service_on_gpu_matches_cpu(cuda, int8):
    """``RetrievalService(rerank_window=50)`` on the card (K1 + K3, or the
    int8 embed on K5 / K6 and K4 + K3, then the re-rank) against the same
    service on the CPU's plain versions; fp32 embed with TF32 off (or one
    int8 artifact), so the embeddings agree to ~1e-6: scores within 1e-4,
    rankings equal."""
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService
    from centroids_reid_tpu_torch.models import create_model
    from centroids_reid_tpu_torch.models.quantized import quantize_reid_model

    torch.backends.cudnn.allow_tf32 = False
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = [64, 32]
    rng = np.random.RandomState(23)
    gallery = rng.randn(3000, 512).astype(np.float32)
    queries = rng.randint(0, 256, (6, 64, 32, 3)).astype(np.uint8)
    paths = [str(i) for i in range(3000)]
    model = create_model(cfg)
    kw = dict(k=50, rerank_window=50)
    if int8:
        kw.update(use_int8_gallery=True, int8_qfn=quantize_reid_model(
            model, [queries], cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
            use_pallas=True, acc_dtype=torch.int32))
    out = {}
    for dev in ("cpu", cuda):
        svc = RetrievalService(cfg, gallery, paths, device=dev, model=model,
                               **kw)
        out[str(dev)] = svc.query_arrays(queries)
    (dc, ic, _), (dg, ig, _) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(dg, dc, rtol=0, atol=1e-4)
    _same_ranking(dg, ig, ic, tol=1e-4)


def _stream_set(seed, q=150, g=3000, d=64, pids=40):
    """Integer-valued clustered rows (exact distances, many ties, a
    duplicated gallery row) with pids, cameras and a query of no pid."""
    rng = np.random.RandomState(seed)
    f = _integer_clusters(seed, q + g, d=d, clusters=pids)
    f[q + 7] = f[q + 900] = f[q + 2999]
    pids_all = rng.randint(0, pids, q + g)
    pids_all[q + 900] = pids_all[q + 2999] = pids_all[q + 7]
    cams = rng.randint(0, 6, q + g)
    pids_all[0] = pids + 3
    return (f[:q], f[q:], pids_all[:q], pids_all[q:], cams[:q], cams[q:])


def test_stream_ranks_on_card_equal_cpu(cuda):
    """The streaming passes on the card (g_chunk 1024: 3 tiles, the last
    ragged) give the CPU's per-hit ranks and distances exactly, and each
    rank is the hit's position among the kept entries of the stable
    argsort: no positive counts itself."""
    from centroids_reid_tpu_torch.metrics import compute_stream_ranks
    from centroids_reid_tpu_torch.metrics.r1_map import compute_distmat

    qf, gf, qp, gp, qc, gc = _stream_set(30)
    card = compute_stream_ranks(qf, torch.from_numpy(gf).to(cuda), qp, gp,
                                qc, gc, g_chunk=1024)
    cpu = compute_stream_ranks(qf, gf, qp, gp, qc, gc, g_chunk=1024,
                               device="cpu")
    np.testing.assert_array_equal(card.ranks, cpu.ranks)
    np.testing.assert_array_equal(card.dpos, cpu.dpos)
    order = np.argsort(compute_distmat(qf, gf, device="cpu"), axis=1,
                       kind="stable")
    for q in range(len(qf)):
        keep = ~((gp[order[q]] == qp[q]) & (gc[order[q]] == qc[q]))
        rank_of = (np.cumsum(keep) - 1)[np.argsort(order[q])]
        hits = card.pos[q][card.pos[q] >= 0]
        np.testing.assert_array_equal(card.ranks[q, :len(hits)],
                                      rank_of[hits])


@pytest.mark.parametrize("rerank_window", [0, 40])
def test_r1map_streaming_on_card_matches_materialising(cuda, rerank_window):
    """``R1mAP(streaming=True)`` on the card equals its materialising path
    (mAP, CMC within 1e-6); with ``rerank_window`` the windowed re-ranked
    evaluation on the card equals the CPU's."""
    from centroids_reid_tpu_torch.metrics import R1mAP

    qf, gf, qp, gp, qc, gc = _stream_set(31)
    rng = np.random.RandomState(31)
    feats = np.concatenate([qf, gf]) + rng.rand(len(qf) + len(gf), 64)
    feats = feats.astype(np.float32)
    pids, cams = np.concatenate([qp, gp]), np.concatenate([qc, gc])
    kw = dict(rerank=bool(rerank_window), rerank_window=rerank_window,
              rerank_k1=8, rerank_k2=4)
    got = R1mAP(len(qf), streaming=True, device=cuda, **kw).compute(
        torch.from_numpy(feats).to(cuda), pids, cams)
    ref = (R1mAP(len(qf), device="cpu", **kw) if rerank_window
           else R1mAP(len(qf), streaming=False, device=cuda))
    ref = ref.compute(feats, pids, cams)
    assert abs(got.mAP - ref.mAP) <= 1e-6
    np.testing.assert_allclose(got.cmc, ref.cmc, atol=1e-6)
    np.testing.assert_array_equal(got.single_performance[:, 0],
                                  ref.single_performance[:, 0])
    np.testing.assert_allclose(got.single_performance[:, 2],
                               ref.single_performance[:, 2], atol=1e-6)


def _k7_set(seed, case):
    """Integer-valued clustered rows for the distance-and-rank kernel K7,
    with pids and cameras: 300 queries (five 64-row query tiles, the last
    partial) over 3,077 rows (no multiple of the 256-row gallery tile).
    "heavy": one pid owns 200 more rows, so H > 128."""
    q, g = 300, 3077
    rng = np.random.RandomState(seed)
    f = _integer_clusters(seed, q + g, d=64, clusters=40)
    pids = rng.randint(0, 80, q + g)
    cams = rng.randint(0, 6, q + g)
    if case == "heavy":
        pids[q:q + 200] = 7
        pids[:20] = 7
    return f[:q], f[q:], pids[:q], pids[q:], cams[:q], cams[q:]


def _k7_ranks(cuda, data, **kw):
    """compute_stream_ranks on the card (the kernels it launched, counted)
    and on the CPU (K7's plain versions)."""
    from centroids_reid_tpu_torch.metrics import compute_stream_ranks

    qf, gf, *rest = data
    reset_launch_counts()
    card = compute_stream_ranks(torch.from_numpy(qf).to(cuda),
                                torch.from_numpy(gf).to(cuda), *rest, **kw)
    torch.cuda.synchronize()
    launches = {name: n for name, n in launch_counts().items() if n}
    kw.pop("mesh", None)
    cpu = compute_stream_ranks(qf, gf, *rest, device="cpu", **kw)
    return card, cpu, launches


@pytest.mark.parametrize("respect", [False, True], ids=["camid", "bitmask"])
@pytest.mark.parametrize("case", ["ragged", "heavy"])
def test_stream_rank_kernel_equals_plain_bit_for_bit(cuda, respect, case):
    """K7 against its plain versions through ``compute_stream_ranks``:
    every fp32 euclidean value is an exact integer, so the extracted
    distances and the ranks are equal outright, under both camid rules
    (bitmask cameras 1 << cam under ``respect_camids``), and each rank is
    the hit's position among the kept entries of the stable argsort. One
    extract and one count launch for the whole query set."""
    from centroids_reid_tpu_torch.metrics.r1_map import compute_distmat

    qf, gf, qp, gp, qc, gc = _k7_set(50, case)
    g_cams = (1 << gc) | (1 << ((gc + 1) % 6)) if respect else gc
    card, cpu, launches = _k7_ranks(cuda, (qf, gf, qp, gp, qc, g_cams),
                                    respect_camids=respect)
    assert launches == {"stream_extract": 1, "stream_count": 1}
    h = card.pos.shape[1]
    assert h > 128 if case == "heavy" else h == 64
    np.testing.assert_array_equal(card.pos, cpu.pos)
    np.testing.assert_array_equal(card.dpos, cpu.dpos)
    np.testing.assert_array_equal(card.ranks, cpu.ranks)
    order = np.argsort(compute_distmat(qf, gf, device="cpu"), axis=1,
                       kind="stable")
    for q in range(len(qf)):
        o = order[q]
        same = (((g_cams[o] >> qc[q]) & 1) == 1 if respect
                else g_cams[o] == qc[q])
        keep = ~((gp[o] == qp[q]) & same)
        rank_of = (np.cumsum(keep) - 1)[np.argsort(o)]
        hits = card.pos[q][card.pos[q] >= 0]
        np.testing.assert_array_equal(card.ranks[q, :len(hits)],
                                      rank_of[hits])


def test_stream_rank_kernel_cosine_aps_match_plain(cuda):
    """Cosine on random unit rows: the kernel's normalised products round
    unlike the CPU's, so the APs are held within 1e-6, the query ids and
    CMC alike."""
    from centroids_reid_tpu_torch.metrics import eval_func_streaming

    rng = np.random.RandomState(51)
    f = rng.randn(2200, 64).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    pids = rng.randint(0, 60, 2200)
    cams = rng.randint(0, 6, 2200)
    args = (pids[:200], pids[200:], cams[:200], cams[200:])
    card = eval_func_streaming(torch.from_numpy(f[:200]).to(cuda),
                               torch.from_numpy(f[200:]).to(cuda), *args,
                               dist="cosine")
    cpu = eval_func_streaming(f[:200], f[200:], *args, dist="cosine",
                              device="cpu")
    np.testing.assert_array_equal(card.single_performance[:, 0],
                                  cpu.single_performance[:, 0])
    np.testing.assert_allclose(card.single_performance[:, 2],
                               cpu.single_performance[:, 2], atol=1e-6)
    np.testing.assert_allclose(card.cmc, cpu.cmc, atol=1e-6)
    assert abs(card.mAP - cpu.mAP) <= 1e-6


def test_stream_rank_kernel_on_a_two_shard_card_mesh(cuda):
    """Two shards on one card (the second starts at row 2,048, mid-way
    through the 3,077): one extract and one count launch per shard, the
    extractions summed before the count; ranks and distances equal the
    CPU's unsharded ones."""
    from centroids_reid_tpu_torch.parallel import make_retrieval_mesh

    data = _k7_set(52, "ragged")
    card, cpu, launches = _k7_ranks(
        cuda, data, g_chunk=1024,
        mesh=make_retrieval_mesh(devices=["cuda"] * 2))
    assert launches == {"stream_extract": 2, "stream_count": 2}
    np.testing.assert_array_equal(card.dpos, cpu.dpos)
    np.testing.assert_array_equal(card.ranks, cpu.ranks)


def test_stream_rank_kernel_orders_duplicates_by_index(cuda):
    """Bit-identical copies of two hit rows with random fp32 values, before
    and after each hit and across the kernel's 256-row gallery tiles
    (255 | 256, 767 | 768), half of them hits too: equal distances, so
    they count by index, exactly as the plain
    version and as the stable argsort of float64 distances. Queries and
    copies lie around one centre, 30 rows closer to it and the rest far
    out, so no other row comes within rounding of a copy's distance. Each
    distance is about 1.3 left of norms near 128, so the two devices'
    values differ by a few units of 128's last place (1.5e-5): 1e-4."""
    rng = np.random.RandomState(53)
    q, g, d = 130, 1500, 64
    c = rng.randn(d)
    qf = (c + 0.1 * rng.randn(q, d)).astype(np.float32)
    gf = (c + 3.0 * rng.randn(g, d)).astype(np.float32)
    gf[300:330] = c + 0.02 * rng.randn(30, d)
    qp, gp = np.full(q, 1), rng.randint(10, 40, g)
    qc, gc = rng.randint(0, 6, q), rng.randint(0, 6, g)
    for pid, hit, copies, queries in (
            (1, 130, (0, 127, 128, 129, 131, 255, 256, 1499), slice(0, 60)),
            (2, 700, (5, 699, 701, 767, 768, 1023), slice(60, q))):
        gf[hit] = c + 0.1 * rng.randn(d)
        gf[list(copies)] = gf[hit]
        gp[hit] = pid
        gp[list(copies[::2])] = pid
        qp[queries] = pid
    card, cpu, launches = _k7_ranks(cuda, (qf, gf, qp, gp, qc, gc))
    assert launches == {"stream_extract": 1, "stream_count": 1}
    np.testing.assert_array_equal(card.ranks, cpu.ranks)
    np.testing.assert_allclose(card.dpos, cpu.dpos, rtol=0, atol=1e-4)
    d64 = ((qf.astype(np.float64)[:, None, :] - gf[None]) ** 2).sum(axis=2)
    for qi in range(q):
        o = np.argsort(d64[qi], kind="stable")
        keep = ~((gp[o] == qp[qi]) & (gc[o] == qc[qi]))
        rank_of = (np.cumsum(keep) - 1)[np.argsort(o)]
        hits = card.pos[qi][card.pos[qi] >= 0]
        np.testing.assert_array_equal(card.ranks[qi, :len(hits)],
                                      rank_of[hits])
        assert len(set(card.dpos[qi, :len(hits)].tolist())) == 1
    assert (card.num_rel > 2).sum() > q // 2


def test_stream_rank_kernel_worst_case_every_row_searched(cuda):
    """The queries' hits are the farthest rows of the gallery, so every kept
    row falls under each query's farthest hit and is searched, and every
    row but the hits lands in the first histogram slot: the kernel's
    atomics at their most contended. A few queries have no hit. Integer
    rows: equal to the CPU."""
    rng = np.random.RandomState(54)
    q, g, d = 260, 4100, 64
    qf = rng.randint(-2, 3, (q, d)).astype(np.float32)
    gf = rng.randint(-2, 3, (g, d)).astype(np.float32)
    qp, gp = np.zeros(q, np.int64), np.full(g, 99)
    qp[-5:] = 7
    rows = rng.choice(g, 3, replace=False)
    gp[rows] = 0
    gf[rows] = 40.0 + rng.randint(-1, 2, (3, d))
    qc, gc = rng.randint(0, 6, q), rng.randint(0, 6, g)
    card, cpu, _ = _k7_ranks(cuda, (qf, gf, qp, gp, qc, gc))
    np.testing.assert_array_equal(card.ranks, cpu.ranks)
    np.testing.assert_array_equal(card.dpos, cpu.dpos)
    far = np.where(card.pos >= 0, card.ranks, 0).max(axis=1)
    with_hits = card.num_rel > 0
    assert with_hits.sum() > q // 2 and not with_hits[-5:].any()
    assert (far[with_hits] >= g - 3).all()


@pytest.mark.parametrize("hw", [(256, 128), (32, 16)])
def test_yuv420_unpack_on_card_equals_cpu(cuda, hw):
    """``yuv420_to_rgb`` and ``normalize_yuv420_batch`` on the card against
    the CPU: the chroma upsample is exact, the BT.601 products round in
    fp32 (1e-4 on [0, 255]; 1e-5 normalised)."""
    from centroids_reid_tpu_torch import native
    from centroids_reid_tpu_torch.data import transforms as T

    rng = np.random.RandomState(32)
    imgs = rng.randint(0, 256, (8, *hw, 3)).astype(np.uint8)
    packed = torch.from_numpy(np.stack([native.rgb_to_yuv420_np(i)
                                        for i in imgs]))
    card = T.yuv420_to_rgb(packed.to(cuda), hw)
    assert card.device.type == "cuda"
    np.testing.assert_allclose(card.cpu().numpy(),
                               T.yuv420_to_rgb(packed, hw).numpy(), rtol=0,
                               atol=1e-4)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    np.testing.assert_allclose(
        T.normalize_yuv420_batch(packed.to(cuda), hw, mean, std).cpu(),
        T.normalize_yuv420_batch(packed, hw, mean, std), rtol=0, atol=1e-5)


# ----------------------------------------------------- serving artifacts --

@pytest.mark.parametrize("m,k,n,with_res,relu", K5_EMBED)
def test_matmul_requant_operator_embed_shapes_exact(cuda, m, k, n, with_res,
                                                    relu):
    """K5 through the operator ``torch.ops.crt.matmul_requant`` (as an
    exported program calls it) with a packed weight: bit for bit, one
    launch."""
    x, w, scale, bias, res, rs = _requant_inputs(cuda, m, k, n, with_res,
                                                 k + n + 1)
    reset_launch_counts()
    got = torch.ops.crt.matmul_requant(x, w, scale, bias, res, rs, relu,
                                       C.pack_weight(w))
    assert launch_counts()["matmul_requant"] == 1
    assert torch.equal(got, C.matmul_requant_plain(
        x, w, scale, bias, res=res, res_scale=rs, relu=relu))


@pytest.mark.parametrize("b,h,w,k", K6_EMBED)
def test_conv3x3_requant_operator_embed_shapes_exact(cuda, b, h, w, k):
    x, wt, scale, bias, res, rs = _requant_inputs(
        cuda, b * h * w, 9 * k, k, True, b + k + 1, res_shape=(b, h, w, k))
    x = x[:, :k].reshape(b, h, w, k).contiguous()
    wt = wt.reshape(3, 3, k, k)
    reset_launch_counts()
    got = torch.ops.crt.conv3x3_requant(x, wt, scale, bias, res, rs, True,
                                        C.pack_weight(wt))
    assert launch_counts()["conv3x3_requant"] == 1
    assert torch.equal(got, C.conv3x3_requant_plain(
        x, wt, scale, bias, res_nhwc=res, res_scale=rs))


def _artifact_model(mixed_precision):
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.models import create_model

    torch.backends.cudnn.allow_tf32 = False
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.USE_MIXED_PRECISION = mixed_precision
    cfg.INPUT.SIZE_TEST = [64, 32]
    model = create_model(cfg).cuda().to(memory_format=torch.channels_last)
    imgs = np.random.RandomState(14).randint(0, 256, (8, 64, 32, 3)).astype(
        np.uint8)
    return cfg, model, imgs


def test_int8_artifact_on_card_equals_live_qfn(cuda, tmp_path):
    """The int8 program on the card runs K5 / K6 through the operators, as
    often as the live engine, and equals it bit for bit."""
    from centroids_reid_tpu_torch.inference import export as X
    from centroids_reid_tpu_torch.models.quantized import quantize_reid_model

    cfg, model, imgs = _artifact_model(False)
    qfn = quantize_reid_model(model, [imgs], cfg.INPUT.PIXEL_MEAN,
                              cfg.INPUT.PIXEL_STD, use_pallas=True,
                              acc_dtype=torch.int32)
    blobs, meta = X.export_embedder(model, cfg, batch_size=8,
                                    platforms=("cuda",), int8_qfn=qfn)
    path = str(tmp_path / "int8.crt")
    X.save_artifact(path, blobs, meta)
    emb = X.load_embedder(path, cuda)
    emb.warmup()
    with torch.inference_mode():
        live = qfn(imgs)
        live = (live / live.norm(dim=1, keepdim=True)).cpu().numpy()
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.inference_mode():
        qfn(imgs)
    torch.cuda.synchronize()
    live_launches = launch_counts()
    reset_launch_counts()
    got = emb.embed(imgs)
    torch.cuda.synchronize()
    assert launch_counts() == live_launches
    assert live_launches["matmul_requant"] > 0
    assert live_launches["conv3x3_requant"] > 0
    np.testing.assert_array_equal(got, live)


def test_bf16_embedder_artifact_on_card_equals_embed_query(cuda, tmp_path):
    """A symbolic-batch bf16 program traced on the card (autocast for
    CUDA) equals the live embed at two batch sizes."""
    from centroids_reid_tpu_torch.inference import export as X
    from centroids_reid_tpu_torch.inference.service import embed_query

    cfg, model, imgs = _artifact_model(True)
    blobs, meta = X.export_embedder(model, cfg, platforms=("cuda", "cpu"))
    path = str(tmp_path / "bf16.crt")
    X.save_artifact(path, blobs, meta)
    emb = X.load_embedder(path, cuda)
    for n in (3, 8):
        with torch.inference_mode():
            live = embed_query(model, torch.from_numpy(imgs[:n]).cuda(),
                               cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
                               torch.bfloat16, True).cpu().numpy()
        np.testing.assert_allclose(emb.embed(imgs[:n]), live, rtol=1e-5,
                                   atol=1e-6)
    cpu = X.load_embedder(path, "cpu").embed(imgs[:2])
    assert cpu.shape == (2, 512) and np.isfinite(cpu).all()


def test_cpu_only_artifact_refuses_the_card(cuda, tmp_path):
    from centroids_reid_tpu_torch.inference import export as X

    cfg, model, _ = _artifact_model(False)
    blobs, meta = X.export_embedder(model, cfg, platforms=("cpu",))
    path = str(tmp_path / "cpu.crt")
    X.save_artifact(path, blobs, meta)
    with pytest.raises(ValueError, match="no program for device type 'cuda'"):
        X.load_embedder(path, cuda)


# ------------------------------------------------------ orbax checkpoints ----

def test_orbax_fixture_reads_on_the_card_machine(cuda):
    """The committed orbax checkpoint of the JAX package reads on this
    machine's interpreter (no jax, orbax, tensorstore or zstandard; the
    system's libzstd): every leaf equals ``arrays.npz`` bit for bit, also
    after a round trip through the card, and its Adam state maps by name."""
    import os
    import sys

    from centroids_reid_tpu_torch.engine.orbax_read import read_checkpoint
    from centroids_reid_tpu_torch.models import (
        from_jax_opt_state,
        from_jax_params,
    )

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "orbax_small")
    tree = read_checkpoint(os.path.join(fixture, "checkpoint_epoch1"))
    with np.load(os.path.join(fixture, "arrays.npz")) as z:
        for key in z.files:
            node = tree
            for part in key.split("."):
                node = node[int(part)] if isinstance(node, list) else node[
                    part]
            assert node.dtype == z[key].dtype and np.array_equal(node,
                                                                 z[key]), key
            back = torch.from_numpy(node.copy()).to(cuda).cpu()
            assert np.array_equal(back.numpy(), z[key]), key
    sd = from_jax_params(tree["params"]["model"], {})
    named = [(n, t) for n, t in sd.items() if n != "bn.bias"]
    state = from_jax_opt_state(tree["opt_state"], named)
    assert len(state) == len(named) and all(
        s["exp_avg"].shape == t.shape and s["step"].item() == 2
        for s, (_, t) in zip(state.values(), named))
    assert not [m for m in sys.modules if m.split(".")[0] in (
        "jax", "orbax", "tensorstore", "zstandard")]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("k", [10, 100])
def test_sharded_topk_on_a_four_shard_card_mesh(cuda, bf16, k):
    """``sharded_topk`` over 4 shards on cuda:0 (per shard K1 on bf16 or the
    fp32 product, the hierarchical top-k on K3; the K3 merge) against the
    same mesh of 4 CPU shards (plain versions). Integer rows: every score
    is an exact fp32 integer, so values and indices are equal, ties
    included. The 70,000 rows make 17,536-row shards, past the direct
    base case: K1 x 4 and K3 x 9 a call."""
    from centroids_reid_tpu_torch.parallel import (
        make_retrieval_mesh,
        sharded_topk,
    )

    rng = np.random.RandomState(40)
    qf = torch.from_numpy(rng.randint(-2, 3, (100, 64)).astype(np.float32))
    gf = torch.from_numpy(rng.randint(-2, 3, (70000, 64)).astype(np.float32))
    if bf16:
        qf, gf = qf.bfloat16(), gf.bfloat16()
    reset_launch_counts()
    v, i = sharded_topk(qf, gf.to(cuda), k,
                        make_retrieval_mesh(devices=[cuda] * 4))
    torch.cuda.synchronize()
    launches = launch_counts()
    rv, ri = sharded_topk(qf, gf, k, make_retrieval_mesh(devices=["cpu"] * 4))
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(v, rv)
    assert launches["scores"] == (4 if bf16 else 0)
    assert launches["kpass_topk"] == 9


@pytest.mark.parametrize("rerank_window", [0, 50])
def test_sharded_service_on_a_four_shard_card_mesh(cuda, rerank_window):
    """``RetrievalService(mesh=)`` with 4 bf16 shards on cuda:0 against the
    same service on 4 CPU shards: fp32 embed with TF32 off, so the
    embeddings agree to ~1e-6; distances (or re-rank scores) within 1e-4,
    rankings equal up to runs of values within 1e-4."""
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.inference import RetrievalService
    from centroids_reid_tpu_torch.models import create_model
    from centroids_reid_tpu_torch.parallel import make_retrieval_mesh

    torch.backends.cudnn.allow_tf32 = False
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = [64, 32]
    rng = np.random.RandomState(41)
    gallery = rng.randn(3000, 512).astype(np.float32)
    queries = rng.randint(0, 256, (6, 64, 32, 3)).astype(np.uint8)
    paths = [str(i) for i in range(3000)]
    model = create_model(cfg)
    out = {}
    for dev in ("cpu", cuda):
        svc = RetrievalService(cfg, gallery, paths, k=50, model=model,
                               rerank_window=rerank_window,
                               mesh=make_retrieval_mesh(devices=[dev] * 4))
        out[str(dev)] = svc.query_arrays(queries)
    (dc, ic, _), (dg, ig, _) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(dg, dc, rtol=0, atol=1e-4)
    _same_ranking(dg, ig, ic, tol=1e-4)


def test_nccl_step_at_world_one_equals_the_plain_step(cuda, tmp_path):
    """One train step of resnet18 (32x16, fp32, TF32 off, two groups of 4 x
    4, cuDNN deterministic) without a process group and in an NCCL group of
    world size 1, where the step packs every gradient, running statistic
    and metric into one flat buffer and all-reduces it: metrics, gradients
    and the state after the optimizers' step equal bit for bit."""
    import copy

    import torch.distributed as dist

    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.engine.state import create_train_state
    from centroids_reid_tpu_torch.engine.steps import make_train_step
    from centroids_reid_tpu_torch.models import create_model

    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.USE_MIXED_PRECISION = False
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.DATALOADER.NUM_INSTANCE = 4
    classes = 8
    base = create_model(cfg, num_classes=classes,
                        generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(5)
    imgs = torch.from_numpy(rng.randn(2, 16, 32, 16, 3).astype(np.float32))
    labels = torch.from_numpy(np.stack([np.repeat(rng.choice(
        classes, 4, replace=False), 4) for _ in range(2)]))
    is_real = torch.ones(2, 16, dtype=torch.bool)
    is_real[:, 7] = False

    def run():
        model = copy.deepcopy(base).to(cuda, memory_format=torch.channels_last)
        state = create_train_state(cfg, model, classes,
                                   torch.Generator().manual_seed(1))
        metrics = make_train_step(state, cfg, classes, "ctl")(
            imgs.to(cuda), labels.to(cuda), is_real.to(cuda))
        out = {f"metric.{k}": v for k, v in metrics.items()}
        out.update({f"grad.{n}": p.grad for n, p in model.named_parameters()
                    if p.grad is not None})
        out.update({f"state.{k}": v for k, v in model.state_dict().items()})
        out["centers"] = state.centers.detach()
        return {k: v.cpu().clone() for k, v in out.items()}

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    torch.backends.cudnn.allow_tf32 = False
    try:
        plain = run()
        dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
        try:
            reduced = run()
        finally:
            dist.destroy_process_group()
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32) = saved
    assert plain.keys() == reduced.keys()
    for k in plain:
        assert torch.equal(plain[k], reduced[k]), k


# K8: (rows, D, delta dtype, y dtype). TransReID's sites at the cell's
# batch of 256: [256 x 211, 768] and b2's [1024 x 53, 768] with a bf16
# branch and a bf16 output, no branch (block 0's and b2's norm1), an fp32
# output (b1's and b2's final norms), all fp32 (autocast off); a ragged 7
# rows (one part-filled block); other row counts and type mixes.
K8_CASES = [(256 * 211, 768, torch.bfloat16, torch.bfloat16),
            (1024 * 53, 768, torch.bfloat16, torch.bfloat16),
            (7, 768, torch.bfloat16, torch.bfloat16),
            (256 * 211, 768, None, torch.bfloat16),
            (256 * 211, 768, torch.bfloat16, torch.float32),
            (4096, 768, torch.float32, torch.float32),
            (4096, 768, torch.bfloat16, torch.bfloat16),
            (33, 768, None, torch.float32),
            (4096, 768, torch.float32, torch.bfloat16),
            # Swin-B's sites at 384x128, batch 256 (market-swin-eval): the
            # patch norm (no branch, fp32 y), the blocks of each stage, the
            # merges' 4C norms (no branch), norm3 (fp32 y); ragged rows
            (256 * 3072, 128, None, torch.float32),
            (256 * 3072, 128, torch.bfloat16, torch.bfloat16),
            (256 * 768, 256, torch.bfloat16, torch.bfloat16),
            (256 * 768, 512, None, torch.bfloat16),
            (256 * 192, 512, torch.bfloat16, torch.bfloat16),
            (256 * 192, 1024, None, torch.bfloat16),
            (256 * 48, 1024, torch.bfloat16, torch.bfloat16),
            (256 * 48, 1024, torch.bfloat16, torch.float32),
            (256 * 48, 2048, None, torch.bfloat16),
            (33, 128, torch.bfloat16, torch.bfloat16),
            (7, 2048, torch.float32, torch.float32),
            # DINOv2 ViT-g's block 0 norm1 (no branch) at 252x126
            (256 * 167, 1536, None, torch.bfloat16),
            (7, 1536, torch.bfloat16, torch.bfloat16)]
# A bf16 residual stream (a model cast wholly to bf16): bf16 x, weight
# and bias, a bf16 branch or none, y bf16 (LayerNorm's own) or fp32.
K8_BF16_CASES = [(256 * 211, 768, torch.bfloat16, torch.bfloat16),
                 (1024 * 53, 768, None, torch.bfloat16),
                 (7, 768, torch.bfloat16, torch.float32),
                 (33, 768, torch.bfloat16, torch.bfloat16),
                 # Swin-B's, as its bf16 control runs them
                 (256 * 3072, 128, torch.bfloat16, torch.bfloat16),
                 (256 * 48, 2048, None, torch.bfloat16),
                 (256 * 48, 1024, torch.bfloat16, torch.float32)]
K8_FP32_ATOL = 2e-6   # y in fp32: the statistics summed in another order


def _k8_inputs(cuda, rows, d, delta_dtype, seed=11, stream=torch.float32):
    """(x with a per-row offset, as the residual stream has, the branch or
    None, weight, bias); x, weight and bias in ``stream``'s type."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda)

    x = 2.0 * randn(rows, d) + randn(rows, 1)
    delta = None if delta_dtype is None else randn(rows, d).to(delta_dtype)
    return (x.to(stream), delta, (1.0 + 0.1 * randn(d)).to(stream),
            (0.1 * randn(d)).to(stream))


def _bf16_ulp(v):
    """The spacing of bf16 values at |v| (8 significant bits)."""
    e = torch.frexp(v.float().abs())[1]
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("rows,d,delta_dtype,y_dtype", K8_CASES)
def test_add_norm_kernel_matches_plain(cuda, rows, d, delta_dtype, y_dtype):
    """K8 against ``add_norm_plain`` (the add, ``F.layer_norm`` and the
    cast as eager ops) on the card: ``x + delta`` bit for bit; ``y``
    within one bf16 ulp of the plain version's (or K8_FP32_ATOL where
    that is less, near 0), or within K8_FP32_ATOL in fp32."""
    _hold_k8_to_plain(*_k8_inputs(cuda, rows, d, delta_dtype), y_dtype)


@pytest.mark.parametrize("rows,d,delta_dtype,y_dtype", K8_BF16_CASES)
def test_add_norm_kernel_bf16_stream_matches_plain(cuda, rows, d,
                                                   delta_dtype, y_dtype):
    """K8 on a bf16 residual stream (bf16 x, weight and bias, as in a
    TransReID cast wholly to bf16) against ``add_norm_plain``: the bf16
    sum bit for bit (PyTorch's bf16 add rounds the fp32 sum to nearest
    even, as K8 does), ``y`` as in the fp32 stream's cases. An fp32 ``y``
    is LayerNorm's own only under autocast, so that case runs there."""
    with torch.autocast("cuda", dtype=torch.bfloat16,
                        enabled=y_dtype == torch.float32):
        _hold_k8_to_plain(*_k8_inputs(cuda, rows, d, delta_dtype,
                                      stream=torch.bfloat16), y_dtype)


# K8 with a LayerScale on the branch (DINOv2): (rows, D, delta dtype, y
# dtype, stream). ViT-g's sites at 252x126, batch 256: the blocks' (a bf16
# branch times its fp32 gamma, a bf16 y), the final norm's (an fp32 y);
# fp32 throughout (autocast off); a bf16 stream (the bf16 control, bf16
# gamma); ragged rows; another width.
K8_SCALED_CASES = [
    (256 * 167, 1536, torch.bfloat16, torch.bfloat16, torch.float32),
    (256 * 167, 1536, torch.bfloat16, torch.float32, torch.float32),
    (4096, 1536, torch.float32, torch.float32, torch.float32),
    (256 * 167, 1536, torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (33, 1536, torch.bfloat16, torch.float32, torch.bfloat16),
    (7, 1536, torch.bfloat16, torch.bfloat16, torch.float32),
    (4096, 768, torch.bfloat16, torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("rows,d,delta_dtype,y_dtype,stream",
                         K8_SCALED_CASES)
def test_add_norm_kernel_with_scale_matches_plain(cuda, rows, d, delta_dtype,
                                                  y_dtype, stream):
    """K8 with a per-channel ``scale`` on the branch (DINOv2's LayerScale,
    gammas U(0.05, 0.5)) against ``add_norm_plain``: ``x + delta * scale``
    bit for bit (one multiply rounded to the stream's type, then one add:
    no FMA), ``y`` as in the cases without a scale. A bf16 stream's fp32
    ``y`` is LayerNorm's own only under autocast, so that case runs
    there."""
    x, delta, w, b = _k8_inputs(cuda, rows, d, delta_dtype, stream=stream)
    g = torch.Generator(device=cuda).manual_seed(12)
    scale = (0.05 + 0.45 * torch.rand(d, generator=g, device=cuda)).to(
        stream)
    with torch.autocast("cuda", dtype=torch.bfloat16,
                        enabled=stream == torch.bfloat16
                        and y_dtype == torch.float32):
        _hold_k8_to_plain(x, delta, w, b, y_dtype, scale)


def test_add_norm_kernel_refuses_a_scale_without_a_branch(cuda):
    from centroids_reid_tpu_torch.ops import add_norm as K8

    x, _, w, b = _k8_inputs(cuda, 16, 1536, None)
    reset_launch_counts()
    with pytest.raises(ValueError, match="scale multiplies a delta"):
        K8.add_norm(x, None, w, b, 1e-6, torch.bfloat16, torch.ones_like(w))
    with pytest.raises(ValueError, match="scale must be"):
        K8.add_norm(x, x.to(torch.bfloat16), w, b, 1e-6, torch.bfloat16,
                    torch.ones(768, device=cuda))
    assert launch_counts()["add_norm"] == 0


def _hold_k8_to_plain(x, delta, w, b, y_dtype, scale=None):
    from centroids_reid_tpu_torch.ops import add_norm as K8

    reset_launch_counts()
    s, y = K8.add_norm(x, delta, w, b, 1e-6, y_dtype, scale)
    torch.cuda.synchronize()
    assert launch_counts()["add_norm"] == 1
    ps, py = K8.add_norm_plain(x, delta, w, b, 1e-6, y_dtype, scale)
    assert torch.equal(s, ps) and s.dtype == x.dtype
    if delta is None:
        assert s is x
    assert y.dtype == y_dtype and y.shape == x.shape
    err = (y.float() - py.float()).abs()
    if y_dtype == torch.bfloat16:
        tol = _bf16_ulp(py).clamp_min(K8_FP32_ATOL)
        assert bool((err <= tol).all()), float((err / tol).max())
    else:
        assert float(err.max()) <= K8_FP32_ATOL


@pytest.mark.parametrize("d", [640, 384])
def test_add_norm_kernel_refuses_other_widths(cuda, d):
    """A row width the kernel is not built for (384: ViT-S's, which no
    configuration runs) raises before a launch."""
    from centroids_reid_tpu_torch.ops import add_norm as K8

    x, delta, w, b = _k8_inputs(cuda, 16, d, torch.bfloat16)
    reset_launch_counts()
    with pytest.raises(ValueError, match="built for rows"):
        K8.add_norm(x, delta, w, b, 1e-6, torch.bfloat16)
    assert launch_counts()["add_norm"] == 0


def test_transreid_embed_runs_k8_at_every_site(cuda, monkeypatch):
    """One TransReID embed of a 4-image batch at the published widths
    (ViT-B/16, 256x128, stride 12, SIE, JPM; seeded weights) on the card:
    28 K8 launches and every site's rows fused (``vit.norms_fused`` ==
    ``vit.norms``). In fp32 (autocast off, TF32 off) within 1e-4
    (relative, per row) of the CPU. Under bf16 autocast within the
    benchmark cell's ``emb_rel_err`` limit, 0.03, of the CPU's fp32, as
    the same model with its sites on the eager ops (``add_norm_plain``
    patched in, which fuses none) is, and of that eager run: a bf16
    rounding that flips at
    one site spreads through attention to the whole image, so the two
    bf16 runs differ by bf16 noise, not by K8's fp32 rounding."""
    from centroids_reid_tpu_torch.models import transreid as T
    from centroids_reid_tpu_torch.ops import add_norm as K8
    from centroids_reid_tpu_torch.utils import profiling

    m = T.init_transreid(T.TransReIDModel(cameras=6),
                         torch.Generator().manual_seed(2)).eval()
    x = torch.randn(4, 3, 256, 128, generator=torch.Generator().manual_seed(3))
    cams = torch.tensor([0, 5, 2, 3])

    def rel(a, b):
        return float(((a.float() - b.float()).norm(dim=1)
                      / b.float().norm(dim=1)).max())

    def embed(mixed, device):
        m.mixed_precision = mixed
        with torch.no_grad():
            return m.to(device).embed(x.to(device), cams.to(device))

    reset_launch_counts()
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        fused = embed(True, cuda)
        torch.cuda.synchronize()
    counts = profiling.counts()
    profiling.reset()
    assert launch_counts()["add_norm"] == 28
    assert counts["vit.norms"] == 25 * 4 * 211 + 3 * 16 * 53
    assert counts["vit.norms_fused"] == counts["vit.norms"]
    with monkeypatch.context() as mp, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        mp.setattr(T, "add_norm", K8.add_norm_plain)
        eager = embed(True, cuda)
        torch.cuda.synchronize()
    counts = profiling.counts()
    profiling.reset()
    assert launch_counts()["add_norm"] == 28
    # on the eager ops every site is counted and none fused
    assert counts["vit.norms"] == 25 * 4 * 211 + 3 * 16 * 53
    assert "vit.norms_fused" not in counts
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = embed(False, cuda).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    cpu = embed(False, "cpu")
    errs = (rel(card, cpu), rel(fused.cpu(), cpu), rel(eager.cpu(), cpu),
            rel(fused, eager))
    assert errs[0] < 1e-4, errs
    assert max(errs[1:]) < 0.03, errs


def test_bf16_trunk_embed_runs_k8_at_every_site(cuda, monkeypatch):
    """The benchmark's ``control_bf16`` (``harness/evalembed.py::bf16_trunk``:
    the cell's TransReID, made by ``create_model`` from the cell's
    configuration, cast wholly to bf16, residual stream and LayerNorms
    included, autocast off) embeds a batch of 4 through ``make_embed_fn``
    on the card: 28 K8 launches on the bf16 stream, every site's rows
    fused. Within the cell's ``emb_rel_err`` limit, 0.03 (relative, per
    row), of the same bf16 model with its sites on the eager ops
    (``add_norm_plain`` patched in, none fused): the two differ by bf16
    roundings that flip at a site and spread, as the autocast case's do."""
    import json
    import os

    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.engine.evaluate import make_embed_fn
    from centroids_reid_tpu_torch.models import create_model
    from centroids_reid_tpu_torch.models import transreid as T
    from centroids_reid_tpu_torch.ops import add_norm as K8
    from centroids_reid_tpu_torch.utils import profiling

    bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "portbench")
    monkeypatch.syspath_prepend(bench)
    from harness import evalembed

    with open(os.path.join(bench, "configs",
                           "market-vit-transreid.json")) as f:
        config = json.load(f)
    cfg = get_default_cfg()
    cfg.merge_from_list([str(v) for v in config["opts"]["eval"]])
    model = create_model(cfg, num_classes=0,
                         generator=torch.Generator().manual_seed(2),
                         cameras=6).to(cuda).eval()
    low_cfg, low = evalembed.bf16_trunk(cfg, model)
    del model
    g = torch.Generator().manual_seed(3)
    imgs = torch.randint(0, 256, (4, 256, 128, 3), generator=g,
                         dtype=torch.uint8).to(cuda)
    cams = torch.tensor([0, 5, 2, 3], device=cuda)
    sites = 25 * 4 * 211 + 3 * 16 * 53

    def embed():
        reset_launch_counts()
        profiling.reset()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            e = make_embed_fn(low, low_cfg)(imgs, cams)
            torch.cuda.synchronize()
        counts = profiling.counts()
        profiling.reset()
        return e, launch_counts()["add_norm"], counts

    fused, launches, counts = embed()
    assert next(low.parameters()).dtype == torch.bfloat16
    assert launches == 28
    assert counts["vit.norms"] == counts["vit.norms_fused"] == sites
    with monkeypatch.context() as mp:
        mp.setattr(T, "add_norm", K8.add_norm_plain)
        eager, launches, counts = embed()
    assert launches == 0
    assert counts["vit.norms"] == sites and "vit.norms_fused" not in counts
    err = float(((fused.float() - eager.float()).norm(dim=1)
                 / eager.float().norm(dim=1)).max())
    print(f"bf16 trunk, K8 against the eager sites: {err:.3e}")
    assert torch.isfinite(fused).all() and err < 0.03, err


def _swin_limit():
    """The cell market-swin-eval's ``emb_rel_err`` limit."""
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "portbench", "limits", "market-swin-eval.json")
    with open(path) as f:
        return float(json.load(f)["emb_rel_err"])


def test_swin_embed_runs_k8_at_every_site(cuda, monkeypatch):
    """One Swin-B embed (SOLIDER-REID's trunk at the published widths,
    384x128, seeded weights) of a 4-image batch on the card: 53 K8
    launches (the patch norm, two a block, three merges, norm3) and every
    site's rows fused (``vit.norms_fused`` == ``vit.norms``), at widths
    128 to 2,048; 24 K9 launches (one a block) and every real token's
    window attention fused (``swin.wmsa_fused`` == ``swin.tokens``), with
    no SDPA, plain window attention or row gather on the way. In fp32
    (autocast off, TF32 off), where K9 refuses the fp32 qkv and its plain
    version is patched in, within 1e-4 (relative, per row) of the CPU.
    Under bf16 autocast within the benchmark cell's ``emb_rel_err`` limit
    of the CPU's fp32, as the same model with its sites on the eager ops
    (``add_norm_plain`` patched in, none fused) is."""
    from centroids_reid_tpu_torch.models import swin as S
    from centroids_reid_tpu_torch.models import transreid as T
    from centroids_reid_tpu_torch.ops import add_norm as K8
    from centroids_reid_tpu_torch.ops import window_attn as WA
    from centroids_reid_tpu_torch.utils import profiling

    m = S.init_swin(S.SwinReID(), torch.Generator().manual_seed(2)).eval()
    x = torch.randn(4, 3, 384, 128,
                    generator=torch.Generator().manual_seed(3))
    sites = 4 * (3072 + 2 * (2 * 3072 + 2 * 768 + 18 * 192 + 2 * 48)
                 + 768 + 192 + 48 + 48)
    tokens = 4 * (2 * 3072 + 2 * 768 + 18 * 192 + 2 * 48)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA Swin block left K9")

    def rel(a, b):
        return float(((a.float() - b.float()).norm(dim=1)
                      / b.float().norm(dim=1)).max())

    def embed(mixed, device):
        m.mixed_precision = mixed
        with torch.no_grad():
            return m.to(device).embed(x.to(device))

    def traced(mixed):
        reset_launch_counts()
        profiling.reset()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            e = embed(mixed, cuda)
            torch.cuda.synchronize()
        counts = profiling.counts()
        profiling.reset()
        return e, launch_counts(), counts

    with monkeypatch.context() as mp:
        for name in ("window_attention_plain", "gather_rows"):
            mp.setattr(WA, name, refuse)
        mp.setattr(torch.nn.functional, "scaled_dot_product_attention",
                   refuse)
        fused, launches, counts = traced(True)
    assert launches["add_norm"] == 53 and launches["window_attn"] == 24
    assert counts["vit.norms"] == counts["vit.norms_fused"] == sites
    assert counts["swin.tokens"] == counts["swin.wmsa_fused"] == tokens
    with monkeypatch.context() as mp:
        mp.setattr(T, "add_norm", K8.add_norm_plain)
        eager, launches, counts = traced(True)
    assert launches["add_norm"] == 0 and launches["window_attn"] == 24
    assert counts["vit.norms"] == sites and "vit.norms_fused" not in counts
    with pytest.raises(TypeError, match="bf16 qkv"):
        embed(False, cuda)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with monkeypatch.context() as mp:
            mp.setattr(S, "window_attention", WA.window_attention_plain)
            card = embed(False, cuda).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    cpu = embed(False, "cpu")
    errs = (rel(card, cpu), rel(fused.cpu(), cpu), rel(eager.cpu(), cpu))
    print(f"Swin-B embed: card fp32, fused bf16, eager bf16 against the "
          f"CPU's fp32: {errs}")
    assert errs[0] < 1e-4, errs
    assert max(errs[1:]) < _swin_limit(), errs




def _dinov2_limit():
    """The cell market-dinov2g-eval's ``emb_rel_err`` limit."""
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "portbench", "limits", "market-dinov2g-eval.json")
    with open(path) as f:
        return float(json.load(f)["emb_rel_err"])


def test_dinov2_embed_runs_k8_at_every_site(cuda, monkeypatch):
    """One DINOv2 ViT-g/14 embed (4 registers, the published widths,
    252x126, seeded weights drawn on the card) of a 4-image batch: 81 K8
    launches (two a block, the final norm), every site's rows fused
    (``vit.norms_fused`` == ``vit.norms``), ``dino.tokens`` 4 x 167. In
    fp32 (autocast off, TF32 off) within 1e-4 (relative, per row) of the
    plain fp32 reference (``portbench/reference/dinov2.py``) on the card.
    Under bf16 autocast within the benchmark cell's ``emb_rel_err`` limit
    of that reference, as the same model with its sites on the eager ops
    (``add_norm_plain`` patched in, none fused) is."""
    import importlib.util
    import os

    from centroids_reid_tpu_torch.data.transforms import normalize_batch
    from centroids_reid_tpu_torch.models import dinov2 as D
    from centroids_reid_tpu_torch.models import transreid as T
    from centroids_reid_tpu_torch.ops import add_norm as K8
    from centroids_reid_tpu_torch.utils import profiling

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "portbench", "reference", "dinov2.py")
    spec = importlib.util.spec_from_file_location("ref_dinov2", path)
    ref_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_mod)
    with torch.device(cuda):
        m = D.init_dinov2(D.DinoV2ReID(), torch.Generator(
            device=cuda).manual_seed(2)).eval()
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    imgs = torch.randint(0, 256, (4, 252, 126, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(3)).to(cuda)
    x = normalize_batch(imgs, mean, std).permute(0, 3, 1, 2)
    ref = ref_mod.embed(m.state_dict(), imgs, dict(
        depth=40, num_heads=24, patch_size=14, num_register_tokens=4,
        interpolate_antialias=True, ln_eps=1e-6, neck_feat="before",
        pixel_mean=mean, pixel_std=std), block=4)
    sites = 4 * 167 * 81

    def rel(a, b):
        return float(((a.float() - b.float()).norm(dim=1)
                      / b.float().norm(dim=1)).max())

    def traced(mixed):
        m.mixed_precision = mixed
        reset_launch_counts()
        profiling.reset()
        with torch.no_grad(), torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            e = m.embed(x)
            torch.cuda.synchronize()
        counts = profiling.counts()
        profiling.reset()
        return e, launch_counts()["add_norm"], counts

    fused, launches, counts = traced(True)
    assert launches == 81
    assert counts["vit.norms"] == counts["vit.norms_fused"] == sites
    assert counts["dino.tokens"] == 4 * 167
    with monkeypatch.context() as mp:
        mp.setattr(T, "add_norm", K8.add_norm_plain)
        eager, launches, counts = traced(True)
    assert launches == 0
    assert counts["vit.norms"] == sites and "vit.norms_fused" not in counts
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        card, launches, _ = traced(False)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert launches == 81
    errs = (rel(card, ref), rel(fused, ref), rel(eager, ref))
    print(f"DINOv2 ViT-g embed: card fp32, fused bf16, eager bf16 against "
          f"the fp32 reference: {errs}")
    assert errs[0] < 1e-4, errs
    assert max(errs[1:]) < _dinov2_limit(), errs

# K9: Swin-B's four stage maps at 384x128 and their heads (width 32)
K9_STAGES = [((96, 32), 4), ((48, 16), 8), ((24, 8), 16), ((12, 4), 32)]
# K9 against its plain version on the same bf16 qkv widened to fp32 (the
# fp32 table both): K9 rounds P to bf16, which moves o by at most 2^-9 of
# the largest |v| (the weights sum to one), and o to bf16, 2^-9 of |o| <=
# max |v|; its sums run in another order (fp32, far below that)
K9_TOL = 2.0 ** -8


def _k9_block(cuda, heads, shift, seed=21):
    """A ``ShiftWindowMSA`` at head width 32 on the card, seeded as
    ``init_swin`` draws it: linears N(0, 0.02) with nonzero biases, the
    bias table N(0, 1)."""
    from centroids_reid_tpu_torch.models import swin as S

    blk = S.ShiftWindowMSA(32 * heads, heads, 7, shift)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in blk.parameters():
            p.normal_(0.0, 0.02, generator=g)
        blk.w_msa.relative_position_bias_table.normal_(0.0, 1.0,
                                                       generator=g)
    return blk.to(cuda).eval()


def _k9_operands(cuda, b, hw, heads, shift, seed=22):
    """(qkv, bias, table, geometry): random bf16 qkv [b, h * w, 3C] and
    bias, the block's fp32 table as ``ShiftWindowMSA`` builds it."""
    from centroids_reid_tpu_torch.models import swin as S

    gen = torch.Generator(device=cuda).manual_seed(seed)
    c3 = 96 * heads
    qkv = torch.randn(b, hw[0] * hw[1], c3, generator=gen,
                      device=cuda).to(torch.bfloat16)
    bias = (0.5 * torch.randn(c3, generator=gen, device=cuda)).to(
        torch.bfloat16)
    blk = _k9_block(cuda, heads, shift)
    g = S.window_geometry(hw[0], hw[1], 7, shift, cuda)
    with torch.no_grad():
        table = S.window_mask(blk.w_msa.position_bias(), g.region, 1,
                              torch.float32)
    return qkv, bias, table, g


def _hold_k9_to_plain(o, qkv, bias, table, g, heads):
    """K9's ``o`` within K9_TOL x max |v| of the plain version in fp32 on
    the same operands; every row written and finite."""
    from centroids_reid_tpu_torch.ops import window_attn as WA

    want = WA.window_attention_plain(qkv.float(), bias.float(), table, g,
                                     heads)
    v = qkv.view(*qkv.shape[:2], 3, -1)[:, :, 2]
    vmax = max(float(v.abs().max()), float(bias[2 * bias.numel() // 3:]
                                           .abs().max()))
    err = float((o.float() - want).abs().max())
    assert o.dtype == torch.bfloat16 and o.shape == want.shape
    assert bool(torch.isfinite(o).all())
    assert err <= K9_TOL * vmax, (err, vmax)
    return err


@pytest.mark.parametrize("b", [256, 3])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("hw,heads", K9_STAGES)
def test_window_attn_kernel_matches_plain(cuda, hw, heads, shift, b):
    """K9 at each stage of Swin-B at 384x128, shifted and not, at the
    cell's batch of 256 and a ragged 3 (one part-filled block of images),
    against ``window_attention_plain``: one launch, within K9_TOL."""
    from centroids_reid_tpu_torch.ops import window_attn as WA

    qkv, bias, table, g = _k9_operands(cuda, b, hw, heads, shift)
    reset_launch_counts()
    with torch.no_grad():
        o = WA.window_attention(qkv, bias, table, g, heads)
    torch.cuda.synchronize()
    assert launch_counts()["window_attn"] == 1
    _hold_k9_to_plain(o, qkv, bias, table, g, heads)


def test_padded_qkv_rows_are_the_bias_on_card(cuda):
    """Under bf16 autocast on the card a zero row through qkv (cuBLAS with
    its bias epilogue) is ``bf16(bias)`` bit for bit: what K9 reads for a
    padded token."""
    blk = _k9_block(cuda, 16, 3)
    y = torch.zeros(4, 392, 512, device=cuda)
    y[:, :192] = torch.randn(4, 192, 512, device=cuda)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        qkv = blk.w_msa.qkv(y)
    rows = qkv[:, 192:]
    assert torch.equal(rows, blk.w_msa.qkv.bias.to(torch.bfloat16)
                       .expand_as(rows))


@pytest.mark.parametrize("kind", ["mask", "bias", "pad"])
def test_window_attn_kernel_sees_each_planted_fault(cuda, monkeypatch, kind):
    """Each of the benchmark's planted trunk faults that acts on window
    attention (``harness/evalembed_swin.py::_plant``: the shift mask
    dropped, the bias zeroed, the padded keys masked) reaches K9 through
    the block's ``window_mask``, ``position_bias`` and
    ``window_geometry``: on a shifted stage-3 block under bf16 autocast,
    K9's output under the fault matches the plain version on the same
    faulted operands and lies far from the sound output."""
    import contextlib
    import os

    from centroids_reid_tpu_torch.models import swin as S

    bench = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "portbench")
    monkeypatch.syspath_prepend(bench)
    from harness import evalembed_swin

    blk = _k9_block(cuda, 16, 3)
    y = torch.randn(8, 192, 512, generator=torch.Generator().manual_seed(5))
    y = y.to(cuda, torch.bfloat16)
    real = S.window_attention

    def run(plant):
        seen = []

        def spy(*args):
            seen.append((real(*args), args))
            return seen[-1][0]

        reset_launch_counts()
        with plant, monkeypatch.context() as mp, torch.no_grad(), \
                torch.autocast("cuda", dtype=torch.bfloat16):
            mp.setattr(S, "window_attention", spy)
            blk(y, (24, 8))
        torch.cuda.synchronize()
        assert launch_counts()["window_attn"] == 1 and len(seen) == 1
        return seen[0]

    sound, _ = run(contextlib.nullcontext())
    fault, (qkv, bias, table, g, heads) = run(evalembed_swin._plant(kind))
    _hold_k9_to_plain(fault, qkv, bias, table, g, heads)
    moved = float((fault.float() - sound.float()).abs().max())
    vmax = float(qkv.view(8, 192, 3, -1)[:, :, 2].abs().max())
    assert moved > 10 * K9_TOL * vmax, (kind, moved, vmax)
