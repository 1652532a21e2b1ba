"""The CUDA kernels on the card, each against its plain version.

Needs an NVIDIA GPU and nvcc; every test skips without a GPU. This file
imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Integer-valued bf16 inputs make every dot product an exact fp32 integer,
so K1, K2 and K4 must equal their plain versions bit for bit; K3 is exact
by construction; K5 and K6 accumulate exactly in int32 and round their
epilogue op by op, so they equal their plain versions bit for bit."""

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


def test_scores_kernel_exact(cuda):
    q, g, gn = _inputs(cuda)
    R.reset_launch_counts()
    assert torch.equal(R.scores(q, g, gn), R.scores_plain(q, g, gn))
    torch.cuda.synchronize()
    assert R.LAUNCHES["scores"] == 1


@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("g", [4096, 4224])   # 4224: a ragged last split
def test_stream_topk_kernel_exact(cuda, k, g):
    q, gal, gn = _inputs(cuda, g=g, real=g - 96)
    v, i = R.stream_topk(q, gal, gn, k)
    rv, ri = R.stream_topk_plain(q, gal, gn, k)
    assert torch.equal(i, ri) and torch.equal(v, rv)


def test_stream_topk_kernel_sparse_rows(cuda):
    """Fewer finite columns than k: the tail takes (+inf, column 0), as
    the TPU kernel's initial entries do."""
    q, g, gn = _inputs(cuda)
    gn[:] = float("inf")
    gn[0, 7:27:2] = 1.0
    v, i = R.stream_topk(q, g, gn, 32)
    rv, ri = R.stream_topk_plain(q, g, gn, 32)
    assert torch.equal(i, ri) and torch.equal(v, rv)


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
