"""The retrieval kernels on the card, each against its plain version.

Needs an NVIDIA GPU and nvcc; every test skips without a GPU. This file
imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Integer-valued bf16 inputs make every dot product an exact fp32 integer,
so K1 and K2 must equal their plain versions bit for bit; K3 is exact by
construction."""

import numpy as np
import pytest
import torch

from centroids_reid_tpu_torch.ops import retrieval as R

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
