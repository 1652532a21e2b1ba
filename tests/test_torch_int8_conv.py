"""The plain versions of K5 and K6 (centroids_reid_tpu_torch/ops/
int8_conv.py) against the JAX package's fused kernels in interpret mode,
and against a numpy oracle that computes the epilogue op by op.

Tolerances: the accumulators are exact integers in both packages. The port
computes the epilogue op by op (as its CUDA kernels do, so the card can
require equality), and equals the numpy oracle exactly. XLA's CPU compiler
contracts the reference epilogue's ``acc * scale + bias`` into one fused
multiply-add, which rounds once instead of twice, so against the JAX
kernels the reference test's bound holds: at most one quantum, on under 1%
of the elements."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroids_reid_tpu.ops import int8_conv as J
from centroids_reid_tpu_torch.ops import int8_conv as R


def _oracle(acc, scale, bias, relu, res=None, res_scale=None):
    """The epilogue in numpy fp32, one rounding per operation."""
    t = acc.astype(np.float32) * scale + bias
    if res is not None:
        t = t + res.astype(np.float32) * np.float32(res_scale)
    if relu:
        t = np.minimum(np.maximum(t, np.float32(0)), np.float32(127)) \
            + np.float32(0.5)
    else:
        t = np.clip(t, np.float32(-127), np.float32(127))
        t = t + np.where(t >= 0, np.float32(0.5), np.float32(-0.5))
    return np.trunc(t).astype(np.int8)


def _within_one_quantum(got, ref):
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).mean() < 1e-2, (diff != 0).mean()


def _epilogue_inputs(rng, n, with_res, shape):
    scale = rng.uniform(0.0005, 0.004, n).astype(np.float32)
    bias = rng.uniform(-20, 20, n).astype(np.float32)
    res = (rng.randint(-127, 128, shape).astype(np.int8) if with_res
           else None)
    return scale, bias, res, (np.float32(0.7) if with_res else None)


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_res", [True, False])
def test_matmul_requant_plain(relu, with_res):
    rng = np.random.RandomState(0)
    m, k, n = 256, 64, 128
    x = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    scale, bias, res, rs = _epilogue_inputs(rng, n, with_res, (m, n))
    R.reset_launch_counts()
    got = R.matmul_requant(_t(x), _t(w), _t(scale), _t(bias), res=_t(res),
                           res_scale=rs, relu=relu).numpy()
    assert R.LAUNCHES == {"matmul_requant": 0, "conv3x3_requant": 0}
    acc = x.astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(got, _oracle(acc, scale, bias, relu, res,
                                               rs))
    ref = J.matmul_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
        res=None if res is None else jnp.asarray(res), res_scale=rs,
        relu=relu, interpret=True)
    _within_one_quantum(got, np.asarray(ref))


def _conv_acc(x, w):
    """Exact int64 stride-1 pad-1 3x3 conv, NHWC x HWIO."""
    b, h, wd, _ = x.shape
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((b, h, wd, w.shape[3]), np.int64)
    for dh in range(3):
        for dw in range(3):
            acc += xp[:, dh:dh + h, dw:dw + wd, :] @ w[dh, dw].astype(np.int64)
    return acc


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("with_res", [True, False])
@pytest.mark.parametrize("bhw", [(2, 8, 4), (1, 16, 8)])
def test_conv3x3_requant_plain(relu, with_res, bhw):
    rng = np.random.RandomState(1)
    b, h, wd = bhw
    k, n = 32, 64
    x = rng.randint(-127, 128, (b, h, wd, k)).astype(np.int8)
    w = rng.randint(-127, 128, (3, 3, k, n)).astype(np.int8)
    scale, bias, res, rs = _epilogue_inputs(rng, n, with_res, (b, h, wd, n))
    got = R.conv3x3_requant(_t(x), _t(w), _t(scale), _t(bias),
                            res_nhwc=_t(res), res_scale=rs, relu=relu).numpy()
    np.testing.assert_array_equal(
        got, _oracle(_conv_acc(x, w), scale, bias, relu, res, rs))
    ref = J.conv3x3_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
        res_nhwc=None if res is None else jnp.asarray(res), res_scale=rs,
        relu=relu, interpret=True)
    _within_one_quantum(got, np.asarray(ref))


def test_conv3x3_multi_image_tiles_do_not_leak():
    """Two images with very different content, convolved together, give
    what each gives alone: the zero padding holds at every image border
    (the reference's tests/test_int8_conv.py case, on the port and on the
    JAX kernel)."""
    rng = np.random.RandomState(2)
    k, n, h, wd = 32, 32, 8, 4
    w = rng.randint(-8, 8, (3, 3, k, n)).astype(np.int8)
    scale = np.full(n, 1e-4, np.float32)
    bias = np.zeros(n, np.float32)
    a = rng.randint(-127, 128, (1, h, wd, k)).astype(np.int8)
    bimg = rng.randint(-127, 128, (1, h, wd, k)).astype(np.int8)

    def run(x):
        return R.conv3x3_requant(_t(x), _t(w), _t(scale), _t(bias)).numpy()

    together = run(np.concatenate([a, bimg]))
    np.testing.assert_array_equal(np.concatenate([run(a), run(bimg)]),
                                  together)
    ref = J.conv3x3_requant(jnp.asarray(np.concatenate([a, bimg])),
                            jnp.asarray(w), jnp.asarray(scale),
                            jnp.asarray(bias), interpret=True)
    np.testing.assert_array_equal(together, np.asarray(ref))


def test_epilogue_rounds_half_away_from_zero_and_clips():
    """Boundary values of the epilogue: +-0.5 rounds away from zero, values
    beyond +-127 clip, ReLU maps negatives to 0."""
    acc = torch.tensor([[0, 1, -1, 3, -3, 1000, -1000, 5]], dtype=torch.int32)
    scale = torch.tensor([1.0, 0.5, 0.5, 0.5, 0.5, 1.0, 1.0, 0.3])
    bias = torch.zeros(8)
    got = R._epilogue_plain(acc, scale, bias, relu=False)
    assert got.tolist() == [[0, 1, -1, 2, -2, 127, -127, 2]]
    got = R._epilogue_plain(acc, scale, bias, relu=True)
    assert got.tolist() == [[0, 1, 0, 2, 0, 127, 0, 2]]
