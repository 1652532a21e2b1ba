"""The launch plan and weight layout of the fused int8 kernels K5 / K6
(centroids_reid_tpu_torch/ops/int8_conv.py), on the CPU: the split-K plan
over the embed's shapes, and the K-major packing that 8-bit wgmma needs.
The kernels themselves run in tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from centroids_reid_tpu_torch.ops import int8_conv as C

SMS = 132   # H100 SXM


def _tiles(m, n, bn):
    return -(-m // C._M_TILE) * (n // bn)


# (M, K, N, taps): every K5 and K6 shape of a ResNet-50 embed call at 8
# images of 256x128 (M = 1024 from layer 3 on), the deep ones at 256 images
EMBED_SHAPES = [
    (16384, 64, 64, 1), (16384, 64, 256, 1), (16384, 256, 64, 1),
    (16384, 256, 128, 1), (4096, 128, 512, 1), (4096, 256, 512, 1),
    (4096, 512, 128, 1), (4096, 512, 256, 1), (1024, 256, 1024, 1),
    (1024, 512, 1024, 1), (1024, 1024, 256, 1), (1024, 1024, 512, 1),
    (1024, 512, 2048, 1), (1024, 1024, 2048, 1), (1024, 2048, 512, 1),
    (16384, 64, 64, 9), (4096, 128, 128, 9), (1024, 256, 256, 9),
    (1024, 512, 512, 9), (32768, 512, 512, 9), (524288, 64, 64, 9),
    (32768, 2048, 512, 1),
]


@pytest.mark.parametrize("m,k,n,taps", EMBED_SHAPES)
def test_requant_plan_fills_at_most_one_wave(m, k, n, taps):
    """Splits of 1 or 2 whose clustered blocks fit one per SM, each with at
    least 8 pipeline stages; doubled until one of those limits would break
    (so 1 where M alone fills half the card or more)."""
    stages = C._stages(k, taps)
    bn, splits = C._requant_plan(m, n, stages, SMS)
    assert bn == (128 if n % 128 == 0 else 64)
    tiles = _tiles(m, n, bn)
    assert splits in (1, 2) and splits <= C._max_splits(bn, stages)
    if splits > 1:
        assert tiles * splits <= SMS and stages // splits >= 8
    if 2 * tiles > SMS:
        assert splits == 1
    grow = 2 * splits
    assert (grow > 2 or grow * tiles > SMS or stages // grow < 8)


@pytest.mark.parametrize("m,k,n,taps,want", [
    (1024, 256, 256, 9, (128, 2)),     # layer 3's 3x3: 16 tiles, 18 stages
    (1024, 512, 512, 9, (128, 2)),     # layer 4's 3x3: 32 tiles, 36 stages
    (4096, 128, 128, 9, (128, 1)),     # layer 2's 3x3: 9 stages
    (1024, 1024, 256, 1, (128, 1)),    # layer 3's conv1: 8 stages
    (1024, 2048, 512, 1, (128, 2)),    # layer 4's conv1: 16 stages
    (4096, 512, 128, 1, (128, 1)),
    (1024, 256, 1024, 1, (128, 1)),
    (1024, 1024, 2048, 1, (128, 1)),   # layer 4's downsample: 128 tiles
    (16384, 64, 64, 9, (64, 1)),       # layer 1: M alone fills the card
    (16384, 256, 64, 1, (64, 1)),
    (524288, 64, 256, 1, (128, 1)),    # batch 256
    (32768, 512, 512, 9, (128, 1)),
    (300, 192, 128, 1, (128, 1)),      # 2 stages: too few to split
    (1000, 192, 64, 9, (64, 2)),       # 8 tiles, 18 stages
])
def test_requant_plan_at_named_shapes(m, k, n, taps, want):
    assert C._requant_plan(m, n, C._stages(k, taps), SMS) == want


def test_requant_plan_on_a_smaller_card():
    """The plan follows the SM count it is given."""
    assert C._requant_plan(1024, 256, 18, 132) == (128, 2)
    assert C._requant_plan(1024, 256, 18, 32) == (128, 2)
    assert C._requant_plan(1024, 256, 18, 16) == (128, 1)


@pytest.mark.parametrize("k,taps,want", [(64, 1, 1), (64, 9, 9), (128, 1, 1),
                                         (192, 1, 2), (512, 9, 36)])
def test_stages(k, taps, want):
    assert C._stages(k, taps) == want


@pytest.mark.parametrize("bn,stages,want", [
    (128, 1, 1), (128, 3, 2), (128, 5, 4), (128, 36, 8), (64, 36, 4),
    (64, 2, 2)])
def test_max_splits(bn, stages, want):
    assert C._max_splits(bn, stages) == want


@pytest.mark.parametrize("shape", [(64, 128), (256, 64), (3, 3, 64, 128),
                                   (3, 3, 128, 64)])
def test_pack_weight_round_trip(shape):
    """Packed K-major, then read back: the weight as it was, and each
    packed row holds one output channel's K weights of one tap."""
    rng = np.random.RandomState(sum(shape))
    w = torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
    p = C.pack_weight(w)
    k, n = shape[-2:]
    assert p.is_contiguous()
    if len(shape) == 2:
        assert tuple(p.shape) == (n, k)
        assert torch.equal(p[5], w[:, 5])
    else:
        assert tuple(p.shape) == (9, n, k)
        assert torch.equal(p[7, 3], w[2, 1, :, 3])   # tap 7 = (dh 1, dw 0)
    assert torch.equal(C.unpack_weight(p), w)


def test_pack_weight_refuses_other_layouts():
    with pytest.raises(ValueError, match="K-major"):
        C.pack_weight(torch.zeros((1, 1, 64, 64), dtype=torch.int8))


@pytest.mark.parametrize("relu,with_res", [(True, True), (False, False)])
def test_plain_versions_read_packed_weights(relu, with_res):
    """On the CPU a wrapper given ``w_packed`` computes from it: equal to
    the same call on the unpacked weight."""
    rng = np.random.RandomState(3)

    def t(a):
        return torch.from_numpy(a)

    x = t(rng.randint(-127, 128, (2, 5, 7, 64)).astype(np.int8))
    w = t(rng.randint(-127, 128, (3, 3, 64, 128)).astype(np.int8))
    scale = t(rng.uniform(0.0002, 0.002, 128).astype(np.float32))
    bias = t(rng.uniform(-20, 20, 128).astype(np.float32))
    res = t(rng.randint(-127, 128, (2, 5, 7, 128)).astype(np.int8)) \
        if with_res else None
    rs = torch.tensor(0.37) if with_res else None
    ref = C.conv3x3_requant(x, w, scale, bias, res, rs, relu)
    got = C.conv3x3_requant(x, w, scale, bias, res, rs, relu,
                            w_packed=C.pack_weight(w))
    assert torch.equal(got, ref)
    x2 = x.reshape(70, 64)
    w2 = w[1, 1].contiguous()
    res2 = None if res is None else res.reshape(70, 128)
    ref = C.matmul_requant(x2, w2, scale, bias, res2, rs, relu)
    got = C.matmul_requant(x2, w2, scale, bias, res2, rs, relu,
                           w_packed=C.pack_weight(w2))
    assert torch.equal(got, ref)
    # a packed weight that is not the one named reads as given
    assert not torch.equal(
        C.matmul_requant(x2, w2, scale, bias, res2, rs, relu,
                         w_packed=C.pack_weight(w[0, 0].contiguous())), ref)
