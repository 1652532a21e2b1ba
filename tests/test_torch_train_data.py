"""The port's training data against the JAX package's, on the CPU: the
P x K sampler's plans bit for bit, ``TrainLoader`` batches and
``plan_to_arrays`` equal, and the on-card augmentation.

The augmentation's draws cannot equal ``jax.random``'s stream, so parity is
held on ``apply_augment``: the test rebuilds the JAX draws from the key by
repeating ``_augment_one``'s splits, and ``apply_augment`` on them must
equal JAX ``augment_batch`` (atol 1e-6, mocks exactly zero). The port's own
draws must pass the placement statistics that
``tests/test_data.py::test_random_erase_placement_statistics`` asks of the
JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu.data import datasets as JD
from centroids_reid_tpu.data import device_data as JDD
from centroids_reid_tpu.data import loader as JLD
from centroids_reid_tpu.data import sampler as JS
from centroids_reid_tpu.data import transforms as JT
from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.data import datasets as TD
from centroids_reid_tpu_torch.data import device_data as TDD
from centroids_reid_tpu_torch.data import loader as TLD
from centroids_reid_tpu_torch.data import sampler as TS
from centroids_reid_tpu_torch.data import transforms as TT

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _train_dict(record_cls, counts):
    out, idx = {}, 0
    for pid, n in enumerate(counts):
        out[pid] = []
        for _ in range(n):
            out[pid].append(record_cls(f"img{idx}.jpg", pid, 0, idx))
            idx += 1
    return out


COUNTS = [2, 3, 4, 5, 6, 7, 9, 2, 13, 4, 5, 3, 8, 2, 11, 6]


@pytest.mark.parametrize("resampling", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("p,k", [(4, 4), (3, 2)])
def test_epoch_plan_equals_jax(resampling, groups, p, k):
    jd, td = _train_dict(JD.Record, COUNTS), _train_dict(TD.Record, COUNTS)
    assert (TS.max_steps_bound(td, p, k, groups)
            == JS.max_steps_bound(jd, p, k, groups))
    for epoch in range(4):
        ref = JS.build_epoch_plan(jd, p, k, groups, epoch, resampling)
        got = TS.build_epoch_plan(td, p, k, groups, epoch, resampling)
        assert got.num_steps == ref.num_steps > 0
        for name in ("pids", "sample_idx", "is_real"):
            a, b = getattr(got, name), getattr(ref, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert TS.occurrences_per_pid(5, 4) == JS.occurrences_per_pid(5, 4) == 1


def _write_market(root, counts, hw=(32, 16), seed=0):
    base = root / "market1501"
    rng = np.random.RandomState(seed)
    for sub in ("bounding_box_train", "query", "bounding_box_test"):
        (base / sub).mkdir(parents=True)
    for pid, n in enumerate(counts):
        for i in range(n):
            Image.fromarray(rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
                            ).save(base / "bounding_box_train"
                                   / f"{pid + 1:04d}_c{i % 6 + 1}s1_{i:06d}_00.jpg")
        for sub, cam in (("query", 1), ("bounding_box_test", 2)):
            Image.fromarray(rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
                            ).save(base / sub / f"{pid + 1:04d}_c{cam}s1_"
                                   f"{100:06d}_00.jpg")
    return str(root)


@pytest.fixture(scope="module")
def market(tmp_path_factory):
    root = _write_market(tmp_path_factory.mktemp("train_data"), COUNTS[:10])

    def cfgs(resampling):
        out = []
        for make in (jax_default_cfg, get_default_cfg):
            cfg = make()
            cfg.DATASETS.ROOT_DIR = root
            cfg.INPUT.SIZE_TRAIN = [32, 16]
            cfg.SOLVER.IMS_PER_BATCH = 3
            cfg.DATALOADER.NUM_INSTANCE = 4
            cfg.DATALOADER.USE_RESAMPLING = resampling
            out.append(cfg)
        return out

    return cfgs


@pytest.mark.parametrize("resampling", [False, True])
def test_train_loader_and_plan_arrays_equal_jax(market, resampling):
    jcfg, tcfg = market(resampling)
    jds, tds = (JD.init_dataset("market1501", jcfg),
                TD.init_dataset("market1501", tcfg))
    jl = JLD.TrainLoader(jds, jcfg, num_groups=1)
    tl = TLD.TrainLoader(tds, tcfg)
    for epoch in (0, 3):
        got = list(tl.epoch(epoch))
        ref = list(jl.epoch(epoch))
        assert len(got) == len(ref) == tl.plan_for_epoch(epoch).num_steps > 0
        for g, r in zip(got, ref):
            for name in ("images", "labels", "camids", "is_real"):
                assert np.array_equal(g[name], r[name][0]), name
            assert not g["images"][~g["is_real"]].any()
        plan = tl.plan_for_epoch(epoch)
        for a, b in zip(TDD.plan_to_arrays(plan, tds.train),
                        JDD.plan_to_arrays(jl.plan_for_epoch(epoch),
                                           jds.train)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert TDD.bank_size_mb(tds.train, (32, 16)) == JDD.bank_size_mb(
        jds.train, (32, 16))
    bank = TDD.build_image_bank(tds.train, (32, 16))
    assert np.array_equal(bank, JDD.build_image_bank(jds.train, (32, 16)))


def test_train_loader_raises_the_producers_error(market):
    _, tcfg = market(False)
    tl = TLD.TrainLoader(TD.init_dataset("market1501", tcfg), tcfg)
    tl._records = tl._records[:1]
    with pytest.raises(IndexError):
        list(tl.epoch(0))


def _jax_draws(key, n, size_hw, padding):
    """The draws of JAX ``augment_batch``, rebuilt by repeating
    ``_augment_one``'s splits."""
    h, w = size_hw

    def one(rng):
        k_flip, k_crop, k_erase = jax.random.split(rng, 3)
        off = jax.random.randint(k_crop, (2,), 0, 2 * padding + 1)
        ks = jax.random.split(k_erase, 4)
        area = jax.random.uniform(ks[1], (TT._N_ERASE_DRAWS,), minval=0.02,
                                  maxval=0.4) * (h * w)
        aspect = jax.random.uniform(ks[2], (TT._N_ERASE_DRAWS,), minval=0.3,
                                    maxval=1.0 / 0.3)
        ky, kx = jax.random.split(ks[3])
        return (jax.random.uniform(k_flip), off, jax.random.uniform(ks[0]),
                area, aspect, jax.random.uniform(ky), jax.random.uniform(kx))

    out = jax.jit(jax.vmap(one))(jax.random.split(key, n))
    return [torch.from_numpy(np.array(a)) for a in out]


@pytest.mark.parametrize("flip_p,re_p", [(0.5, 0.5), (1.0, 1.0), (0.0, 0.0)])
@pytest.mark.parametrize("size_hw,padding", [((32, 16), 10), ((24, 20), 3)])
def test_apply_augment_on_jax_draws_equals_jax(flip_p, re_p, size_hw,
                                              padding):
    n = 24
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (n, *size_hw, 3)).astype(np.uint8)
    is_real = rng.rand(n) > 0.2
    key = jax.random.PRNGKey(11)
    ref = np.asarray(JT.augment_batch(
        jnp.asarray(imgs), jnp.asarray(is_real), key, size_hw, padding, MEAN,
        STD, flip_p, re_p))
    flip_u, off, erase_u, area, aspect, uy, ux = _jax_draws(key, n, size_hw,
                                                            padding)
    rect, any_valid = TT.erase_rectangles(area, aspect, uy, ux, size_hw)
    params = TT.AugmentParams(flip_u < flip_p, off.long(),
                              (erase_u < re_p) & any_valid, rect)
    got = TT.apply_augment(torch.from_numpy(imgs), torch.from_numpy(is_real),
                           params, padding, MEAN, STD).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert not got[~is_real].any()
    if re_p == 1.0:
        assert bool(params.erase.any())


def test_port_draws_pass_the_erase_placement_statistics():
    """``test_random_erase_placement_statistics`` on the port's own draws:
    every image erased at p = 1, about half at p = 0.5 with the same
    rectangles, corners uniform over the valid positions."""
    n, h, w = 256, 32, 16
    imgs = torch.full((n, h, w, 3), 255, dtype=torch.uint8)
    is_real = torch.ones(n, dtype=torch.bool)

    def run(re_p):
        out = TT.augment_batch(imgs, is_real, torch.Generator().manual_seed(7),
                               (h, w), 0, MEAN, STD, 0.0, re_p)
        return np.isclose(out.numpy()[..., 0], MEAN[0], atol=1e-5)

    m1, m5 = run(1.0), run(0.5)
    assert m1.any(axis=(1, 2)).all()
    erased5 = m5.any(axis=(1, 2))
    assert 0.35 < erased5.mean() < 0.65, erased5.mean()
    np.testing.assert_array_equal(m5[erased5], m1[erased5])
    ys, xs = [], []
    for i in range(n):
        rows = np.where(m1[i].any(axis=1))[0]
        cols = np.where(m1[i].any(axis=0))[0]
        ys.append(rows[0] / max(h - len(rows), 1))
        xs.append(cols[0] / max(w - len(cols), 1))
    assert abs(np.mean(ys) - 0.5) < 0.08, np.mean(ys)
    assert abs(np.mean(xs) - 0.5) < 0.08, np.mean(xs)
    assert np.std(ys) > 0.15 and np.std(xs) > 0.15


def test_draws_follow_the_generator_and_flip_and_crop_move_pixels():
    params = TT.draw_augment_params(64, torch.Generator().manual_seed(1),
                                    (32, 16), 10, 0.5, 0.5)
    again = TT.draw_augment_params(64, torch.Generator().manual_seed(1),
                                   (32, 16), 10, 0.5, 0.5)
    for a, b in zip(params, again):
        assert torch.equal(a, b)
    assert params.offset.min() >= 0 and params.offset.max() <= 20
    assert 0.3 < params.flip.float().mean() < 0.7
    y0, x0, eh, ew = params.rect.unbind(1)
    assert ((y0 + eh <= 32) & (x0 + ew <= 16)).all()
    # no padding, no erase: the flip alone mirrors the normalised image
    img = torch.arange(32 * 16 * 3, dtype=torch.int64).reshape(
        1, 32, 16, 3).remainder(256).to(torch.uint8)
    flip = TT.AugmentParams(torch.tensor([True]), torch.zeros(1, 2).long(),
                            torch.tensor([False]), torch.zeros(1, 4).long())
    got = TT.apply_augment(img, torch.tensor([True]), flip, 0, MEAN, STD)
    plain = TT.normalize_batch(img, MEAN, STD)
    assert torch.equal(got, plain.flip(2))
    bf16 = TT.apply_augment(img, torch.tensor([True]), flip, 0, MEAN, STD,
                            dtype=torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
