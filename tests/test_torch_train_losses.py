"""The port's training losses (``centroids_reid_tpu_torch/losses``) against
the JAX package's on the same inputs, values and gradients (``jax.grad``
against autograd), fp32 on the CPU.

Tolerance: rtol 1e-5, with an absolute floor of 1e-6 of the largest
reference magnitude (entries of a gradient that are zero up to rounding).
A P x K batch with P = 4, K = 4 and mock slots at the tail of a pid's K;
the mock rows' features are identical, as the all-zero mock images give,
so their distances tie exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroids_reid_tpu import losses as JL
from centroids_reid_tpu_torch import losses as TL

P, K, D, C = 4, 4, 8, 10


def _close(got, ref, rtol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=1e-6 * max(np.abs(ref).max(), 1e-30))


def _batch(seed=0, counts=(4, 4, 4, 4), tie_mocks=True):
    """feats [P*K, D], labels [P*K], is_real [P*K]: pid i holds counts[i]
    real slots, the rest are mocks."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(P * K, D).astype(np.float32)
    labels = np.repeat(rng.choice(C, P, replace=False), K).astype(np.int64)
    is_real = np.zeros((P, K), bool)
    for i, c in enumerate(counts):
        is_real[i, :c] = True
    is_real = is_real.reshape(-1)
    if tie_mocks:
        feats[~is_real] = rng.randn(D).astype(np.float32)
    return feats, labels, is_real


def _value_and_grad_torch(fn, *arrays):
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    out.backward()
    return out, [t.grad for t in ts]


@pytest.mark.parametrize("margin", [0.5, None])
@pytest.mark.parametrize("masking", ["none", "anchor", "candidate"])
@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
def test_triplet_matches_jax(margin, masking, dist):
    """Mocks tied with each other; the anchor mask keeps them mining
    candidates, the candidate mask removes them before mining."""
    feats, labels, is_real = _batch(seed=1, counts=(2, 4, 3, 4))
    kw_j, kw_t = {}, {}
    if masking != "none":
        kw_j[masking + "_mask"] = jnp.asarray(is_real)
        kw_t[masking + "_mask"] = torch.from_numpy(is_real)

    def jfn(f):
        return JL.triplet_loss(f, jnp.asarray(labels), margin=margin,
                               dist_func=dist, **kw_j)

    jl, jap, jan = jfn(jnp.asarray(feats))
    jg = jax.grad(lambda f: jfn(f)[0])(jnp.asarray(feats))

    tf = torch.from_numpy(feats.copy()).requires_grad_(True)
    tl, tap, tan = TL.triplet_loss(tf, torch.from_numpy(labels),
                                   margin=margin, dist_func=dist, **kw_t)
    tl.backward()
    _close(tl, jl)
    valid = is_real if masking == "candidate" else np.ones_like(is_real)
    _close(tap.detach()[valid], np.asarray(jap)[valid])
    _close(tan.detach()[valid], np.asarray(jan)[valid])
    _close(tf.grad, jg)


def test_triplet_tied_mocks_share_the_gradient():
    """Four identical mock rows (two of pid 1, two of pid 3) are the
    hardest negatives of anchor 0: amin / amax share each anchor's gradient
    among tied rows evenly, as JAX's min / max, so the two mocks of a pid
    get equal gradients."""
    feats, labels, is_real = _batch(seed=2, counts=(4, 2, 4, 2))
    # the mocks sit nearer anchor 0 than any other row (not so near that
    # the squared-distance expansion cancels)
    feats[~is_real] = feats[0] + 0.3 * np.random.RandomState(7).randn(D)
    jg = jax.grad(lambda f: JL.triplet_loss(
        f, jnp.asarray(labels), anchor_mask=jnp.asarray(is_real))[0])(
        jnp.asarray(feats))
    tf = torch.from_numpy(feats.copy()).requires_grad_(True)
    TL.triplet_loss(tf, torch.from_numpy(labels),
                    anchor_mask=torch.from_numpy(is_real))[0].backward()
    _close(tf.grad, jg)
    mock_grads = tf.grad[torch.from_numpy(~is_real)]
    assert mock_grads.abs().sum() > 0
    torch.testing.assert_close(mock_grads[0], mock_grads[1])
    torch.testing.assert_close(mock_grads[2], mock_grads[3])


@pytest.mark.parametrize("counts", [(4, 4, 4, 4), (2, 3, 4, 4), (2, 2, 3, 2)])
@pytest.mark.parametrize("margin,dist", [(0.5, "euclidean"),
                                         (None, "euclidean"),
                                         (0.5, "cosine")])
def test_ctl_centroid_loss_matches_jax(counts, margin, dist):
    """Real counts per pid from 2 to K; every output and the gradient of
    the loss."""
    feats, labels, is_real = _batch(seed=3, counts=counts)

    def jfn(f):
        return JL.ctl_centroid_loss(f, jnp.asarray(labels),
                                    jnp.asarray(is_real), num_instances=K,
                                    margin=margin, dist_func=dist)

    ref = jfn(jnp.asarray(feats))
    jg = jax.grad(lambda f: jfn(f)["loss"])(jnp.asarray(feats))
    tf = torch.from_numpy(feats.copy()).requires_grad_(True)
    got = TL.ctl_centroid_loss(tf, torch.from_numpy(labels),
                               torch.from_numpy(is_real), num_instances=K,
                               margin=margin, dist_func=dist)
    got["loss"].backward()
    assert set(got) == set(ref)
    for name in ("loss", "dist_ap", "dist_an", "l2_mean_centroid"):
        _close(got[name], ref[name])
    assert int(got["valid_rounds"]) == int(ref["valid_rounds"])
    _close(tf.grad, jg)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_label_smooth_matches_jax(masked):
    rng = np.random.RandomState(4)
    logits = rng.randn(P * K, C).astype(np.float32) * 3
    labels = rng.randint(0, C, P * K)
    mask = rng.rand(P * K) > 0.3
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None

    def jfn(x):
        return JL.cross_entropy_label_smooth(x, jnp.asarray(labels), C,
                                             mask=jm)

    out, (grad,) = _value_and_grad_torch(
        lambda x: TL.cross_entropy_label_smooth(
            x, torch.from_numpy(labels), C, mask=tm), logits)
    _close(out, jfn(jnp.asarray(logits)))
    _close(grad, jax.grad(jfn)(jnp.asarray(logits)))


@pytest.mark.parametrize("masked", [False, True])
def test_center_loss_matches_jax(masked):
    rng = np.random.RandomState(5)
    feats = rng.randn(P * K, D).astype(np.float32)
    centers = rng.randn(C, D).astype(np.float32)
    labels = rng.randint(0, C, P * K)
    mask = rng.rand(P * K) > 0.3
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None

    def jfn(f, c):
        return JL.center_loss(f, jnp.asarray(labels), c, mask=jm)

    out, (gf, gc) = _value_and_grad_torch(
        lambda f, c: TL.center_loss(f, torch.from_numpy(labels), c, mask=tm),
        feats, centers)
    jgf, jgc = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(feats),
                                             jnp.asarray(centers))
    _close(out, jfn(jnp.asarray(feats), jnp.asarray(centers)))
    _close(gf, jgf)
    _close(gc, jgc)


def test_init_centers_draws_from_the_generator():
    a = TL.init_centers(torch.Generator().manual_seed(3), C, D)
    b = TL.init_centers(torch.Generator().manual_seed(3), C, D)
    assert a.shape == (C, D) and a.dtype == torch.float32
    assert torch.equal(a, b)
    big = TL.init_centers(torch.Generator().manual_seed(0), 100, 100)
    assert abs(big.mean().item()) < 0.05 and abs(big.std().item() - 1) < 0.05


@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
def test_training_distances_match_jax(dist):
    rng = np.random.RandomState(6)
    x = rng.randn(5, D).astype(np.float32)
    y = rng.randn(7, D).astype(np.float32)
    ref = JL.get_dist_func(dist)(jnp.asarray(x), jnp.asarray(y))
    got = TL.get_dist_func(dist)(torch.from_numpy(x), torch.from_numpy(y))
    _close(got, ref)
    _close(TL.l2_normalize(torch.from_numpy(x)),
           JL.distances.l2_normalize(jnp.asarray(x)))
