"""The port's gallery mesh (``parallel/``) against the JAX package's on its
8-device virtual CPU mesh, the port on a mesh of 8 CPU shards: the
sharded top-k, the cross-shard row gather and the sharded windowed
re-rank, with inputs made from a seed.

Tolerances: indices equal; distances within 1e-4 (the same fp32 formula
under another matmul blocking, as tests/test_parallel.py holds the JAX
package's sharded against its one-device path); gathered rows bit for bit
against the unsharded rows; re-rank scores within 1e-5."""

import numpy as np
import pytest
import torch

from centroids_reid_tpu.ops.rerank import rerank_topk as jax_rerank_topk
from centroids_reid_tpu.parallel import make_retrieval_mesh as jax_mesh
from centroids_reid_tpu.parallel.mesh import GALLERY_AXIS as JAX_AXIS
from centroids_reid_tpu.parallel.retrieval import (
    make_sharded_row_gather as jax_row_gather,
)
from centroids_reid_tpu.parallel.retrieval import (
    sharded_topk as jax_sharded_topk,
)
from centroids_reid_tpu_torch.ops.rerank import rerank_topk
from centroids_reid_tpu_torch.ops.retrieval import topk_retrieval
from centroids_reid_tpu_torch.parallel import (
    GALLERY_AXIS,
    Mesh,
    local_devices,
    make_retrieval_mesh,
    make_sharded_row_gather,
    shard_width,
    sharded_topk,
    split_rows,
)

CPU8 = ["cpu"] * 8


def _data(seed, q=9, g=403, d=32):
    rng = np.random.RandomState(seed)
    return (rng.randn(q, d).astype(np.float32),
            rng.randn(g, d).astype(np.float32))


@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
@pytest.mark.parametrize("k", [7, 60, 200])
def test_sharded_topk_matches_jax(dist, k):
    """G = 403 is not a multiple of 8. k = 60 exceeds a JAX shard's 51
    rows and k = 200 a port shard's 128; every shard past the fourth holds
    only padding."""
    qf, gf = _data(0)
    val, idx = sharded_topk(qf, gf, k, make_retrieval_mesh(devices=CPU8),
                            dist=dist)
    rval, ridx = jax_sharded_topk(qf, gf, k, jax_mesh(8), dist=dist)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_allclose(val, rval, rtol=1e-4, atol=1e-4)
    one_val, one_idx = topk_retrieval(torch.from_numpy(qf),
                                      torch.from_numpy(gf), k, dist=dist)
    np.testing.assert_array_equal(idx, one_idx)
    np.testing.assert_allclose(val, one_val, rtol=1e-4, atol=1e-4)
    assert val.dtype == np.float32 and idx.dtype == np.int64


def test_sharded_topk_bf16_matches_jax():
    """bf16 inputs score each shard with bf16 products in fp32 (K1 on the
    card), as the JAX package's ``dot_general``: the same indices, and the
    values are those scores."""
    qf, gf = _data(1, g=300)
    qb, gb = (torch.from_numpy(x).bfloat16() for x in (qf, gf))
    val, idx = sharded_topk(qb, gb, 20, make_retrieval_mesh(devices=CPU8))
    import jax.numpy as jnp

    rval, ridx = jax_sharded_topk(
        jnp.asarray(qb.float().numpy(), jnp.bfloat16),
        jnp.asarray(gb.float().numpy(), jnp.bfloat16), 20, jax_mesh(8))
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_allclose(val, rval, rtol=1e-4, atol=1e-4)


def test_sharded_topk_takes_tensors_and_k_beyond_the_gallery():
    """Tensor inputs stay tensors; k beyond G returns all G rows."""
    qf, gf = _data(2, g=40)
    mesh = make_retrieval_mesh(devices=CPU8)
    val, idx = sharded_topk(torch.from_numpy(qf), torch.from_numpy(gf), 50,
                            mesh)
    rval, ridx = jax_sharded_topk(qf, gf, 50, jax_mesh(8))
    assert idx.shape == (9, 40)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_allclose(val, rval, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="Unknown distance"):
        sharded_topk(qf, gf, 5, mesh, dist="manhattan")


@pytest.mark.parametrize("g", [5 * 8, 403])
def test_sharded_row_gather_is_bit_exact(g):
    """In-shard, cross-shard and repeated indices: the gather equals
    ``gf32[idx]`` bit for bit (a -0.0 included) and the JAX package's
    psum gather in value (its sum of zero rows turns -0.0 into +0.0)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.RandomState(3)
    gf = rng.randn(g, 16).astype(np.float32)
    gf[0, 0] = -0.0
    idx = rng.randint(0, g, (7, 9))
    idx[0, 0] = 0
    mesh = make_retrieval_mesh(devices=CPU8)
    width = shard_width(g, 8, 128)
    shards = split_rows(torch.from_numpy(gf), mesh, width)
    out = make_sharded_row_gather(mesh, width)(torch.from_numpy(idx),
                                               shards).numpy()
    assert out.dtype == np.float32
    assert out.tobytes() == gf[idx].tobytes()

    jm = jax_mesh(8)
    n = jm.shape[JAX_AXIS]
    pad = (-g) % n
    gp = np.concatenate([gf, np.zeros((pad, 16), np.float32)])
    gd = jax.device_put(jnp.asarray(gp), NamedSharding(jm, P(JAX_AXIS)))
    ref = np.asarray(jax.jit(jax_row_gather(jm, gp.shape[0] // n))(
        jnp.asarray(idx, jnp.int32), gd))
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("dist", ["euclidean", "cosine"])
def test_sharded_rerank_topk_matches_jax(dist):
    """``rerank_topk(mesh=)`` selects the windows on the sharded gallery
    (``sharded_topk``) and re-ranks them as the one-device path does."""
    qf, gf = _data(4, q=6, g=150, d=16)
    kw = dict(r=30, k1=6, k2=3, lambda_value=0.3, dist=dist)
    d, i = rerank_topk(qf, gf, mesh=make_retrieval_mesh(devices=CPU8), **kw)
    rd, ri = jax_rerank_topk(qf, gf, mesh=jax_mesh(8), use_pallas=False,
                             **kw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=0, atol=1e-5)
    d1, i1 = rerank_topk(qf, gf, device="cpu", **kw)
    np.testing.assert_array_equal(i.numpy(), i1.numpy())
    assert d.device.type == "cpu"


def test_mesh_and_its_helpers():
    """A Mesh is an ordered tuple of devices along ``GALLERY_AXIS`` that
    may repeat a device; ``make_retrieval_mesh`` cuts ``num_devices`` from
    ``devices`` (default: the visible cards, none here); ``split_rows``
    pads the short shards with ``fill``."""
    mesh = make_retrieval_mesh(3, devices=["cpu"] * 5)
    assert mesh.shape == {GALLERY_AXIS: 3} and GALLERY_AXIS == "gallery"
    assert mesh.devices == Mesh(["cpu"] * 3).devices
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert local_devices("cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        assert local_devices("cuda") == []
        with pytest.raises(ValueError, match="no card"):
            make_retrieval_mesh()
    with pytest.raises(ValueError):
        make_retrieval_mesh(6, devices=["cpu"] * 5)
    with pytest.raises(ValueError):
        Mesh([])
    assert shard_width(403, 8, 128) == 128 and shard_width(0, 4) == 1
    assert shard_width(1025, 8, 128) == 256
    parts = split_rows(torch.arange(5.0), mesh, 2, fill=-1.0)
    assert [p.tolist() for p in parts] == [[0, 1], [2, 3], [4, -1]]
    with pytest.raises(ValueError, match="do not fit"):
        split_rows(torch.arange(7.0), mesh, 2)
