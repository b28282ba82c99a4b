"""Spherical k-means and the cluster cross-entropy of the port
(sm3x_torch.ops.kmeans, sm3x_torch.losses.cluster_ce) against the JAX
package on the same numpy embeddings, on the CPU.

The two frameworks draw different permutations from a seed, so the port
gets its initial rows from `jax.random.permutation` of the key the JAX
function uses. In float32 the assignments must be equal and the centroids
within rtol 1e-5 (sums in another order); in float64 (the JAX side under
`jax.enable_x64`, whose `spherical_kmeans` still computes in float32) the
port's float64 run must give the same assignment pattern.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sm3x.losses import cluster_ce as jax_cluster_ce
from sm3x.ops import kmeans as jk
from sm3x_torch.losses import cluster_ce
from sm3x_torch.ops.kmeans import scatter_assignments, spherical_kmeans

torch.set_num_threads(2)


def _blobs(rng, n, d, k):
    """Unit rows around k well-separated directions."""
    centres = rng.standard_normal((k, d)).astype(np.float32)
    x = centres[rng.integers(0, k, n)] + 0.3 * rng.standard_normal(
        (n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n,d,k,iters", [(200, 16, 5, 10), (64, 8, 3, 10),
                                         (50, 12, 2, 0), (300, 32, 5, 3)])
def test_kmeans_matches_jax_from_the_same_initial_rows(rng_np, n, d, k, iters):
    emb = _blobs(rng_np, n, d, k)
    key = jax.random.key(n + k)
    cent_w, a_w = jk.spherical_kmeans(key, jnp.asarray(emb), k, iters)
    init = np.array(jax.random.permutation(key, n))[:k]
    cent, a = spherical_kmeans(torch.from_numpy(emb), k, iters,
                               init_idx=torch.from_numpy(init))
    assert a.dtype == torch.int64 and cent.dtype == torch.float32
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_w))
    np.testing.assert_allclose(cent.numpy(), np.asarray(cent_w), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(cent.norm(dim=1).numpy(), 1.0, rtol=1e-6)
    # float64 gives the same pattern of assignments
    _, a64 = spherical_kmeans(torch.from_numpy(emb).double(), k, iters,
                              init_idx=torch.from_numpy(init))
    np.testing.assert_array_equal(a64.numpy(), np.asarray(a_w))


def test_kmeans_draws_distinct_initial_rows_from_the_generator():
    emb = torch.from_numpy(_blobs(np.random.default_rng(0), 40, 8, 4))
    runs = [spherical_kmeans(emb, 4, 0, generator=torch.Generator()
                             .manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert not torch.equal(runs[0][0], runs[2][0])
    # zero iterations: the centroids are the chosen rows themselves, all
    # distinct rows of the data
    rows = {tuple(r.tolist()) for r in emb}
    picked = [tuple(c.tolist()) for c in runs[0][0]]
    assert len(set(picked)) == 4 and set(picked) <= rows


def test_empty_cluster_keeps_its_centroid():
    """Two initial rows that are the same point: the first wins every tie of
    the E-step, so the second cluster is empty in the M-step and keeps its
    centroid, as in the JAX package's loop body."""
    rng = np.random.default_rng(3)
    emb = _blobs(rng, 30, 6, 2)
    emb[1] = emb[0]
    init = np.array([0, 1, 2])
    cent, _ = spherical_kmeans(torch.from_numpy(emb), 3, 1,
                               init_idx=torch.from_numpy(init))
    np.testing.assert_allclose(cent[1].numpy(), emb[1], rtol=1e-6, atol=1e-7)
    assert not np.allclose(cent[0].numpy(), emb[0], atol=1e-3)

    c = jnp.asarray(emb[init])
    a_j = jnp.argmax(jnp.asarray(emb) @ c.T, axis=1)
    assert 1 not in set(np.asarray(a_j).tolist())
    one_hot = jax.nn.one_hot(a_j, 3, dtype=jnp.float32)
    counts = one_hot.sum(0)
    mean = (one_hot.T @ jnp.asarray(emb)) / jnp.maximum(counts, 1.0)[:, None]
    c = jnp.where((counts > 0)[:, None], mean, c)
    c = c / jnp.maximum(jnp.linalg.norm(c, axis=1, keepdims=True), 1e-12)
    np.testing.assert_allclose(cent.numpy(), np.asarray(c), rtol=1e-5,
                               atol=1e-7)


def test_scatter_assignments_matches_jax(rng_np):
    idx = rng_np.permutation(20)[:7]
    a = rng_np.integers(0, 5, 7)
    got = scatter_assignments(torch.from_numpy(a), torch.from_numpy(idx), 20)
    want = jk.scatter_assignments(jnp.asarray(a), jnp.asarray(idx), 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got == -100).sum()) == 13


@pytest.mark.parametrize("ignored", [0, 3, 10])
@pytest.mark.parametrize("temperature", [1.0, 0.1])
def test_cluster_ce_matches_jax(rng_np, ignored, temperature):
    """With no, some and only ignored (-100) rows: those are in neither the
    numerator nor the denominator, and the denominator is at least 1."""
    logits = rng_np.standard_normal((10, 5)).astype(np.float32)
    target = rng_np.integers(0, 5, 10)
    target[:ignored] = -100
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = cluster_ce(lt, torch.from_numpy(target), temperature)
    want, grad = jax.value_and_grad(
        lambda x: jax_cluster_ce(x, jnp.asarray(target), temperature))(
            jnp.asarray(logits))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-7)
    got.backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(grad), rtol=1e-5,
                               atol=1e-7)
    if ignored == 10:
        assert float(got.detach()) == 0.0
