"""plr2_tpu_torch.ops.knn against the JAX package.

On the CPU the wrappers run their plain twins (the CUDA kernels of
csrc/knn.cu are held against those twins on the card by chip_smoke.py,
indices exactly). Here the twins are held against the JAX Pallas kernels in
interpret mode, against brute force, and the distances and their gradients
against `nn_distance_pallas` and `nn_distance_xla`.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plr2_tpu.ops import knn as jknn
from plr2_tpu.ops.pallas_knn import (nn_argmin_pallas, nn_distance_pallas,
                                     nn_match_pallas)
from plr2_tpu_torch.ops import knn, launch_counts

torch.set_num_threads(2)


def _points(rng, *shape, scale=1.0):
    return (rng.normal(size=shape + (3,)) * scale).astype(np.float32)


def _brute_index(pred, target):
    return ((pred[:, None, :] - target[None]) ** 2).sum(-1).argmin(-1)


# 700 x 130 as tests/test_pallas.py; 130 and 333 are not multiples of 128
@pytest.mark.parametrize("p,m2", [(700, 130), (257, 333)])
def test_plain_match_and_argmin_equal_pallas_kernels(rng, p, m2):
    pred, target = _points(rng, p), _points(rng, m2)
    want_idx = np.asarray(nn_argmin_pallas(jnp.asarray(pred),
                                           jnp.asarray(target), interpret=True))
    want = np.asarray(nn_match_pallas(jnp.asarray(pred), jnp.asarray(target),
                                      interpret=True))
    got_idx = knn.nn_argmin(torch.from_numpy(pred), torch.from_numpy(target))
    got = knn.nn_match(torch.from_numpy(pred), torch.from_numpy(target))
    assert got_idx.dtype == torch.int64 and got_idx.shape == (p,)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    # the same target rows: coordinates are copies, exact up to 1e-6
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.numpy(), target[got_idx.numpy()])


def test_plain_mxu_twin_equals_bruteforce(rng):
    """As test_pallas.py:24: coordinates at 0.1 scale, where the product
    form's cancellation leaves the choice intact."""
    pred, target = _points(rng, 700, scale=0.1), _points(rng, 130, scale=0.1)
    got = knn.nn_match_mxu(torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(got.numpy(), target[_brute_index(pred, target)],
                               atol=1e-5)


@pytest.mark.parametrize("fn", ["nn_match", "nn_match_mxu", "nn_argmin"])
def test_first_index_wins_ties(fn):
    target = np.array([[1.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0],
                       [1.0, 0, 0]], np.float32)
    pred = np.array([[1.1, 0, 0], [5.0, 0, 0], [0.0, 0, 0]], np.float32)
    got = getattr(knn, fn)(torch.from_numpy(pred), torch.from_numpy(target))
    if fn == "nn_argmin":
        np.testing.assert_array_equal(got.numpy(), [0, 2, 0])
    else:
        np.testing.assert_array_equal(got.numpy(), target[[0, 2, 0]])


def test_batched_equals_per_sample(rng, monkeypatch):
    """One (S, P, 3) x (S, M2, 3) call equals S unbatched calls, also
    across the twins' query-row blocks (CHUNK shrunk to split P)."""
    monkeypatch.setattr(knn, "CHUNK", 64)
    pred, target = _points(rng, 3, 90), _points(rng, 3, 41)
    for fn in (knn.nn_match, knn.nn_match_mxu, knn.nn_argmin):
        got = fn(torch.from_numpy(pred), torch.from_numpy(target))
        for s in range(3):
            one = fn(torch.from_numpy(pred[s]), torch.from_numpy(target[s]))
            assert torch.equal(got[s], one)
    np.testing.assert_array_equal(
        knn.nn_argmin(torch.from_numpy(pred), torch.from_numpy(target)).numpy(),
        np.stack([_brute_index(pred[s], target[s]) for s in range(3)]))


def test_nn_distance_value_and_gradient_match_jax(rng):
    pred, target = _points(rng, 4, 16), _points(rng, 20)
    jp, jt = jnp.asarray(pred), jnp.asarray(target)
    tp = torch.from_numpy(pred).requires_grad_(True)
    got = knn.nn_distance(tp, torch.from_numpy(target))
    g_got, = torch.autograd.grad(got.sum(), tp)
    for ref in (lambda p: nn_distance_pallas(p, jt, interpret=True),
                lambda p: jknn.nn_distance_xla(p, jt)):
        want = np.asarray(ref(jp))
        g_want = np.asarray(jax.grad(lambda p: jnp.sum(ref(p)))(jp))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
        np.testing.assert_allclose(g_got.numpy(), g_want, atol=1e-5)
    # the mxu route: the same matches here, so the same values
    got_mxu = knn.nn_distance(tp.detach(), torch.from_numpy(target), mxu=True)
    np.testing.assert_allclose(got_mxu.numpy(), got.detach().numpy(), atol=1e-6)
    want_mxu = np.asarray(nn_distance_pallas(jp, jt, interpret=True, mxu=True))
    np.testing.assert_allclose(got_mxu.numpy(), want_mxu, atol=1e-5)


def test_batched_nn_distance_equals_chamfer_per_sample(rng):
    pred, target = _points(rng, 2, 5, 7), _points(rng, 2, 9)
    got = knn.nn_distance(torch.from_numpy(pred), torch.from_numpy(target))
    assert got.shape == (2, 5, 7)
    for s in range(2):
        want = np.asarray(jknn.chamfer_min_distance(pred[s], target[s]))
        np.testing.assert_allclose(got[s].numpy(), want, atol=1e-6)
        torch.testing.assert_close(
            knn.chamfer_min_distance(torch.from_numpy(pred[s]),
                                     torch.from_numpy(target[s])), got[s])


def test_zero_gradient_at_exact_coincidence(rng):
    """After tests/test_losses.py:194: a pred point ON a target point has
    distance 0 and gradient 0, not NaN."""
    target = _points(rng, 6, scale=0.05)
    pred = torch.from_numpy(np.stack([target[:4], target[2:]])).requires_grad_(True)
    d = knn.nn_distance(pred, torch.from_numpy(target))
    g, = torch.autograd.grad(d.sum(), pred)
    assert torch.equal(d.detach(), torch.zeros_like(d))
    assert torch.equal(g, torch.zeros_like(g))
    x = torch.zeros((2, 3), requires_grad=True)
    g0, = torch.autograd.grad(knn.safe_norm(x).sum(), x)
    assert torch.equal(g0, torch.zeros_like(g0))
    v = _points(rng, 5)
    np.testing.assert_allclose(knn.safe_norm(torch.from_numpy(v)).numpy(),
                               np.asarray(jknn.safe_norm(jnp.asarray(v))),
                               rtol=1e-6)


def test_nn_index_and_pairwise_match_jax(rng):
    a, b = _points(rng, 2, 10), _points(rng, 2, 20)
    got = knn.nn_index(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jknn.nn_index(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        knn.pairwise_sq_dist(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jknn.pairwise_sq_dist(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-5)


def test_wrappers_run_plain_on_cpu_and_raise_off_it(rng):
    pred, target = torch.from_numpy(_points(rng, 8)), torch.from_numpy(_points(rng, 5))
    before = launch_counts()
    assert torch.equal(knn.nn_match(pred, target), knn.nn_match_plain(pred, target))
    assert launch_counts() == before
    for fn in (knn.nn_match, knn.nn_argmin, knn.nn_match_mxu):
        with pytest.raises(ValueError, match="CUDA"):
            fn(torch.empty((8, 3), device="meta"), torch.empty((5, 3), device="meta"))
