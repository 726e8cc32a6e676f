"""The port's searchsorted (``swnerf_torch/native/searchsorted.py``, on
``torch.searchsorted``) against the JAX package's native C++ library and a
numpy oracle: the reference's parameterised sweep (Ba/Bv x A x V x side,
``tests/test_native.py``), exact hits on bin edges, the thread bound, the
row mismatch. Bar: equal indices."""

import numpy as np
import pytest
import torch

from swnerf_torch.native import native_available, searchsorted
from swnerf_tpu.native import native_available as jax_native_available
from swnerf_tpu.native import searchsorted as jax_searchsorted


def numpy_searchsorted(a, v, side):
    """Row-broadcast oracle (reference src/torchsearchsorted/utils.py)."""
    ba, bv = a.shape[0], v.shape[0]
    rows = max(ba, bv)
    out = np.empty((rows, v.shape[1]), np.int64)
    for r in range(rows):
        out[r] = np.searchsorted(a[0 if ba == 1 else r], v[0 if bv == 1 else r], side=side)
    return out


def test_native_available():
    assert native_available() and jax_native_available()


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("Ba,Bv", [(1, 1), (1, 100), (100, 1), (100, 100), (200, 200)])
@pytest.mark.parametrize("A,V", [(1, 1), (50, 12), (500, 120)])
def test_correctness_sweep(Ba, Bv, A, V, side):
    rng = np.random.default_rng(Ba * 7 + Bv * 131 + A * 17 + V + (side == "right"))
    for _ in range(5):
        a = np.sort(rng.standard_normal((Ba, A)).astype(np.float32), -1)
        v = rng.standard_normal((Bv, V)).astype(np.float32)
        v[:, ::3] = a[0, rng.integers(0, A, v[:, ::3].shape)]  # values on bin edges
        got = searchsorted(a, v, side=side)
        assert got.dtype == np.int64 and got.shape == (max(Ba, Bv), V)
        np.testing.assert_array_equal(got, jax_searchsorted(a, v, side=side))
        np.testing.assert_array_equal(got, numpy_searchsorted(a, v, side))


def test_exact_hits():
    """Values exactly equal to bin edges: left/right differ."""
    a = np.array([[0.0, 1.0, 1.0, 2.0]], np.float32)
    v = np.array([[1.0, 0.0, 2.0, 3.0, -1.0]], np.float32)
    np.testing.assert_array_equal(searchsorted(a, v, "left")[0], [1, 0, 3, 4, 0])
    np.testing.assert_array_equal(searchsorted(a, v, "right")[0], [3, 1, 4, 4, 0])
    for side in ("left", "right"):
        np.testing.assert_array_equal(searchsorted(a, v, side), jax_searchsorted(a, v, side))


def test_thread_bound_matches_and_restores():
    rng = np.random.default_rng(0)
    a = np.sort(rng.standard_normal((500, 300)).astype(np.float32), -1)
    v = rng.standard_normal((500, 100)).astype(np.float32)
    before = torch.get_num_threads()
    one = searchsorted(a, v, "right", n_threads=1)
    assert torch.get_num_threads() == before
    np.testing.assert_array_equal(one, searchsorted(a, v, "right", n_threads=8))
    np.testing.assert_array_equal(one, jax_searchsorted(a, v, "right", n_threads=8))


@pytest.mark.parametrize("shapes", [((3, 4), (2, 4)), ((3, 4, 1), (3, 4)), ((4,), (1, 4))])
def test_bad_shapes_raise(shapes):
    a, v = (np.zeros(s, np.float32) for s in shapes)
    with pytest.raises(ValueError):
        searchsorted(a, v)
    with pytest.raises(ValueError):
        jax_searchsorted(a, v)
