"""Hadamard construction and transform tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mxmoe.quant import fwht, hadamard_matrix, matmul_hadU, random_hadamard_matrix
from mxmoe.quant.hadamard import get_had_factor, _construct_hadamard


@pytest.mark.parametrize("m", [1, 2, 4, 8, 12, 20, 28, 36, 40, 44, 60, 108, 140, 176])
def test_constructed_hadamard_is_hadamard(m):
    H = _construct_hadamard(m)
    assert H is not None, f"order {m} should be constructible"
    assert set(np.unique(H)) <= {-1, 1}
    np.testing.assert_array_equal(H @ H.T, m * np.eye(m, dtype=np.int64))


@pytest.mark.parametrize("n,expected_k", [
    (2048, 1),        # pow2 hidden
    (1408, 44),       # qwen2_moe moe_intermediate (reference uses 176; 44 is smaller, still exact)
    (2560, 20),       # qwen2_moe_57b (odd part 5 -> 20 = Paley I q=19)
    (14336, 28),      # mixtral (odd part 7 -> 28 = Paley II q=13)
    (3584, 28),       # llama3-style hidden
    (5632, 44),       # qwen2_moe shared-expert intermediate
])
def test_get_had_factor(n, expected_k):
    hk, k = get_had_factor(n)
    assert k == expected_k
    if k > 1:
        np.testing.assert_array_equal(hk @ hk.T, k * np.eye(k, dtype=np.int64))


def test_fwht_matches_dense():
    n = 64
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((4, n)).astype(np.float32))
    H = np.asarray(hadamard_matrix(n, normalized=False))
    got = np.asarray(fwht(x))
    want = np.asarray(x) @ H.T  # symmetric sylvester H == H.T
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [128, 1408, 2560])
def test_matmul_hadU_is_orthogonal(n):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((8, n)).astype(np.float32))
    y = matmul_hadU(x)
    # norm-preserving
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(y), axis=-1),
        np.linalg.norm(np.asarray(x), axis=-1),
        rtol=1e-4,
    )
    # involution up to normalization: matmul_hadU uses symmetric factors only
    # when k==1; in general check against the dense matrix instead.
    H = np.asarray(hadamard_matrix(n))
    np.testing.assert_allclose(np.asarray(y), np.asarray(x) @ np.asarray(H).T, rtol=2e-3, atol=2e-3)


def test_dense_hadamard_orthogonal():
    for n in (256, 1408):
        H = np.asarray(hadamard_matrix(n)).astype(np.float64)
        np.testing.assert_allclose(H @ H.T, np.eye(n), atol=1e-5)


def test_random_hadamard_orthogonal():
    key = jax.random.PRNGKey(0)
    Q = np.asarray(random_hadamard_matrix(1408, key)).astype(np.float64)
    np.testing.assert_allclose(Q @ Q.T, np.eye(1408), atol=1e-5)


def test_rotation_preserves_linear_output():
    """Y = (X Q) (W Q)^T == X W^T for orthogonal Q — the invariance the whole
    QuaRot scheme rests on (reference rotation.py:264-266)."""
    rng = np.random.default_rng(2)
    n = 128
    X = rng.standard_normal((4, n)).astype(np.float32)
    W = rng.standard_normal((32, n)).astype(np.float32)
    Q = np.asarray(random_hadamard_matrix(n, jax.random.PRNGKey(1))).astype(np.float32)
    got = (X @ Q) @ (W @ Q).T
    want = X @ W.T
    np.testing.assert_allclose(got, want, atol=1e-3)
