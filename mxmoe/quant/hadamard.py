"""Hadamard transforms for QuaRot-style rotation, constructed — not tabled.

The reference ships ~4.2k lines of hard-coded Hadamard matrices and a CUDA
extension (``mxmoe/quant/hadamard_utils.py:160-4379``, fast-hadamard-
transform submodule). We instead *construct* the non-power-of-two factors
with Paley's constructions + Sylvester doubling, and run the power-of-two
part as a vectorized fast Walsh-Hadamard transform that XLA fuses into
elementwise kernels. The resulting H is exactly orthogonal (H @ H.T = n I), which is all the
rotation needs — it need not equal the reference's particular matrices.

Decomposition: for dim n = K * 2^a (K the smallest constructible
non-pow2 factor, or 1), H_n = H_K (kron) H_{2^a}, applied as an FWHT along
the 2^a axis followed by a small K x K matmul — the same structure as the
reference's ``matmul_hadU`` (``hadamard_utils.py:62-83``).

Supported K: any order from Paley I (q prime, q ≡ 3 mod 4), Paley II
(q prime, q ≡ 1 mod 4) and repeated doubling — covers every MoE model here
(qwen2_moe 1408 -> K=44, qwen2_moe_57b 2560 -> K=20, mixtral 14336 -> K=28,
ds2 1408 -> K=44, and all pow2 hidden sizes).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in range(2, int(n**0.5) + 1):
        if n % p == 0:
            return False
    return True


def _quadratic_residues(q: int) -> set[int]:
    return {(x * x) % q for x in range(1, q)}


def _paley_core(q: int) -> np.ndarray:
    """Jacobsthal matrix Q for GF(q), q prime: Q[i,j] = chi(i - j)."""
    res = _quadratic_residues(q)
    chi = np.zeros(q, dtype=np.int64)
    for d in range(1, q):
        chi[d] = 1 if d in res else -1
    idx = (np.arange(q)[:, None] - np.arange(q)[None, :]) % q
    return chi[idx]


def _paley_I(q: int) -> np.ndarray:
    """Hadamard matrix of order q+1 for prime q ≡ 3 (mod 4)."""
    Q = _paley_core(q)
    n = q + 1
    H = np.ones((n, n), dtype=np.int64)
    H[1:, 1:] = Q + np.eye(q, dtype=np.int64)
    H[1:, 0] = -1
    return H


def _paley_II(q: int) -> np.ndarray:
    """Hadamard matrix of order 2(q+1) for prime q ≡ 1 (mod 4)."""
    Q = _paley_core(q)
    m = q + 1
    S = np.zeros((m, m), dtype=np.int64)
    S[0, 1:] = 1
    S[1:, 0] = 1
    S[1:, 1:] = Q
    A = np.array([[1, 1], [1, -1]], dtype=np.int64)
    B = np.array([[1, -1], [-1, -1]], dtype=np.int64)
    H = np.zeros((2 * m, 2 * m), dtype=np.int64)
    # Paley II assembly: H[2i:2i+2, 2j:2j+2] = A if S[i,j]==1, -A if
    # S[i,j]==-1, and B on the diagonal zeros of S.
    for i in range(m):
        for j in range(m):
            if S[i, j] == 1:
                H[2 * i:2 * i + 2, 2 * j:2 * j + 2] = A
            elif S[i, j] == -1:
                H[2 * i:2 * i + 2, 2 * j:2 * j + 2] = -A
            else:  # S[i,j] == 0 (diagonal)
                H[2 * i:2 * i + 2, 2 * j:2 * j + 2] = B
    return H


@functools.lru_cache(maxsize=None)
def _construct_hadamard(m: int) -> np.ndarray | None:
    """Try to construct an order-m Hadamard matrix; None if we can't."""
    if m == 1:
        return np.ones((1, 1), dtype=np.int64)
    if m == 2:
        return np.array([[1, 1], [1, -1]], dtype=np.int64)
    if m % 4 != 0 and m != 2:
        return None
    if _is_prime(m - 1) and (m - 1) % 4 == 3:
        return _paley_I(m - 1)
    if m % 2 == 0:
        q = m // 2 - 1
        if _is_prime(q) and q % 4 == 1:
            return _paley_II(q)
        half = _construct_hadamard(m // 2)
        if half is not None:
            return np.kron(np.array([[1, 1], [1, -1]], dtype=np.int64), half)
    return None


@functools.lru_cache(maxsize=None)
def get_had_factor(n: int) -> tuple[np.ndarray | None, int]:
    """Pick the decomposition n = K * 2^a (analog of ``get_hadK``,
    reference ``hadamard_utils.py:5-59``).

    Returns (H_K as int64 ndarray or None when K == 1, K). Chooses the
    *smallest* constructible K (fewer matmul FLOPs, more FWHT stages),
    unlike the reference whose K is fixed by its hard-coded table.
    """
    if _is_pow2(n):
        return None, 1
    odd = n
    a = 0
    while odd % 2 == 0:
        odd //= 2
        a += 1
    for j in range(a + 1):
        k = odd << j
        if k == 1:
            continue
        H = _construct_hadamard(k)
        if H is not None and _is_pow2(n // k):
            return H, k
    raise NotImplementedError(
        f"No Paley/Sylvester Hadamard factorization found for n={n}. "
        f"(Williamson-only orders such as 52/156/172 are not supported; "
        f"they are not needed for any registered MoE model.)"
    )


def fwht(x: jax.Array, axis: int = -1) -> jax.Array:
    """Unnormalized fast Walsh-Hadamard transform along ``axis`` (pow2 len).

    Log2(n) stages of reshaped add/sub — elementwise work that XLA fuses.
    """
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    if not _is_pow2(n):
        raise ValueError(f"fwht length {n} not a power of two")
    orig_shape = x.shape
    h = 1
    while h < n:
        x = x.reshape(*orig_shape[:-1], n // (2 * h), 2, h)
        a = x[..., 0, :]
        b = x[..., 1, :]
        x = jnp.concatenate([a + b, a - b], axis=-1)
        x = x.reshape(orig_shape)
        h *= 2
    return jnp.moveaxis(x, -1, axis)


def hadamard_matrix(n: int, dtype=jnp.float32, normalized: bool = True) -> jax.Array:
    """Dense orthogonal Hadamard matrix of order n (H @ H.T = I when
    normalized). Used to rotate weights offline."""
    hk, k = get_had_factor(n)
    pow2 = n // k
    h2 = np.array([[1.0]])
    while h2.shape[0] < pow2:
        h2 = np.kron(np.array([[1, 1], [1, -1]], dtype=np.float64), h2)
    hk_f = np.ones((1, 1)) if hk is None else hk.astype(np.float64)
    H = np.kron(hk_f, h2)
    if normalized:
        H = H / np.sqrt(n)
    return jnp.asarray(H, dtype=dtype)


def matmul_hadU(x: jax.Array, normalize: bool = True) -> jax.Array:
    """Multiply x by the orthogonal Hadamard H_n on the last axis
    (x @ H / sqrt(n)) without materializing H — FWHT along the pow2 part +
    small K-factor matmul. Semantics of reference ``matmul_hadU``
    (``hadamard_utils.py:62-83``), used as the *online* rotation on
    down_proj inputs (``rotation.py:403-421``)."""
    n = x.shape[-1]
    hk, k = get_had_factor(n)
    pow2 = n // k
    orig_dtype = x.dtype
    xf = x.astype(jnp.float32)
    if k == 1:
        out = fwht(xf)
    else:
        xr = xf.reshape(*x.shape[:-1], k, pow2)
        xr = fwht(xr, axis=-1)
        hk_j = jnp.asarray(hk, dtype=jnp.float32)
        # rotate along the K factor: out[.., i, :] = sum_j hk[i, j] x[.., j, :]
        xr = jnp.einsum("ij,...jp->...ip", hk_j, xr)
        out = xr.reshape(*x.shape[:-1], n)
    if normalize:
        out = out / jnp.sqrt(float(n))
    return out.astype(orig_dtype)


def random_hadamard_matrix(n: int, key: jax.Array, dtype=jnp.float32) -> jax.Array:
    """Randomized orthogonal Hadamard: D @ H with random ±1 diagonal D
    (QuaRot's randomization; reference ``rotation.py`` uses the same idea)."""
    H = hadamard_matrix(n, dtype=jnp.float32)
    signs = jax.random.rademacher(key, (n,), dtype=jnp.float32)
    return (signs[:, None] * H).astype(dtype)
