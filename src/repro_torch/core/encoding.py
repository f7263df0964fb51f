"""CKKS canonical-embedding encoding (client-side, host numpy).

A message z ∈ C^{N/2} is packed into an integer polynomial m with
m(ζ^{5^j}) ≈ Δ·z_j, where ζ = e^{iπ/N} (paper §II-B).  Since 5^j ≡ 1 (mod 4),
ζ^{5^j·N/2} = i, so with the complex half-vector c_k = m_k + i·m_{k+n}
(n = N/2) the embedding reduces to the *special FFT*

    z_j = Σ_{k<n} c_k · ζ^{5^j·k}          (decode direction)

computed here both as an O(n²) direct matrix (oracle, small N) and as the
O(n log n) iterative special FFT (HEAAN-style), which the tests cross-check.

This is client-side preprocessing — float64/complex128 numpy, independent of
the u32 device path.
"""
from __future__ import annotations

import functools

import numpy as np

from . import rns


@functools.lru_cache(maxsize=None)
def _rot_group(n: int, M: int) -> np.ndarray:
    g = np.empty(n, dtype=np.int64)
    v = 1
    for j in range(n):
        g[j] = v
        v = v * 5 % M
    return g


@functools.lru_cache(maxsize=None)
def _ksi_pows(M: int) -> np.ndarray:
    return np.exp(2j * np.pi * np.arange(M + 1) / M)


@functools.lru_cache(maxsize=None)
def _emb_matrix(N: int) -> np.ndarray:
    """(n × n) matrix E[j, k] = ζ^{5^j·k} — direct oracle (N ≤ 2¹² advised)."""
    n, M = N // 2, 2 * N
    rot = _rot_group(n, M)
    k = np.arange(n, dtype=np.int64)
    return _ksi_pows(M)[(rot[:, None] * k[None, :]) % M]


def special_fft(c: np.ndarray, N: int) -> np.ndarray:
    """z_j = Σ_k c_k ζ^{5^j k} — iterative in-place CT (HEAAN EMB)."""
    n, M = N // 2, 2 * N
    v = np.asarray(c, dtype=np.complex128).copy()
    v = v[rns.bitrev_indices(n)]
    rot = _rot_group(n, M)
    ksi = _ksi_pows(M)
    size = 2
    while size <= n:
        half, quad = size // 2, size * 4
        gap = M // quad
        idx = (rot[:half] % quad) * gap
        w = ksi[idx]                                    # (half,)
        blk = v.reshape(n // size, 2, half)
        u, t = blk[:, 0, :], blk[:, 1, :] * w[None, :]
        v = np.concatenate([u + t, u - t], axis=1).reshape(n)
        size *= 2
    return v


def special_ifft(z: np.ndarray, N: int) -> np.ndarray:
    """Inverse of :func:`special_fft` (GS order, conjugate twiddles, /n)."""
    n, M = N // 2, 2 * N
    v = np.asarray(z, dtype=np.complex128).copy()
    rot = _rot_group(n, M)
    ksi = _ksi_pows(M)
    size = n
    while size >= 2:
        half, quad = size // 2, size * 4
        gap = M // quad
        idx = (quad - (rot[:half] % quad)) * gap        # conjugate twiddle
        w = ksi[idx]
        blk = v.reshape(n // size, 2, half)
        u = blk[:, 0, :] + blk[:, 1, :]
        t = (blk[:, 0, :] - blk[:, 1, :]) * w[None, :]
        v = np.concatenate([u, t], axis=1).reshape(n)
        size //= 2
    v = v[rns.bitrev_indices(n)]
    return v / n


def embed(coeffs_c: np.ndarray, N: int, direct: bool = False) -> np.ndarray:
    if direct:
        return _emb_matrix(N) @ coeffs_c
    return special_fft(coeffs_c, N)


def embed_inv(z: np.ndarray, N: int, direct: bool = False) -> np.ndarray:
    if direct:
        return np.linalg.solve(_emb_matrix(N), z)
    return special_ifft(z, N)


# ----------------------------------------------------------------------------
# message ↔ RNS plaintext
# ----------------------------------------------------------------------------

def encode(z: np.ndarray, scale: float, basis: tuple[int, ...], N: int) -> np.ndarray:
    """Message (≤ N/2 complex numbers) → (ℓ, N) u32 residues at scale Δ.

    |Δ·z| must stay below 2⁶² (int64 rounding path); CKKS encoding error from
    the float64 round-trip is ≪ the scheme's own noise.
    """
    n = N // 2
    zz = np.zeros(n, dtype=np.complex128)
    zz[: len(z)] = z
    c = embed_inv(zz, N)
    m = np.concatenate([np.real(c), np.imag(c)]) * scale
    assert np.max(np.abs(m)) < 2 ** 62, "scale·message exceeds int64 encode path"
    mi = np.round(m).astype(np.int64)
    return np.stack([(mi % q).astype(np.uint32) for q in basis])


@functools.lru_cache(maxsize=None)
def _crt_consts(basis: tuple[int, ...]) -> tuple[int, list[int]]:
    Q = 1
    for q in basis:
        Q *= q
    lift = [(Q // q) * pow(Q // q, -1, q) % Q for q in basis]
    return Q, lift


def _small_lift(res: np.ndarray, basis: tuple[int, ...]) -> np.ndarray | None:
    """The centred coefficients as int64 when each lies within ±q₀q₁/2,
    else None.

    The CRT of the first two limbs gives x ∈ (−q₀q₁/2, q₀q₁/2] exactly in
    int64 (q₀q₁ < 2⁶⁰); if x ≡ the residue mod every other prime too, x is
    the centred CRT value over the whole basis (|x| < Q/2, and the CRT is
    unique), so it equals what the big-integer path computes."""
    q0, q1 = basis[0], basis[1]
    r0, r1 = res[0], res[1]
    x = r0 + q0 * ((r1 - r0) % q1 * pow(q0, -1, q1) % q1)
    x = np.where(x > q0 * q1 // 2, x - q0 * q1, x)
    for i in range(2, len(basis)):
        if not np.array_equal(x % basis[i], res[i]):
            return None
    return x


def coefficients(residues: np.ndarray, basis: tuple[int, ...]) -> np.ndarray:
    """(ℓ, N) residues → the centred integer coefficients (CRT), as float64.

    Coefficients within ±q₀q₁/2 (a decrypted message at scale Δ ≈ q) are
    lifted in int64 from two limbs and checked against the others
    (:func:`_small_lift`); otherwise the big-integer CRT runs.  Both give
    the same integers."""
    res = np.asarray(residues, dtype=np.int64)
    if len(basis) >= 2:
        x = _small_lift(res, tuple(basis))
        if x is not None:
            return x.astype(np.float64)
    Q, lift = _crt_consts(tuple(basis))
    acc = sum(res[i].astype(object) * lift[i] for i in range(len(basis))) % Q
    return np.where(acc > Q // 2, acc - Q, acc).astype(np.float64)


def decode(residues: np.ndarray, scale: float, basis: tuple[int, ...], N: int,
           num: int | None = None) -> np.ndarray:
    """(ℓ, N) u32 residues → complex message of length ``num`` (default N/2)."""
    n = N // 2
    vals = coefficients(residues, basis)
    c = vals[:n] + 1j * vals[n:]
    z = embed(c, N) / scale
    return z[: (num or n)]
