"""RNS parameter machinery: NTT-friendly primes, roots of unity, Shoup tables.

Everything in this module runs host-side with Python ints / numpy and is executed
once at parameter-construction time; the resulting tables become device constants.

Prime constraints (see modmath.barrett_reduce_wide): q in [2**29, 2**30) and
q ≡ 1 (mod 2N) so that a primitive 2N-th root of unity ψ exists (negacyclic NTT).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

WORD_BITS = 32
PRIME_LO = 1 << 29
PRIME_HI = 1 << 30

_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)  # deterministic < 3.3e24


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_ntt_primes(count: int, N: int, lo: int = PRIME_LO, hi: int = PRIME_HI,
                   descending: bool = True, exclude: tuple[int, ...] = ()) -> list[int]:
    """``count`` primes q ≡ 1 (mod 2N) in [lo, hi), distinct, largest-first."""
    step = 2 * N
    primes: list[int] = []
    q = (hi // step) * step + 1
    if q >= hi:
        q -= step
    while len(primes) < count and q > lo:
        if is_prime(q) and q not in exclude:
            primes.append(q)
        q -= step
    if len(primes) < count:
        raise ValueError(f"not enough {lo:#x}-{hi:#x} primes ≡ 1 mod {step}")
    if not descending:
        primes.reverse()
    return primes


def find_psi(q: int, N: int) -> int:
    """Primitive 2N-th root of unity mod q (ψ^N ≡ -1); N a power of two."""
    assert (q - 1) % (2 * N) == 0
    exp = (q - 1) // (2 * N)
    for g in range(2, 10_000):
        psi = pow(g, exp, q)
        if pow(psi, N, q) == q - 1:
            return psi
    raise RuntimeError(f"no 2N-th root found for q={q}")


def shoup(w: int, q: int) -> int:
    """floor(w * 2**32 / q) — the Shoup companion constant."""
    return (w << WORD_BITS) // q


def bitrev_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _pack_shoup(values, q: int) -> tuple[np.ndarray, np.ndarray]:
    """Residues < q and their Shoup companions ⌊w·2³²/q⌋ as u32 arrays.

    ``w << 32`` is below 2⁶² for w < 2³⁰, so int64 holds it exactly.
    """
    w = np.asarray(values, dtype=np.int64)
    return w.astype(np.uint32), ((w << WORD_BITS) // q).astype(np.uint32)


def _psi_powers(q: int, N: int) -> np.ndarray:
    """ψ^e mod q for every e in [0, 2N), as int64 (ψ has order 2N).

    Built by doubling: the block [s, 2s) is the block [0, s) times ψ^s.
    Products of two residues below 2³⁰ are below 2⁶⁰, exact in int64.
    """
    psi = find_psi(q, N)
    out = np.ones(2 * N, dtype=np.int64)
    s = 1
    while s < 2 * N:
        out[s:2 * s] = out[:s] * pow(psi, s, q) % q
        s *= 2
    return out


@dataclasses.dataclass(frozen=True)
class PrimeTables:
    """Per-prime constants for the fused negacyclic CT/GS NTT and helpers."""
    q: int
    psi: int
    # fused CT (forward): table[m+i] = psi^{brev(m+i)}; index 0 unused.
    psi_rev: np.ndarray
    psi_rev_shoup: np.ndarray
    # fused GS (inverse): table[h+i] = psi^{-brev(h+i)}.
    psi_inv_rev: np.ndarray
    psi_inv_rev_shoup: np.ndarray
    n_inv: int
    n_inv_shoup: int
    qinv_neg: int          # -q^{-1} mod 2**32 (Montgomery)
    r2: int                # 2**64 mod q
    mu_hi: int             # floor(2**62/q) split for Barrett
    mu_lo: int


@functools.lru_cache(maxsize=None)
def prime_tables(q: int, N: int) -> PrimeTables:
    psi = find_psi(q, N)
    pw = _psi_powers(q, N)
    rev = bitrev_indices(N)
    w_f, s_f = _pack_shoup(pw[rev], q)                    # ψ^{brev(t)}
    w_i, s_i = _pack_shoup(pw[(2 * N - rev) % (2 * N)], q)  # ψ^{-brev(t)}
    n_inv = pow(N, q - 2, q)
    mu = (1 << 62) // q
    return PrimeTables(
        q=q, psi=psi,
        psi_rev=w_f, psi_rev_shoup=s_f,
        psi_inv_rev=w_i, psi_inv_rev_shoup=s_i,
        n_inv=n_inv, n_inv_shoup=shoup(n_inv, q),
        qinv_neg=(-pow(q, -1, 1 << 32)) % (1 << 32),
        r2=pow(1 << 32, 2, q),
        mu_hi=mu >> 32, mu_lo=mu & 0xFFFFFFFF,
    )


# ----------------------------------------------------------------------------
# Four-step (recomposable NTTU) tables — paper §III-B.
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FourStepTables:
    """Tables for the R×C four-step negacyclic NTT of one prime.

    Column phase: R-point *negacyclic* NTT with ψ_R = ψ^C (ψ_R^R = ψ^N = -1).
    Inter-step twiddle: T[k1, n2] = ψ^{(2·k1+1)·n2}  (k1 natural order).
    Row phase: C-point *cyclic* DFT with ω_C = ψ^{2R}.
    """
    R: int
    C: int
    col: PrimeTables                      # negacyclic tables, length R, root psi^C
    twiddle: np.ndarray                   # (R, C) u32
    twiddle_shoup: np.ndarray
    twiddle_inv: np.ndarray               # ψ^{-(2k1+1) n2}
    twiddle_inv_shoup: np.ndarray
    row_pow: np.ndarray                   # (C/2,) ω_C^i
    row_pow_shoup: np.ndarray
    row_pow_inv: np.ndarray
    row_pow_inv_shoup: np.ndarray
    # pre-permuted stage-major twiddles: stage m (m = 1, 2, …, C/2) occupies
    # the contiguous slice [m-1, 2m-1) holding ω^{j·C/(2m)} for j < m — the
    # exact values the DIT row phase needs, so the kernel reads a contiguous
    # slice per stage instead of a strided gather of ``row_pow``.
    row_stage: np.ndarray                 # (C-1,)
    row_stage_shoup: np.ndarray
    row_stage_inv: np.ndarray
    row_stage_inv_shoup: np.ndarray
    c_inv: int
    c_inv_shoup: int


@functools.lru_cache(maxsize=None)
def four_step_tables(q: int, N: int, R: int) -> FourStepTables:
    assert N % R == 0
    C = N // R
    base = prime_tables(q, N)
    psi = base.psi

    # column-phase negacyclic tables for length R with psi_R = psi^C
    psi_R = pow(psi, C, q)
    rev = bitrev_indices(R)
    psi_R_inv = pow(psi_R, q - 2, q)
    col_f, col_fs = _pack_shoup([pow(psi_R, int(rev[t]), q) for t in range(R)], q)
    col_i, col_is = _pack_shoup([pow(psi_R_inv, int(rev[t]), q) for t in range(R)], q)
    r_inv = pow(R, q - 2, q)
    mu = (1 << 62) // q
    col = PrimeTables(
        q=q, psi=psi_R,
        psi_rev=col_f, psi_rev_shoup=col_fs,
        psi_inv_rev=col_i, psi_inv_rev_shoup=col_is,
        n_inv=r_inv, n_inv_shoup=shoup(r_inv, q),
        qinv_neg=base.qinv_neg, r2=base.r2, mu_hi=base.mu_hi, mu_lo=base.mu_lo,
    )

    # inter-step twiddles T[k1, n2] = psi^{(2 k1 + 1) n2}: one lookup in the
    # table of the 2N powers of ψ by exponent mod 2N (ψ^{-e} = ψ^{2N-e})
    e = np.outer(2 * np.arange(R, dtype=np.int64) + 1,
                 np.arange(C, dtype=np.int64)) % (2 * N)
    pw = _psi_powers(q, N)
    tw, tw_s = _pack_shoup(pw[e], q)
    tw_i, tw_is = _pack_shoup(pw[(2 * N - e) % (2 * N)], q)

    # row-phase cyclic powers: omega_C = psi^{2R}
    omega = pow(psi, 2 * R, q)
    omega_inv = pow(omega, q - 2, q)
    row, row_s = _pack_shoup([pow(omega, i, q) for i in range(C // 2)], q)
    rowi, rowi_s = _pack_shoup([pow(omega_inv, i, q) for i in range(C // 2)], q)
    stage, stage_i = _stage_major_powers(omega, q, C), \
        _stage_major_powers(omega_inv, q, C)
    st_w, st_s = _pack_shoup(stage, q)
    sti_w, sti_s = _pack_shoup(stage_i, q)
    c_inv = pow(C, q - 2, q)
    return FourStepTables(
        R=R, C=C, col=col,
        twiddle=tw, twiddle_shoup=tw_s,
        twiddle_inv=tw_i, twiddle_inv_shoup=tw_is,
        row_pow=row, row_pow_shoup=row_s,
        row_pow_inv=rowi, row_pow_inv_shoup=rowi_s,
        row_stage=st_w, row_stage_shoup=st_s,
        row_stage_inv=sti_w, row_stage_inv_shoup=sti_s,
        c_inv=c_inv, c_inv_shoup=shoup(c_inv, q),
    )


def _stage_major_powers(omega: int, q: int, C: int) -> list[int]:
    """Concatenated per-stage DIT twiddles ω^{j·C/(2m)}, j < m, m = 1..C/2.

    Length C-1; stage m starts at offset m-1 (= Σ of earlier stage sizes), so
    every stage reads the contiguous slice [m-1, 2m-1).
    """
    out: list[int] = []
    m = 1
    while m < C:
        stride = C // (2 * m)
        step = pow(omega, stride, q)
        w = 1
        for _ in range(m):
            out.append(w)
            w = w * step % q
        m *= 2
    return out


# ----------------------------------------------------------------------------
# Base-conversion (BConv) tables — paper §II-C / §V-A.
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BConvTables:
    """Fast basis conversion {q_i} → {p_j} (HPS-style, no fractional correction).

    x̃_j = Σ_i [x_i · (Q/q_i)^{-1} mod q_i] · (Q/q_i mod p_j)   (mod p_j)

    ``qhat_inv`` is applied limb-wise in the source basis; ``table`` is the
    K×ℓ matrix CiFHER's systolic BConvU multiplies against (96 % of BConv work).
    """
    src: tuple[int, ...]
    dst: tuple[int, ...]
    qhat_inv: np.ndarray         # (ℓ,)  u32
    qhat_inv_shoup: np.ndarray   # (ℓ,)
    table: np.ndarray            # (K, ℓ) u32  — rows indexed by dst prime
    table_shoup: np.ndarray      # (K, ℓ)


@functools.lru_cache(maxsize=None)
def bconv_tables(src: tuple[int, ...], dst: tuple[int, ...]) -> BConvTables:
    ell, K = len(src), len(dst)
    Q = 1
    for q in src:
        Q *= q
    qhat = [Q // q for q in src]
    qhat_inv = [pow(h % q, q - 2, q) for h, q in zip(qhat, src)]
    qi = np.array(qhat_inv, dtype=np.uint32)
    qis = np.array([shoup(v, q) for v, q in zip(qhat_inv, src)], dtype=np.uint32)
    table = np.zeros((K, ell), dtype=np.uint32)
    table_s = np.zeros((K, ell), dtype=np.uint32)
    for j, p in enumerate(dst):
        for i in range(ell):
            v = qhat[i] % p
            table[j, i] = v
            table_s[j, i] = shoup(v, p)
    return BConvTables(src=src, dst=dst, qhat_inv=qi, qhat_inv_shoup=qis,
                       table=table, table_shoup=table_s)
