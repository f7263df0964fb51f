"""Key material: secret key, hybrid key-switching keys, PRNG evks, encryption.

Conventions (paper §II-B): a ciphertext is ct = (a, b) with b = a·s + v + e,
so decrypt(ct) = b − a·s.  An evaluation key for a target key s′ is a set of
``dnum`` digit keys over the extended basis Q∪P:

    evk_j = (a_j, b_j),   b_j = a_j·s + e_j + [P·Q̃_j mod (·)]·s′

where Q̃_j = (Q/Q_j)·((Q/Q_j)⁻¹ mod Q_j) is the CRT interpolant of digit j.

**PRNG evk generation** (paper §V-B): the ``a_j`` halves are pure uniform
randomness, so only a seed is stored; ``a_j`` is re-expanded from
``default_rng(seed)`` on first use.  Every sampler runs host-side numpy in the
reference's call order, so :func:`keygen` and :func:`encrypt` give
byte-identical material to the reference for the same seeds.

Entry points put their tensors on ``device`` ("cuda" unless the caller says
otherwise).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import const_cache
from . import poly as pl
from .params import CkksParams


@dataclasses.dataclass(eq=False)
class SecretKey:
    s_small: np.ndarray            # (N,) int8 ternary, coeff domain
    _ntt_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def ntt_poly(self, basis: tuple[int, ...], N: int, device) -> pl.RnsPoly:
        """s in the NTT domain over ``basis``, cached per (basis, N, device)."""
        key = (tuple(basis), N, str(const_cache.device_of(device)))
        out = self._ntt_cache.get(key)
        if out is None:
            data = pl.small_to_rns(self.s_small.astype(np.int64), basis)
            out = pl.RnsPoly(pl.to_tensor(data, device), tuple(basis),
                             pl.COEFF).to_ntt()
            self._ntt_cache[key] = out
        return out


@dataclasses.dataclass
class EvalKey:
    """Hybrid key-switching key: one (a, b) pair per digit over Q_L ∪ P."""
    seed: int                        # PRNG seed for the a-halves
    b: list[pl.RnsPoly]              # dnum polys, NTT domain, basis Q_L∪P
    basis: tuple[int, ...]           # Q_L ∪ P
    _a_cache: list[pl.RnsPoly] | None = None
    _level_cache: dict | None = None

    def a(self) -> list[pl.RnsPoly]:
        """Regenerate the a-halves from the seed (PRNG evk, §V-B), on the
        device of the b-halves."""
        if self._a_cache is None:
            rng = np.random.default_rng(self.seed)
            self._a_cache = [pl.uniform_poly(rng, self.basis, self.b[0].N, pl.NTT,
                                             device=self.b[0].device)
                             for _ in self.b]
        return self._a_cache

    def at_level(self, idx: tuple[int, ...], level_basis: tuple[int, ...],
                 ndig: int) -> list[tuple[pl.RnsPoly, pl.RnsPoly]]:
        """Digit keys restricted to the limb set ``idx`` (basis Q_ℓ ∪ P),
        cached per (basis, ndig) in a bounded FIFO of 8 levels."""
        if self._level_cache is None:
            self._level_cache = {}
        key = (level_basis, ndig)
        out = self._level_cache.get(key)
        if out is None:
            take = torch.tensor(idx, dtype=torch.int64, device=self.b[0].device)
            sl = lambda p: pl.RnsPoly(p.data.index_select(-2, take),
                                      level_basis, p.domain)
            out = [(sl(aj), sl(bj))
                   for aj, bj in zip(self.a()[:ndig], self.b[:ndig])]
            if len(self._level_cache) >= 8:
                self._level_cache.pop(next(iter(self._level_cache)))
            self._level_cache[key] = out
        return out

    def drop_level_cache(self) -> None:
        """Release the per-level slices AND the regenerated a-halves; the
        b-halves and the seed remain, and the a-halves rebuild on next use."""
        self._level_cache = None
        self._a_cache = None


@dataclasses.dataclass
class KeySet:
    params: CkksParams
    sk: SecretKey
    relin: EvalKey                          # for s²
    galois: dict[int, EvalKey]              # galois element → key (incl. conj)
    # stacked galois digit keys per (rotation set, level) — the fused
    # AutoU∘KS kernel operand; bounded FIFO like EvalKey._level_cache.
    _stack_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def galois_key(self, g: int) -> EvalKey:
        if g not in self.galois:
            raise KeyError(
                f"no galois key for element {g}; generated: {sorted(self.galois)}")
        return self.galois[g]

    def galois_stacked(self, gelts: tuple[int, ...], idx: tuple[int, ...],
                       level_basis: tuple[int, ...], ndig: int):
        """(A, B): stacked (R, dnum, ℓ+K, N) galois digit keys for a rotation
        set, level-sliced and stacked once per (gelts, basis)."""
        key = (tuple(gelts), level_basis, ndig)
        out = self._stack_cache.get(key)
        if out is None:
            # slice straight off the full-basis keys rather than through
            # EvalKey.at_level, so no second copy of each key is cached
            ek0 = self.galois_key(gelts[0])
            take = torch.tensor(idx, dtype=torch.int64, device=ek0.b[0].device)
            sl = lambda p: p.data.index_select(-2, take)
            keys = [self.galois_key(g) for g in gelts]
            A = torch.stack([torch.stack([sl(aj) for aj in ek.a()[:ndig]])
                             for ek in keys])
            B = torch.stack([torch.stack([sl(bj) for bj in ek.b[:ndig]])
                             for ek in keys])
            if len(self._stack_cache) >= 8:
                self._stack_cache.pop(next(iter(self._stack_cache)))
            out = self._stack_cache[key] = (A, B)
        return out


def _digit_interp_factors(params: CkksParams) -> list[list[int]]:
    """F_j mod m for every modulus m in Q_L∪P, F_j = P·(Q/Q_j)·((Q/Q_j)⁻¹ mod Q_j)."""
    digits = tuple(tuple(d) for d in params.digit_bases(params.L))
    return _digit_interp_factors_cached(params.q, params.p, digits)


@functools.lru_cache(maxsize=None)
def _digit_interp_factors_cached(q: tuple[int, ...], p: tuple[int, ...],
                                 digits: tuple[tuple[int, ...], ...]):
    P = 1
    for pi in p:
        P *= pi
    out = []
    for dj in digits:
        Qj = 1
        for qi in dj:
            Qj *= qi
        Qrest = 1
        for qi in q:
            if qi not in dj:
                Qrest *= qi
        # Q̃_j = Qrest·(Qrest⁻¹ mod Qj); F_j = P·Q̃_j
        interp = Qrest * pow(Qrest % Qj, -1, Qj)
        Fj = P * interp
        out.append([Fj % m for m in q + p])
    return out


def _make_evk(rng: np.random.Generator, params: CkksParams, sk: SecretKey,
              target_small: np.ndarray, device) -> EvalKey:
    """evk for target key s′ given by its small coefficient vector."""
    basis = params.q + params.p
    N = params.N
    s = sk.ntt_poly(basis, N, device)
    sp = pl.RnsPoly(pl.to_tensor(pl.small_to_rns(target_small, basis), device),
                    basis, pl.COEFF).to_ntt()
    factors = _digit_interp_factors(params)
    seed = int(rng.integers(0, 2 ** 63))
    a_rng = np.random.default_rng(seed)
    bs = []
    for Fj in factors:
        a = pl.uniform_poly(a_rng, basis, N, pl.NTT, device=device)
        e = pl.gaussian_poly(rng, basis, N, device=device).to_ntt()
        b = (a * s) + e + sp.mul_scalar(np.array(Fj, dtype=np.uint32))
        bs.append(b)
    return EvalKey(seed=seed, b=bs, basis=basis)


def keygen(params: CkksParams, rotations: tuple[int, ...] = (),
           conj: bool = False, seed: int = 0,
           hamming: int | None = None, device="cuda") -> KeySet:
    """Generate sk, relinearization key, and galois keys for ``rotations``."""
    rng = np.random.default_rng(seed)
    N = params.N
    s_small = pl.ternary_secret(rng, N, hamming=hamming)
    sk = SecretKey(s_small)
    # s² via negacyclic self-convolution (exact, host-side)
    s2 = _negacyclic_small_sq(s_small.astype(np.int64), N)
    relin = _make_evk(rng, params, sk, s2, device)
    galois: dict[int, EvalKey] = {}
    gelts = {pl.galois_elt(r, N) for r in rotations}
    if conj:
        gelts.add(2 * N - 1)
    for g in sorted(gelts):
        s_g = _apply_galois_small(s_small.astype(np.int64), N, g)
        galois[g] = _make_evk(rng, params, sk, s_g, device)
    return KeySet(params=params, sk=sk, relin=relin, galois=galois)


def add_galois_keys(ks: KeySet, rotations: tuple[int, ...], seed: int = 1,
                    device="cuda") -> None:
    """Extend a KeySet with additional rotation keys (idempotent)."""
    rng = np.random.default_rng(seed)
    N = ks.params.N
    for r in rotations:
        g = pl.galois_elt(r, N)
        if g in ks.galois:
            continue
        s_g = _apply_galois_small(ks.sk.s_small.astype(np.int64), N, g)
        ks.galois[g] = _make_evk(rng, ks.params, ks.sk, s_g, device)


def _negacyclic_small_sq(s: np.ndarray, N: int) -> np.ndarray:
    full = np.convolve(s, s)
    out = full[:N].copy()
    out[: N - 1] -= full[N:]
    return out


def _apply_galois_small(s: np.ndarray, N: int, g: int) -> np.ndarray:
    dst, flip = pl.automorphism_perm_coeff(N, g)
    out = np.zeros_like(s)
    out[dst] = np.where(flip, -s, s)
    return out


# ----------------------------------------------------------------------------
# Encryption / decryption
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class Ciphertext:
    """(a, b) with b = a·s + m + e; both polys share basis/domain; scale Δ."""
    a: pl.RnsPoly
    b: pl.RnsPoly
    scale: float

    @property
    def basis(self) -> tuple[int, ...]:
        return self.a.basis

    @property
    def level(self) -> int:
        return len(self.a.basis)


def encrypt(pt_residues: np.ndarray, scale: float, sk: SecretKey,
            basis: tuple[int, ...], N: int,
            rng: np.random.Generator | None = None,
            device="cuda") -> Ciphertext:
    rng = rng or np.random.default_rng(42)
    a = pl.uniform_poly(rng, basis, N, pl.NTT, device=device)
    e = pl.gaussian_poly(rng, basis, N, device=device).to_ntt()
    m = pl.RnsPoly(pl.to_tensor(pt_residues, device), basis, pl.COEFF).to_ntt()
    s = sk.ntt_poly(basis, N, device)
    b = (a * s) + m + e
    return Ciphertext(a=a, b=b, scale=scale)


def decrypt(ct: Ciphertext, sk: SecretKey) -> np.ndarray:
    """(ℓ, N) u32 coefficient-domain residues of b − a·s, on the host."""
    s = sk.ntt_poly(ct.basis, ct.a.N, ct.a.device)
    m = (ct.b.to_ntt() - (ct.a.to_ntt() * s)).to_coeff()
    return pl.to_numpy(m.data)
