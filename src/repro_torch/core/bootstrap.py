"""CKKS bootstrapping (paper §VI-B "Boot" workload).

Pipeline (Cheon et al. / combining [12],[18] as §V-B describes):

    ModRaise   — exact centered lift of the exhausted ciphertext (1 limb)
                 into the full basis Q_L; plaintext becomes m + q₁·I.
    CoeffToSlot— homomorphic multiplication by E⁻¹ = Eᴴ/n (the inverse
                 canonical embedding), BSGS with hoisted baby rotations and
                 optionally minimum-key-switching giant steps (§V-B);
                 conjugation splits the two coefficient halves.
    EvalMod    — Chebyshev approximation of (1/2π)·sin(2πx) on [-K, K],
                 depth-log recursive T_i evaluation; removes the q₁·I term.
    SlotToCoeff— homomorphic multiplication by E (forward embedding).

Scale discipline: the encoding scale is pinned to Δ = q₁ so that slot values
after ModRaise read I + m/Δ directly; every constant multiplication encodes
its constant at exactly the current top prime, making rescaling drift-free.

Minimum key-switching (§V-B): the giant-step rotations form the arithmetic
progression {bs, 2bs, …}; with ``use_min_ks=True`` they are evaluated with the
single evk_bs via the recursive accumulation
    Σ_g rot_{g·bs}(inner_g) = inner_0 + rot_bs(inner_1 + rot_bs(inner_2 + …)),
cutting evk traffic by the giant count at equal KS count.

The same algorithm, order of operations and trace records as the reference's
``core/bootstrap.py``, so the same seeds give the same bytes.  The linear
transforms are dense: every one of the n = N/2 diagonals is encoded at the
current basis and kept in ``ctx.pt_cache`` on the ciphertexts' device
(n·ℓ·N·4 bytes per transform).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import bconv as bc
from . import ckks
from . import encoding as enc
from . import keys as keysm
from . import poly as pl
from . import trace
from .params import CkksParams


# ----------------------------------------------------------------------------
# Context (matrices, rotation keys, Chebyshev coefficients)
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class BootContext:
    params: CkksParams
    keys: keysm.KeySet
    K_range: int                   # EvalMod input bound (|I + m/Δ| < K)
    cheb_coeffs: np.ndarray        # Chebyshev series of sin(2πKu)/2π on [-1,1]
    bs: int                        # BSGS baby-step count
    cts_diags: dict[int, np.ndarray]
    stc_diags: dict[int, np.ndarray]
    use_min_ks: bool = True
    # encoded-diagonal plaintext cache: (matrix id, diag, shift, basis) →
    # NTT-domain RnsPoly on the ciphertexts' device.  Bootstrapping re-runs
    # the same two linear transforms at the same levels on every call, so the
    # O(n²) encode work amortizes to the first invocation.
    pt_cache: dict = dataclasses.field(default_factory=dict)

    @property
    def slots(self) -> int:
        return self.params.slots


def _diagonals(M: np.ndarray) -> dict[int, np.ndarray]:
    n = M.shape[0]
    idx = np.arange(n)
    return {d: M[idx, (idx + d) % n] for d in range(n)}


def embedding_diagonals(N: int) -> tuple[dict, dict]:
    """(CoeffToSlot, SlotToCoeff) diagonals: of E⁻¹·½ = Eᴴ/n·½ and of E."""
    n = N // 2
    E = enc._emb_matrix(N)                     # z = E·c (decode direction)
    Einv = E.conj().T / n                      # c = E⁻¹·z
    # fold the ½ of the re/im split into the CtS matrix (saves one level;
    # the ×(±i) halves use the free monomial X^{N/2} trick instead)
    return _diagonals(Einv * 0.5), _diagonals(E)


def _bsgs_rotations(n: int, bs: int) -> tuple[list[int], list[int]]:
    babies = list(range(1, bs))
    giants = [g * bs for g in range(1, -(-n // bs))]
    return babies, giants


def setup_bootstrap(params: CkksParams, hamming: int = 8, K_range: int = 4,
                    cheb_deg: int = 47, seed: int = 0,
                    use_min_ks: bool = True, device="cuda") -> BootContext:
    """Keys on ``device`` (the card unless the caller says otherwise), the
    transform diagonals and the Chebyshev series of EvalMod."""
    n = params.slots
    bs = 1
    while bs * bs < n:
        bs *= 2
    babies, giants = _bsgs_rotations(n, bs)
    rotations = tuple(babies + ([bs] if use_min_ks else giants))
    keys = keysm.keygen(params, rotations=rotations, conj=True, seed=seed,
                        hamming=hamming, device=device)
    if not use_min_ks:
        keysm.add_galois_keys(keys, tuple(giants), seed=seed + 1, device=device)

    f = lambda u: np.sin(2 * np.pi * K_range * u) / (2 * np.pi)
    cheb = np.polynomial.chebyshev.Chebyshev.interpolate(f, cheb_deg,
                                                         domain=[-1, 1])
    # sanity: approximation error must be far below the target precision
    grid = np.linspace(-1, 1, 4001)
    err = np.max(np.abs(cheb(grid) - f(grid)))
    assert err < 1e-5, f"Chebyshev deg {cheb_deg} too low for K={K_range}: {err}"
    cts_diags, stc_diags = embedding_diagonals(params.N)
    return BootContext(params=params, keys=keys, K_range=K_range,
                       cheb_coeffs=cheb.coef, bs=bs, cts_diags=cts_diags,
                       stc_diags=stc_diags, use_min_ks=use_min_ks)


# ----------------------------------------------------------------------------
# Constant multiplications (drift-free scale bookkeeping)
# ----------------------------------------------------------------------------

def mul_const_vec(ct: ckks.Ciphertext, vec: np.ndarray,
                  params: CkksParams) -> ckks.Ciphertext:
    """ct ⊙ complex constant vector, encoded at exactly the top prime."""
    q_top = float(ct.basis[-1])
    pt = enc.encode(np.asarray(vec, dtype=np.complex128), q_top, ct.basis,
                    params.N)
    out = ckks.pmult(ct, pl.RnsPoly(pl.to_tensor(pt, ct.a.device), ct.basis,
                                    pl.COEFF), q_top)
    return ckks.rescale(out, params, times=1)


# ----------------------------------------------------------------------------
# BSGS homomorphic linear transform (one level)
# ----------------------------------------------------------------------------

def linear_transform(ct: ckks.Ciphertext, diags: dict[int, np.ndarray],
                     ctx: BootContext) -> ckks.Ciphertext:
    """out slots = M · slots, M given by its diagonals.  One rescale level.

    Double-hoisting: the baby rotations share one ModUp AND (fused engine)
    collapse into a single AutoU∘KS kernel launch; the giant-step
    accumulators batch their automorphisms + key-switches into one
    ``hrot_many`` launch (non-min-KS) or fold serially with the single
    evk_bs (minimum key-switching §V-B).
    """
    n, bs = ctx.slots, ctx.bs
    params, keys = ctx.params, ctx.keys
    q_top = float(ct.basis[-1])
    n_giants = -(-n // bs)
    babies = ckks.hrot_hoisted(ct, list(range(bs)), keys)
    device = ct.a.device

    def encode_diag(key, vec_fn) -> pl.RnsPoly:
        """Encode once per (matrix, diag, shift, basis); reuse device-side."""
        pt = ctx.pt_cache.get(key) if key is not None else None
        if pt is None:
            pt = pl.RnsPoly(pl.to_tensor(enc.encode(vec_fn(), q_top, ct.basis,
                                                    params.N), device),
                            ct.basis, pl.COEFF).to_ntt()
            if key is not None:
                ctx.pt_cache[key] = pt
        return pt

    # stable matrix identity: only the context's own (immutable-by-contract)
    # matrices are cacheable; an ad-hoc diags dict gets no caching rather
    # than a reusable-id() key that could alias a freed dict.
    mat = ("cts" if diags is ctx.cts_diags
           else "stc" if diags is ctx.stc_diags else None)
    inners: list[ckks.Ciphertext] = []
    for g in range(n_giants):
        acc = None
        for b in range(bs):
            d = g * bs + b
            if d >= n:
                break
            if not np.any(np.abs(diags[d]) > 1e-14):
                continue
            # diagonal pre-rotated by the -giant amount
            key = (mat, d, g * bs, ct.basis) if mat is not None else None
            pt = encode_diag(key, lambda: np.roll(diags[d], g * bs))
            term = ckks.pmult(babies[b], pt, q_top)
            acc = term if acc is None else ckks.hadd(acc, term)
        if acc is None:
            acc = ckks.pmult(babies[0],
                             encode_diag(("zero", n, ct.basis),
                                         lambda: np.zeros(n)), q_top)
        inners.append(acc)

    if ctx.use_min_ks:
        # §V-B: fold giants right-to-left with the single evk_bs
        out = inners[-1]
        for g in range(n_giants - 2, -1, -1):
            out = ckks.hadd(inners[g], ckks.hrot(out, bs, keys))
    else:
        # all giant-step rotations in ONE batched launch set (stacked ModUp,
        # fused AutoU∘KS, stacked ModDown, multi-perm b-halves)
        rotated = ckks.hrot_many(inners[1:],
                                 [g * bs for g in range(1, n_giants)], keys)
        out = inners[0]
        for rg in rotated:
            out = ckks.hadd(out, rg)
    return ckks.rescale(out, params, times=1)


# ----------------------------------------------------------------------------
# EvalMod: Chebyshev sine (depth-log recursive T_i)
# ----------------------------------------------------------------------------

def _align(cts: list[ckks.Ciphertext]) -> list[ckks.Ciphertext]:
    ell = min(c.level for c in cts)
    return [ckks.level_drop(c, ell) for c in cts]


def eval_chebyshev(ct_u, coeffs: np.ndarray, ctx: BootContext):
    """p(u) = Σ c_j T_j(u) for u already in [-1, 1]."""
    params, keys = ctx.params, ctx.keys
    deg = len(coeffs) - 1
    T: dict[int, ckks.Ciphertext] = {1: ct_u}

    def get(i: int) -> ckks.Ciphertext:
        if i in T:
            return T[i]
        a, b = -(-i // 2), i // 2
        ta, tb = _align([get(a), get(b)])
        prod = ckks.rescale(ckks.hmult(ta, tb, keys), params, times=1)
        prod = ckks.hadd(prod, prod)            # 2·T_a·T_b
        if a == b:
            out = ckks.add_const(prod, -1.0)    # T_{2a} = 2T_a² − 1
        else:
            # T_{a+b} = 2T_aT_b − T_{a−b}; scale-matched subtraction
            out = ckks.add_matched(prod, get(a - b), params, sub=True)
        T[i] = out
        return out

    terms = []
    for j in range(1, deg + 1):
        if abs(coeffs[j]) < 1e-12:
            continue
        terms.append((j, coeffs[j]))
    # materialize all T_j, combine with scalar coefficients (scale-matched)
    cts = [get(j) for j, _ in terms]
    acc = None
    for (j, cj), tj in zip(terms, cts):
        term = ckks.mul_const(tj, float(cj), params)
        acc = term if acc is None else ckks.add_matched(acc, term, params)
    return ckks.add_const(acc, float(coeffs[0]))


def eval_mod(ct, ctx: BootContext):
    """Remove the q₁·I term: slots I + w → w (w = m/Δ, |w| small)."""
    u = ckks.mul_const(ct, 1.0 / ctx.K_range, ctx.params)
    return eval_chebyshev(u, ctx.cheb_coeffs, ctx)


# ----------------------------------------------------------------------------
# ModRaise and the full pipeline
# ----------------------------------------------------------------------------

def mod_raise(ct: ckks.Ciphertext, params: CkksParams) -> ckks.Ciphertext:
    """Exact centered lift from basis {q₁} to Q_L (coeff domain)."""
    assert ct.level == 1, "bootstrap expects a level-1 (exhausted) ciphertext"
    basis = params.q
    q1 = ct.basis[0]
    # both components stacked → ONE vectorized centered lift over (2, N)
    x = torch.stack([ct.a.to_coeff().data[..., 0, :],
                     ct.b.to_coeff().data[..., 0, :]])
    lifted = bc.centered_lift_single(x, q1, basis)
    trace.record_he("ModRaise")
    return ckks.Ciphertext(pl.RnsPoly(lifted[0], basis, pl.COEFF),
                           pl.RnsPoly(lifted[1], basis, pl.COEFF), ct.scale)


def coeff_to_slot(ct, ctx: BootContext):
    """t has the ½ pre-folded; u0 = t + t̄, u1 = −i·t + i·t̄ (monomials)."""
    N = ctx.params.N
    t = linear_transform(ct, ctx.cts_diags, ctx)
    tc = ckks.conjugate(t, ctx.keys)
    u0 = ckks.hadd(t, tc)
    u1 = ckks.hadd(ckks.mul_monomial(t, 3 * N // 2),     # −i·t
                   ckks.mul_monomial(tc, N // 2))        # +i·t̄
    return u0, u1


def slot_to_coeff(u0, u1, ctx: BootContext):
    u1i = ckks.mul_monomial(u1, ctx.params.N // 2)       # i·u1, free
    a, b = _align([u0, u1i])
    return linear_transform(ckks.hadd(a, b), ctx.stc_diags, ctx)


def bootstrap(ct: ckks.Ciphertext, ctx: BootContext) -> ckks.Ciphertext:
    """Level-1 ciphertext (scale = q₁) → refreshed ciphertext at a high level."""
    trace.record_he("Bootstrap")
    raised = mod_raise(ct, ctx.params)
    u0, u1 = coeff_to_slot(raised, ctx)
    v0 = eval_mod(u0, ctx)
    v1 = eval_mod(u1, ctx)
    return slot_to_coeff(v0, v1, ctx)


# ----------------------------------------------------------------------------
# Step-by-step check against the host (needs the secret key)
# ----------------------------------------------------------------------------

def _rel_rms(err: np.ndarray, ref: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.abs(err) ** 2) / np.mean(np.abs(ref) ** 2)))


def stage_errors(ct: ckks.Ciphertext, ctx: BootContext) -> dict:
    """Run :func:`bootstrap`'s steps on ``ct`` one by one and hold each
    against the same step computed in float64 on the host from the decrypted
    input of that step, with ``ctx.keys.sk``:

    * ``mod_raise_exact`` — the raised plaintext is the input's plus q₁·I,
      I integer with |I| < K;
    * ``cts`` — CoeffToSlot's halves against the raised coefficients / Δ;
    * ``eval_mod`` — EvalMod against the Chebyshev series at CoeffToSlot's
      decoded slots;
    * ``stc`` — SlotToCoeff against the embedding of EvalMod's decoded slots;
    * ``stc_probe`` — SlotToCoeff, at EvalMod's basis and scale, of two
      fresh encryptions of normal(n) vectors from ``default_rng(0)``: the
      same diagonals, keys and levels as ``stc``, with an input far above
      the key-switching noise that ``stc``'s small input sits near;

    each error as its rms over the rms of the host value.  ``out`` is the
    output ciphertext and ``signal_corr`` the correlation of its decoded
    slots with the input's.
    """
    params, sk = ctx.params, ctx.keys.sk
    N, n, q1 = params.N, ctx.slots, ct.basis[0]

    def slots(c):
        return enc.decode(keysm.decrypt(c, sk), c.scale, c.basis, N, n)

    def stc_error(v):
        got_v = np.concatenate([slots(x) for x in v])
        want = enc.embed(got_v[:n] + 1j * got_v[n:], N)
        out = slot_to_coeff(*v, ctx)
        return out, got_v, _rel_rms(slots(out) - want, want)

    raised = mod_raise(ct, params)
    u = coeff_to_slot(raised, ctx)
    v = [eval_mod(x, ctx) for x in u]
    out, got_v, stc = stc_error(v)

    c_in = enc.coefficients(keysm.decrypt(ct, sk), ct.basis)
    c = enc.coefficients(keysm.decrypt(raised, sk), raised.basis)
    lift = (c - c_in) / q1
    want_u = c / ct.scale
    got_u = np.concatenate([slots(x) for x in u])
    want_v = np.polynomial.chebyshev.chebval(got_u / ctx.K_range, ctx.cheb_coeffs)

    rng = np.random.default_rng(0)
    basis, scale = v[0].basis, v[0].scale
    probe = [keysm.encrypt(enc.encode(rng.normal(size=n), scale, basis, N), scale,
                           sk, basis, N, rng=rng, device=ct.a.device)
             for _ in range(2)]
    got_out, z = slots(out), slots(ct)
    return {"mod_raise_exact": bool(np.array_equal(lift, np.round(lift))
                                    and np.max(np.abs(lift)) < ctx.K_range),
            "cts": _rel_rms(got_u - want_u, want_u),
            "eval_mod": _rel_rms(got_v - want_v, want_v),
            "stc": stc, "stc_probe": stc_error(probe)[2],
            "signal_corr": float(np.real(np.vdot(got_out, z))
                                 / (np.linalg.norm(got_out) * np.linalg.norm(z))),
            "out": out}
