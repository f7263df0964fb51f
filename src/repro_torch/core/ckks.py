"""CKKS primitive HE ops (paper §II-B): HAdd, HMult, PMult, HRot, KS, RS.

Key-switching follows the hybrid (Han-Ki) construction used by ARK and
CiFHER: digit decomposition → ModUp (iNTT · BConv · NTT) → evk inner product →
ModDown.  Hoisted rotations (one shared ModUp across a set of rotations)
implement the decomposition reuse that the paper's minimum key-switching
(§V-B) builds on.

Engine selection, as the reference's ``core/ckks.py``:

* ``"fused"`` (default) — rotations go through the fused AutoU∘KS kernel (the
  Galois permutation applied to each hoisted digit inside the evk MAC, all
  rotations of a set in one launch) and the multi-permutation kernel, and
  HMult's tensor products through the EFU kernel (one stacked ``mul``, one
  compound ``mac``).
* ``"eager"`` — the per-rotation path (permute every digit, then the RnsPoly
  inner product) and RnsPoly tensor products; bit-exact with the reference's
  eager engine.

Kernels run for CUDA tensors; on CPU tensors each wrapper runs its plain
torch version, so both engines compute the same bytes on either device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import native
from repro_torch.kernels.automorphism import ops as auto_ops
from repro_torch.kernels.eltwise import ops as elt_ops

from . import bconv as bc
from . import const_cache
from . import guards
from . import modmath as mm
from . import poly as pl
from . import rns
from . import trace
from .keys import Ciphertext, EvalKey, KeySet
from .params import CkksParams

_ENGINES = ("fused", "eager")
_engine = "fused"


def get_engine() -> str:
    return _engine


def set_engine(name: str) -> None:
    """Select the CKKS rotation/eltwise engine globally ("fused" | "eager")."""
    global _engine
    if name not in _ENGINES:
        raise ValueError(f"unknown CKKS engine {name!r} — one of {_ENGINES}")
    _engine = name


class use_engine:
    """Context manager pinning the CKKS engine (parity tests, benchmarks)."""

    def __init__(self, name: str):
        if name not in _ENGINES:
            raise ValueError(f"unknown CKKS engine {name!r} — one of {_ENGINES}")
        self.name = name

    def __enter__(self):
        self._saved = _engine
        set_engine(self.name)
        return self

    def __exit__(self, *exc):
        set_engine(self._saved)
        return False


def _use_fused() -> bool:
    if _engine != "fused" or bc.policy_active():
        return False
    # under an active dist_scope the eager decomposition is the distributed
    # path: every primitive it touches (RnsPoly NTT/automorphism, bconv_raw)
    # dispatches to the sharded engine, whereas the fused kernels assume
    # single-device natural-order operands.
    from . import distributed as dist
    return dist.dist_active() is None


def _evk_at_level(evk: EvalKey, params: CkksParams,
                  ell: int) -> list[tuple[pl.RnsPoly, pl.RnsPoly]]:
    """Slice each digit key to the current basis Q_ℓ ∪ P (cached per level)."""
    idx = tuple(range(ell)) + tuple(params.L + k for k in range(params.K))
    basis = params.q[:ell] + params.p
    return evk.at_level(idx, basis, len(params.digit_bases(ell)))


# ----------------------------------------------------------------------------
# Key-switching
# ----------------------------------------------------------------------------

def mod_up_all_digits(d: pl.RnsPoly, params: CkksParams) -> list[pl.RnsPoly]:
    """Digit-decompose + ModUp: d ∈ R_{Q_ℓ} (NTT) → [R_{Q_ℓ∪P} (NTT)] per digit.

    The digit's own limbs reuse the original NTT-domain data — only BConv
    outputs pay forward transforms.
    """
    ell = d.ell
    d_ntt = d.to_ntt()
    d_coeff = d.to_coeff()
    full_q = params.q[:ell]
    exts = []
    start = 0
    for dj in params.digit_bases(ell):
        sl = slice(start, start + len(dj))
        exts.append(bc.mod_up_digit(d_coeff.limbs(sl), full_q, params.p,
                                    d_ntt.limbs(sl)))
        start += len(dj)
    return exts


def ks_inner(exts: list[pl.RnsPoly], evk: EvalKey, params: CkksParams,
             ell: int) -> tuple[pl.RnsPoly, pl.RnsPoly]:
    """Σ_j ext_j ⊙ evk_j over Q_ℓ∪P, then ModDown by P.  Returns (ka, kb)."""
    pairs = _evk_at_level(evk, params, ell)
    trace.record("evk_load_bytes", 1,
                 len(pairs) * (ell + params.K) * params.N * 4)
    trace.record_he("KS")
    acc_a = acc_b = None
    for ext, (aj, bj) in zip(exts, pairs):
        ta, tb = ext * aj, ext * bj
        acc_a = ta if acc_a is None else acc_a + ta
        acc_b = tb if acc_b is None else acc_b + tb
    # both components stacked on a leading axis → ONE ModDown
    acc = pl.RnsPoly(torch.stack([acc_a.data, acc_b.data]), acc_a.basis, pl.NTT)
    k = bc.mod_down(acc, params.q[:ell], params.p)
    return (pl.RnsPoly(k.data[0], k.basis, k.domain),
            pl.RnsPoly(k.data[1], k.basis, k.domain))


def key_switch(d: pl.RnsPoly, evk: EvalKey,
               params: CkksParams) -> tuple[pl.RnsPoly, pl.RnsPoly]:
    """KS(d, evk): (ka, kb) with kb − ka·s ≈ d·s′ (paper §II-B)."""
    return ks_inner(mod_up_all_digits(d, params), evk, params, d.ell)


# ----------------------------------------------------------------------------
# Primitive HE ops
# ----------------------------------------------------------------------------

def hadd(c1: Ciphertext, c2: Ciphertext) -> Ciphertext:
    guards.check_basis_match(c1.basis, c2.basis, "hadd")
    guards.check_scale_match(c1.scale, c2.scale, "hadd")
    guards.check_ciphertext(c1, "hadd")
    guards.check_ciphertext(c2, "hadd")
    assert abs(c1.scale - c2.scale) / c1.scale < 1e-3, \
        f"scale mismatch {c1.scale} vs {c2.scale}"
    return Ciphertext(c1.a + c2.a, c1.b + c2.b, c1.scale)


def hsub(c1: Ciphertext, c2: Ciphertext) -> Ciphertext:
    guards.check_basis_match(c1.basis, c2.basis, "hsub")
    guards.check_ciphertext(c1, "hsub")
    guards.check_ciphertext(c2, "hsub")
    return Ciphertext(c1.a - c2.a, c1.b - c2.b, c1.scale)


def pmult(ct: Ciphertext, pt: pl.RnsPoly, pt_scale: float) -> Ciphertext:
    """ct ⊙ plaintext (NTT domain)."""
    guards.check_basis_match(ct.basis, pt.basis, "pmult")
    guards.check_ciphertext(ct, "pmult")
    p = pt.to_ntt()
    return Ciphertext(ct.a.to_ntt() * p, ct.b.to_ntt() * p, ct.scale * pt_scale)


def padd(ct: Ciphertext, pt: pl.RnsPoly) -> Ciphertext:
    """ct + plaintext already encoded at ct.scale."""
    return Ciphertext(ct.a, ct.b.to_ntt() + pt.to_ntt(), ct.scale)


def _tensor_products(a1: pl.RnsPoly, b1: pl.RnsPoly,
                     a2: pl.RnsPoly, b2: pl.RnsPoly):
    """HMult tensor product: d₀ = b₁b₂, d₁ = a₁b₂ + a₂b₁, d₂ = a₁a₂.

    Fused engine: TWO EFU launches — a stacked "mul" computes (d₀, d₂) over
    one (2, ℓ, N) operand, the compound "mac" computes d₁ in one pass.
    Eager: RnsPoly ops.
    """
    if not _use_fused():
        return b1 * b2, (a1 * b2) + (a2 * b1), a1 * a2
    basis = a1.basis
    trace.record("elt_mul", a1.ell, a1.N, 4)
    prod = elt_ops.eltwise("mul", basis,
                           torch.stack([b1.data, a1.data]),
                           torch.stack([b2.data, a2.data]))
    d1 = elt_ops.eltwise("mac", basis, a1.data, b2.data, a2.data, b1.data)
    return (pl.RnsPoly(prod[0], basis, pl.NTT),
            pl.RnsPoly(d1, basis, pl.NTT),
            pl.RnsPoly(prod[1], basis, pl.NTT))


def hmult(c1: Ciphertext, c2: Ciphertext, keys: KeySet) -> Ciphertext:
    """HMult = (a₁b₂+a₂b₁, b₁b₂) + KS(a₁a₂, evk_×); rescale NOT included."""
    guards.check_basis_match(c1.basis, c2.basis, "hmult")
    guards.check_level(c1.basis, 2, "hmult")
    guards.check_ciphertext(c1, "hmult")
    guards.check_ciphertext(c2, "hmult")
    trace.record_he("HMult")
    a1, b1 = c1.a.to_ntt(), c1.b.to_ntt()
    a2, b2 = c2.a.to_ntt(), c2.b.to_ntt()
    d0, d1, d2 = _tensor_products(a1, b1, a2, b2)
    ka, kb = key_switch(d2, keys.relin, keys.params)
    return Ciphertext(d1 + ka, d0 + kb, c1.scale * c2.scale)


def square(ct: Ciphertext, keys: KeySet) -> Ciphertext:
    guards.check_level(ct.basis, 2, "square")
    guards.check_ciphertext(ct, "square")
    a, b = ct.a.to_ntt(), ct.b.to_ntt()
    d0, d1, d2 = _tensor_products(a, b, a, b)
    ka, kb = key_switch(d2, keys.relin, keys.params)
    return Ciphertext(d1 + ka, d0 + kb, ct.scale * ct.scale)


def hrot(ct: Ciphertext, r: int, keys: KeySet) -> Ciphertext:
    """HRot = (0, φ_r(b)) + KS(φ_r(a), evk_r): rotates slots left by r."""
    guards.check_ciphertext(ct, "hrot")
    return _rot_by_gelt(ct, pl.galois_elt(r, ct.a.N), keys)


def conjugate(ct: Ciphertext, keys: KeySet) -> Ciphertext:
    guards.check_ciphertext(ct, "conjugate")
    return _rot_by_gelt(ct, 2 * ct.a.N - 1, keys)


def mul_const(ct: Ciphertext, value: float, params: CkksParams) -> Ciphertext:
    """ct × scalar with drift-free scale: the constant is encoded at exactly
    the level's top prime, so the following rescale restores ct.scale."""
    guards.check_level(ct.basis, 2, "mul_const")
    trace.record_he("PMultConst")
    q_top = float(ct.basis[-1])
    enc = np.array([round(value * q_top) % q for q in ct.basis],
                   dtype=np.uint32)
    a = ct.a.to_ntt().mul_scalar(enc)
    b = ct.b.to_ntt().mul_scalar(enc)
    return rescale(Ciphertext(a, b, ct.scale * q_top), params, times=1)


def _monomial_tables(basis: tuple[int, ...], N: int, power: int, device):
    """The ψ^{(2k+1)·power} vector of each limb, staged once per (basis, N,
    power, device): on the card one (ℓ, N) table of u32 bits in int32, the
    EFU ``mul`` operand; elsewhere the (vector, Shoup companions) pair of
    int64 tables for ``modmath.mulmod_shoup``.

    Built vectorised from each prime's table of ψ^e, e ∈ [0, 2N): the
    exponents (2k+1)·power mod 2N index it, so no ℓ·N modular exponentiations
    run on the host.
    """
    def build():
        e = (2 * np.arange(N, dtype=np.int64) + 1) * power % (2 * N)
        vec = np.stack([rns.psi_powers(q, N)[e] for q in basis])
        return vec, (vec << 32) // np.array(basis, dtype=np.int64)[:, None]

    if const_cache.device_of(device).type == "cuda":
        return const_cache.device_table(("monomial_u32", basis, N, power),
                                        lambda: build()[0], device, u32_bits=True)
    return const_cache.device_table(("monomial", basis, N, power), build, device)


def _refuse_layout_blind(op: str) -> None:
    """Raise under an active ``dist_scope``: ``op`` builds its table or
    plaintext in natural order, and the scope holds data in the four-step
    layouts, so its bytes would be wrong (ROADMAP A.17: a layout-aware
    bootstrap; the reference has none either)."""
    from . import distributed as dist
    if dist.dist_active() is not None:
        raise NotImplementedError(
            f"{op} under dist_scope: its table is in natural order, the scope's "
            "data in the four-step layouts (ROADMAP A.17, layout-aware bootstrap)")


def mul_monomial(ct: Ciphertext, power: int) -> Ciphertext:
    """Exact multiplication by X^power (negacyclic) — free: no level, no KS.

    In the natural-order NTT domain this is the pointwise constant vector
    ψ^{(2k+1)·power} mod q.  power = N/2 multiplies every slot by i (since
    X^{N/2}(ζ^{5^j}) = i^{5^j} = i); power = 3N/2 by −i.  Used by
    bootstrapping's re/im splitting to avoid two rescale levels.  On card
    data each half is one EFU ``mul`` against the staged table; on the CPU a
    Shoup product, as the reference.  Both give the canonical product.
    """
    _refuse_layout_blind("mul_monomial")
    N = ct.a.N
    power %= 2 * N

    def apply(p: pl.RnsPoly) -> pl.RnsPoly:
        x = p.to_ntt()
        tables = _monomial_tables(x.basis, N, power, x.device)
        if native.on_cuda(x.data):
            data = elt_ops.eltwise_cuda("mul", x.basis, x.data, tables)
        else:
            vec, shoup = tables
            data = mm.mulmod_shoup(x.data, vec, shoup, x._q()).to(torch.int32)
        return pl.RnsPoly(data, x.basis, pl.NTT)

    return Ciphertext(apply(ct.a), apply(ct.b), ct.scale)


def match_scale(ct: Ciphertext, target_scale: float,
                params: CkksParams) -> Ciphertext:
    """Bring ct.scale to ``target_scale`` exactly (up to 2⁻³⁰ relative).

    Multiplies by the integer e = round(f·q_top), f = target/current, and
    rescales once — the standard RNS-CKKS drift correction.  Costs one level.
    """
    f = target_scale / ct.scale
    if abs(f - 1.0) < 1e-9:
        return ct
    guards.check_level(ct.basis, 2, "match_scale")
    q_top = ct.basis[-1]
    e = max(1, round(f * q_top))
    enc = np.array([e % q for q in ct.basis], dtype=np.uint32)
    a = ct.a.to_ntt().mul_scalar(enc)
    b = ct.b.to_ntt().mul_scalar(enc)
    return rescale(Ciphertext(a, b, ct.scale * e), params, times=1)


def add_matched(c1: Ciphertext, c2: Ciphertext, params: CkksParams,
                sub: bool = False) -> Ciphertext:
    """Level-aligned, scale-matched add/sub for drift-prone chains (EvalMod).

    The correction (one rescale) is applied to whichever operand has more
    levels in reserve.
    """
    if abs(c1.scale - c2.scale) / c1.scale > 1e-9:
        if c1.level >= c2.level and c1.level > 1:
            c1 = match_scale(c1, c2.scale, params)
        elif c2.level > 1:
            c2 = match_scale(c2, c1.scale, params)
    ell = min(c1.level, c2.level)
    c1, c2 = level_drop(c1, ell), level_drop(c2, ell)
    return hsub(c1, c2) if sub else hadd(c1, c2)


def add_const(ct: Ciphertext, value: float) -> Ciphertext:
    """ct + scalar: a scalar added to every slot is the constant polynomial
    value·Δ (slot-wise constant ⇔ constant coefficient only)."""
    trace.record_he("PAddConst")
    v = round(value * ct.scale)
    b = ct.b.to_ntt()
    N = ct.a.N
    add_vec = np.zeros(N, dtype=np.int64)
    add_vec[0] = v
    data = pl.small_to_rns(add_vec, ct.basis)
    cpoly = pl.RnsPoly(pl.to_tensor(data, b.device), ct.basis, pl.COEFF).to_ntt()
    return Ciphertext(ct.a, b + cpoly, ct.scale)


def _rot_by_gelt(ct: Ciphertext, g: int, keys: KeySet) -> Ciphertext:
    """(φ(a), φ(b)) is valid under φ(s); switch back to s.

    With decrypt = b − a·s the switched term enters with a minus sign:
    ct′ = (−ka, φ(b) − kb).  The fused path permutes the hoisted digits
    *after* ModUp (inside the AutoU∘KS kernel); the eager path permutes ``a``
    *before* ModUp.  Both are valid key-switches of the same rotation — they
    differ only in which multiple of Q the approximate (HPS) BConv error term
    carries.
    """
    if _use_fused():
        return _rot_by_gelt_fused(ct, g, keys)
    return _rot_by_gelt_eager(ct, g, keys)


def _rot_by_gelt_eager(ct: Ciphertext, g: int, keys: KeySet) -> Ciphertext:
    """Eager rotation: permute (a, b), then a full key-switch on φ(a)."""
    a = ct.a.to_ntt().automorphism_by_gelt(g)
    b = ct.b.to_ntt().automorphism_by_gelt(g)
    ka, kb = key_switch(a, keys.galois_key(g), keys.params)
    return Ciphertext(-ka, b - kb, ct.scale)


def _rot_by_gelt_fused(ct: Ciphertext, g: int, keys: KeySet) -> Ciphertext:
    """Fused rotation: ModUp of a (unpermuted), then the AutoU∘KS kernel
    applies φ_g inside the evk MAC — no permuted digit ever materializes."""
    a, b = ct.a.to_ntt(), ct.b.to_ntt()
    exts = mod_up_all_digits(a, keys.params)
    k = _fused_galois_ks(exts, (g,), keys, a.ell)
    ka = pl.RnsPoly(k.data[0, 0], k.basis, k.domain)
    kb = pl.RnsPoly(k.data[0, 1], k.basis, k.domain)
    b_rot = _rotated_b(b, (g,))
    diff = pl.RnsPoly(b_rot.data[0], b.basis, pl.NTT) - kb
    return Ciphertext(-ka, diff, ct.scale)


# -- hoisted rotations (decomposition reuse; basis of minimum-KS §V-B) --------

def _fused_galois_ks(exts: list[pl.RnsPoly], gelts: tuple[int, ...],
                     keys: KeySet, ell: int) -> pl.RnsPoly:
    """Fused AutoU∘KS + one stacked ModDown for a whole rotation set.

    ``exts``: the hoisted digits — each digit's data is (L, N) (one shared
    ModUp, broadcast over the set) or (R, L, N) (one decomposition per
    rotation).  Returns ONE RnsPoly with data (R, 2, ℓ, N): [r, 0] is ka,
    [r, 1] is kb for rotation r.
    """
    params = keys.params
    ext_basis = exts[0].basis
    N = exts[0].N
    J, L, R = len(exts), len(ext_basis), len(gelts)
    stack = torch.stack([e.data if e.data.dim() == 3 else e.data[None]
                         for e in exts])                    # (J, G, L, N)
    idx = tuple(range(ell)) + tuple(params.L + k for k in range(params.K))
    ndig = len(params.digit_bases(ell))
    evk_a, evk_b = keys.galois_stacked(gelts, idx, ext_basis, ndig)
    trace.record("auto", L, N, J * R)            # digit permutations
    trace.record("elt_mul", L, N, 2 * J * R)     # evk MAC products
    for _ in gelts:
        trace.record("evk_load_bytes", 1, J * L * N * 4)
        trace.record_he("KS")
    acc = auto_ops.auto_ks(stack, evk_a, evk_b, N, gelts, ext_basis)
    # ONE ModDown for the whole set: every (rotation, component) pair rides
    # the leading axes through the iNTT/BConv/NTT/P⁻¹ chain.
    return bc.mod_down(pl.RnsPoly(acc, ext_basis, pl.NTT),
                       params.q[:ell], params.p)


def _rotated_b(b: pl.RnsPoly, gelts: tuple[int, ...]) -> pl.RnsPoly:
    """φ_g(b) for every g in one multi-perm kernel launch.

    ``b.data``: (ℓ, N) shared across the set, or (R, ℓ, N) one per rotation.
    Returns an (R, ℓ, N) RnsPoly.
    """
    trace.record("auto", b.ell, b.N, len(gelts))
    data = b.data if b.data.dim() == 3 else b.data[None]
    return pl.RnsPoly(auto_ops.apply_galois_many(data, b.N, gelts),
                      b.basis, pl.NTT)


def hrot_hoisted(ct: Ciphertext, rotations: list[int],
                 keys: KeySet) -> list[Ciphertext]:
    """Rotate one ciphertext by many amounts with a single ModUp.

    φ_g commutes with ModUp, so the digit decomposition of ``a`` is computed
    once and permuted per rotation.  The fused engine collapses the whole set
    into ONE AutoU∘KS launch, ONE stacked ModDown and ONE multi-perm launch
    for the b-halves; :func:`hrot_hoisted_eager` is the per-rotation path.
    """
    if _use_fused():
        return hrot_hoisted_fused(ct, rotations, keys)
    return hrot_hoisted_eager(ct, rotations, keys)


def hrot_hoisted_eager(ct: Ciphertext, rotations: list[int],
                       keys: KeySet) -> list[Ciphertext]:
    """Hoisted rotations, one evk inner product + ModDown per rotation."""
    N = ct.a.N
    a, b = ct.a.to_ntt(), ct.b.to_ntt()
    exts = mod_up_all_digits(a, keys.params)
    out = []
    for r in rotations:
        if r % (N // 2) == 0:
            out.append(Ciphertext(a, b, ct.scale))
            continue
        g = pl.galois_elt(r, N)
        exts_g = [e.automorphism_by_gelt(g) for e in exts]
        ka, kb = ks_inner(exts_g, keys.galois_key(g), keys.params, a.ell)
        out.append(Ciphertext(-ka, b.automorphism_by_gelt(g) - kb, ct.scale))
    return out


def hrot_hoisted_fused(ct: Ciphertext, rotations: list[int],
                       keys: KeySet) -> list[Ciphertext]:
    """Hoisted rotations through the fused AutoU∘KS kernel (one launch for
    the whole set) — bit-exact against :func:`hrot_hoisted_eager`."""
    N = ct.a.N
    a, b = ct.a.to_ntt(), ct.b.to_ntt()
    out = [Ciphertext(a, b, ct.scale) for _ in rotations]
    nontriv = [(i, pl.galois_elt(r, N)) for i, r in enumerate(rotations)
               if r % (N // 2) != 0]
    if not nontriv:
        return out
    exts = mod_up_all_digits(a, keys.params)
    gelts = tuple(g for _, g in nontriv)
    k = _fused_galois_ks(exts, gelts, keys, a.ell)          # (R, 2, ℓ, N)
    b_rot = _rotated_b(b, gelts)                            # (R, ℓ, N)
    _scatter_rotated(out, nontriv, k, b_rot, [ct.scale] * len(rotations))
    return out


def _scatter_rotated(out: list[Ciphertext], nontriv, k: pl.RnsPoly,
                     b_rot: pl.RnsPoly, scales: list[float]) -> None:
    """out[i] = (−ka_j, φ(b)_j − kb_j) for the j-th nontrivial rotation i."""
    ka = pl.RnsPoly(k.data[:, 0], k.basis, k.domain)
    kb = pl.RnsPoly(k.data[:, 1], k.basis, k.domain)
    diff = b_rot - kb                                       # batched over R
    neg = -ka
    for j, (i, _) in enumerate(nontriv):
        out[i] = Ciphertext(pl.RnsPoly(neg.data[j], neg.basis, neg.domain),
                            pl.RnsPoly(diff.data[j], diff.basis, diff.domain),
                            scales[i])


def hrot_many(cts: list[Ciphertext], rotations: list[int],
              keys: KeySet) -> list[Ciphertext]:
    """Rotate DISTINCT ciphertexts by per-ciphertext amounts, batched.

    One leading-dim-batched ModUp, ONE fused AutoU∘KS launch with
    per-rotation perms and evks, ONE stacked ModDown, ONE multi-perm launch
    for the b-halves.  All cts must sit at the same level.  The eager engine
    rotates each ciphertext with :func:`hrot`.
    """
    assert len(cts) == len(rotations)
    if not cts:
        return []
    if guards.full():
        for i, c in enumerate(cts):
            guards.check_ciphertext(c, f"hrot_many[{i}]")
    N = cts[0].a.N
    if not _use_fused():
        return [Ciphertext(c.a, c.b, c.scale) if r % (N // 2) == 0
                else hrot(c, r, keys) for c, r in zip(cts, rotations)]
    out = [Ciphertext(c.a.to_ntt(), c.b.to_ntt(), c.scale) for c in cts]
    nontriv = [(i, pl.galois_elt(r, N)) for i, r in enumerate(rotations)
               if r % (N // 2) != 0]
    if not nontriv:
        return out
    sel = [i for i, _ in nontriv]
    gelts = tuple(g for _, g in nontriv)
    ell = out[sel[0]].a.ell
    assert all(out[i].a.ell == ell for i in sel), "hrot_many needs equal levels"
    basis = out[sel[0]].basis
    a_stack = pl.RnsPoly(torch.stack([out[i].a.data for i in sel]), basis, pl.NTT)
    b_stack = pl.RnsPoly(torch.stack([out[i].b.data for i in sel]), basis, pl.NTT)
    exts = mod_up_all_digits(a_stack, keys.params)          # each (R, L, N)
    k = _fused_galois_ks(exts, gelts, keys, ell)            # (R, 2, ℓ, N)
    b_rot = _rotated_b(b_stack, gelts)
    _scatter_rotated(out, nontriv, k, b_rot, [c.scale for c in cts])
    return out


def hrot_by_progression(ct: Ciphertext, step: int, count: int,
                        keys: KeySet) -> list[Ciphertext]:
    """Minimum key-switching (§V-B): rotations {step, 2·step, …} with ONE evk.

    Returns [rot(ct, j·step) for j in 1..count].  When the keyset only holds
    evk_{step} (the minimum-KS configuration) the progression is computed
    recursively — evk traffic ÷ count, at the cost of serial KS.  When a key
    exists for EVERY multiple and the fused engine is active, the whole
    progression is one hoisted call: a single ModUp and a single AutoU∘KS
    launch for all the per-step key-switches.
    """
    N = ct.a.N
    rots = [step * (j + 1) for j in range(count)]
    if _use_fused():
        need = {pl.galois_elt(r, N) for r in rots if r % (N // 2) != 0}
        if need <= set(keys.galois):
            return hrot_hoisted(ct, rots, keys)
    out = []
    cur = ct
    for _ in range(count):
        cur = hrot(cur, step, keys)
        out.append(cur)
    return out


# ----------------------------------------------------------------------------
# Cross-ciphertext batched ops (the serve batcher's dispatch targets)
#
# Each *_many op stacks B independent ciphertexts on a leading axis and rides
# the leading-dim-batched paths — the EFU over (B, ℓ, N), the stacked
# ModUp/BConv/ModDown chains, hrot_many's fused AutoU∘KS — so a serving batch
# of one op family is a constant number of kernel launches, not B copies of
# the single-ciphertext chain.  Every op equals its per-ciphertext
# counterpart byte for byte: only the dispatch granularity changes.
# ----------------------------------------------------------------------------

def _stack_polys(ps: list[pl.RnsPoly], devices=None) -> pl.RnsPoly:
    """B same-basis polys → one (B, ℓ, N) NTT-domain poly on ``devices``
    (default: the first poly's): stacked there, then one forward transform
    of the stack when the members are in the coefficient domain.  A
    member on another single device is moved; values held as a mesh's
    parts are never moved (their stack maps part by part)."""
    devices = ps[0].devices if devices is None else tuple(devices)
    if len(devices) == 1:
        ps = [p if p.devices == devices
              else pl.RnsPoly(p.data.to(devices[0]), p.basis, p.domain) for p in ps]
    if len({p.domain for p in ps}) > 1:
        ps = [p.to_ntt() for p in ps]
    stack = torch.stack([p.data for p in ps])
    return pl.RnsPoly(stack, ps[0].basis, ps[0].domain).to_ntt()


def _unstack(p: pl.RnsPoly, i: int) -> pl.RnsPoly:
    return pl.RnsPoly(p.data[i], p.basis, p.domain)


def _check_same_basis(cts: list[Ciphertext], op: str) -> None:
    basis = cts[0].basis
    for c in cts:
        guards.check_basis_match(basis, c.basis, op)


def _check_cts(cts: list[Ciphertext], op: str) -> None:
    """Full-mode corruption scan of a batch's operands, one ciphertext at a
    time, so the error names the poisoned member (the serve layer's
    quarantine replay relies on a singleton re-run pinpointing it)."""
    if guards.full():
        for i, c in enumerate(cts):
            guards.check_ciphertext(c, f"{op}[{i}]")


def hadd_many(c1s: list[Ciphertext], c2s: list[Ciphertext],
              sub: bool = False) -> list[Ciphertext]:
    """B pairwise HAdd/HSub in one stacked dispatch."""
    assert len(c1s) == len(c2s)
    if not c1s:
        return []
    _check_same_basis(c1s + c2s, "hadd_many")
    _check_cts(c1s + c2s, "hadd_many")
    for c1, c2 in zip(c1s, c2s):
        guards.check_scale_match(c1.scale, c2.scale, "hadd_many")
    x1 = _stack_polys([c.a for c in c1s] + [c.b for c in c1s])
    x2 = _stack_polys([c.a for c in c2s] + [c.b for c in c2s])
    if _use_fused():
        out = pl.RnsPoly(
            elt_ops.eltwise("sub" if sub else "add", x1.basis, x1.data, x2.data),
            x1.basis, pl.NTT)
    else:
        out = (x1 - x2) if sub else (x1 + x2)
    B = len(c1s)
    return [Ciphertext(_unstack(out, i), _unstack(out, B + i), c1s[i].scale)
            for i in range(B)]


def pmult_many(cts: list[Ciphertext], pts: list[pl.RnsPoly],
               pt_scales: list[float]) -> list[Ciphertext]:
    """B ciphertext × per-request plaintext products: the plaintexts go to
    the ciphertexts' device and into the NTT domain there in one transform,
    then one product for the a-halves and one for the b-halves.

    The trace holds the reference's records of the products — one
    ``("elt_mul", ℓ, N, 2B)``, and on the eager engine the one product of
    the (2B, ℓ, N) stack — and one ``("ntt", ℓ, N)`` per plaintext in the
    coefficient domain (the reference transforms each plaintext twice, once
    per half; the port once).  The stacked transform and the two products
    record nothing of their own."""
    assert len(cts) == len(pts) == len(pt_scales)
    if not cts:
        return []
    _check_same_basis(cts, "pmult_many")
    _check_cts(cts, "pmult_many")
    for i, (c, pt) in enumerate(zip(cts, pts)):
        guards.check_basis_match(c.basis, pt.basis, f"pmult_many[{i}]")
    a = _stack_polys([c.a for c in cts])
    b = _stack_polys([c.b for c in cts])
    for pt in pts:
        if pt.domain == pl.COEFF:
            trace.record("ntt", pt.ell, pt.N)
    with trace.unrecorded():
        p = _stack_polys(pts, devices=a.devices)
        out_a, out_b = a * p, b * p
    B, ell, N = len(cts), len(a.basis), cts[0].a.N
    trace.record("elt_mul", ell, N, 2 * B)
    if not _use_fused():
        trace.record("elt_mul", 2 * B * ell, N)
    return [Ciphertext(_unstack(out_a, i), _unstack(out_b, i),
                       cts[i].scale * pt_scales[i]) for i in range(len(cts))]


def hmult_many(c1s: list[Ciphertext], c2s: list[Ciphertext],
               keys: KeySet) -> list[Ciphertext]:
    """B pairwise HMults sharing one stacked tensor product and one stacked
    key-switch: ModUp over (B, ℓ, N), each evk digit broadcast against the
    batch in the inner product, one ModDown."""
    assert len(c1s) == len(c2s)
    if not c1s:
        return []
    _check_same_basis(c1s + c2s, "hmult_many")
    guards.check_level(c1s[0].basis, 2, "hmult_many")
    _check_cts(c1s + c2s, "hmult_many")
    for _ in c1s:
        trace.record_he("HMult")
    a1 = _stack_polys([c.a for c in c1s])
    b1 = _stack_polys([c.b for c in c1s])
    a2 = _stack_polys([c.a for c in c2s])
    b2 = _stack_polys([c.b for c in c2s])
    d0, d1, d2 = _tensor_products(a1, b1, a2, b2)       # each (B, ℓ, N)
    ka, kb = key_switch(d2, keys.relin, keys.params)
    out_a, out_b = d1 + ka, d0 + kb
    return [Ciphertext(_unstack(out_a, i), _unstack(out_b, i),
                       c1s[i].scale * c2s[i].scale) for i in range(len(c1s))]


def square_many(cts: list[Ciphertext], keys: KeySet) -> list[Ciphertext]:
    """B squarings batched like :func:`hmult_many`."""
    if not cts:
        return []
    _check_same_basis(cts, "square_many")
    guards.check_level(cts[0].basis, 2, "square_many")
    _check_cts(cts, "square_many")
    a = _stack_polys([c.a for c in cts])
    b = _stack_polys([c.b for c in cts])
    d0, d1, d2 = _tensor_products(a, b, a, b)
    ka, kb = key_switch(d2, keys.relin, keys.params)
    out_a, out_b = d1 + ka, d0 + kb
    return [Ciphertext(_unstack(out_a, i), _unstack(out_b, i),
                       cts[i].scale * cts[i].scale) for i in range(len(cts))]


def rescale_many(cts: list[Ciphertext], params: CkksParams,
                 times: int | None = None) -> list[Ciphertext]:
    """B rescales in one stacked top-limb-drop chain per prime: all 2B
    components ride the leading axes, the launch count of one rescale."""
    if not cts:
        return []
    times = params.rescale_primes if times is None else times
    _check_same_basis(cts, "rescale_many")
    guards.check_level(cts[0].basis, times + 1, "rescale_many")
    _check_cts(cts, "rescale_many")
    a = _stack_polys([c.a for c in cts])
    b = _stack_polys([c.b for c in cts])
    scales = [c.scale for c in cts]
    for _ in range(times):
        ql = a.basis[-1]
        a, b, _ = _rescale_once(a, b, 0.0)
        scales = [s / ql for s in scales]
    return [Ciphertext(_unstack(a, i), _unstack(b, i), scales[i])
            for i in range(len(cts))]


# ----------------------------------------------------------------------------
# Rescaling (paper §II-B / §III-C double-prime variant)
# ----------------------------------------------------------------------------

def rescale(ct: Ciphertext, params: CkksParams, times: int | None = None) -> Ciphertext:
    """Divide by the top ``times`` primes (paper default: 2 = double-prime RS)."""
    times = params.rescale_primes if times is None else times
    guards.check_level(ct.basis, times + 1, "rescale")
    guards.check_ciphertext(ct, "rescale")
    a, b, scale = ct.a, ct.b, ct.scale
    for _ in range(times):
        a, b, scale = _rescale_once(a, b, scale)
    return Ciphertext(a, b, scale)


@functools.lru_cache(maxsize=None)
def _rescale_qinv(basis: tuple[int, ...]) -> np.ndarray:
    """q_ℓ⁻¹ mod q_i for the drop of the top prime — one build per basis."""
    ql = basis[-1]
    return np.array([pow(ql % q, q - 2, q) for q in basis[:-1]],
                    dtype=np.uint32)


def _rescale_once(a: pl.RnsPoly, b: pl.RnsPoly, scale: float):
    basis = a.basis
    ql = basis[-1]
    new_basis = basis[:-1]
    # both ciphertext components ride one leading axis: the top-limb iNTT,
    # the vectorized centered lift, the re-NTT and the subtract-and-scale by
    # q_ℓ⁻¹ each dispatch once for the pair.
    xn = pl.RnsPoly(torch.stack([a.to_ntt().data, b.to_ntt().data]), basis, pl.NTT)
    last = xn.limbs(slice(-1, None)).to_coeff()
    lifted = bc.centered_lift_single(last.data[..., 0, :], ql, new_basis)
    lifted_ntt = pl.RnsPoly(lifted, new_basis, pl.COEFF).to_ntt()
    head = xn.limbs(slice(None, -1))
    out = head.sub_scaled(lifted_ntt, _rescale_qinv(basis))
    return (pl.RnsPoly(out.data[0], new_basis, pl.NTT),
            pl.RnsPoly(out.data[1], new_basis, pl.NTT), scale / ql)


def level_drop(ct: Ciphertext, ell: int) -> Ciphertext:
    """Drop to ℓ limbs without division (modulus switching to align levels)."""
    return Ciphertext(ct.a.limbs(slice(None, ell)), ct.b.limbs(slice(None, ell)),
                      ct.scale)
