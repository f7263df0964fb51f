"""The port's core modules against the JAX package, at test sizes on the CPU.

Tables, modular arithmetic, the NTT, RnsPoly ring ops and the BConv /
ModUp / ModDown legs of key-switching: the same numpy inputs go through the
reference function and its port, and the results must be equal bytes.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import bconv as jbc  # noqa: E402
from repro.core import modmath as jmm  # noqa: E402
from repro.core import ntt as jntt  # noqa: E402
from repro.core import params as jprm  # noqa: E402
from repro.core import poly as jpl  # noqa: E402
from repro.core import rns as jrns  # noqa: E402
from repro_torch.core import bconv as bc  # noqa: E402
from repro_torch.core import const_cache  # noqa: E402
from repro_torch.core import modmath as mm  # noqa: E402
from repro_torch.core import ntt as nttm  # noqa: E402
from repro_torch.core import params as prm  # noqa: E402
from repro_torch.core import poly as pl  # noqa: E402
from repro_torch.core import rns  # noqa: E402
from repro_torch.kernels.bconv import ref as bconv_ref  # noqa: E402

CPU = torch.device("cpu")
PRESETS = ("test_small", "test_medium", "test_boot")


def rand(basis, N, lead=(), seed=0, hi=1):
    """u32 residues (*lead, ℓ, N) uniform in [0, hi·q) per limb."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(lead)) if lead else 1
    out = np.stack([np.stack([rng.integers(0, hi * q, N, dtype=np.int64)
                              for q in basis]) for _ in range(n)])
    return out.astype(np.uint32).reshape(*lead, len(basis), N)


def t(x):
    return pl.to_tensor(x, CPU)


def u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64).numpy().astype(np.uint32)
    return np.asarray(x)


# ------------------------------------------------------------------ tables

@pytest.mark.parametrize("preset", PRESETS + ("paper_full",))
def test_params_equal(preset):
    a, b = getattr(jprm, preset)(), getattr(prm, preset)()
    assert (a.N, a.q, a.p, a.dnum, a.rescale_primes) == \
        (b.N, b.q, b.p, b.dnum, b.rescale_primes)
    assert a.digit_bases(a.L) == b.digit_bases(b.L)


def test_prime_and_four_step_tables_equal():
    p = prm.test_small()
    for q in p.q + p.p:
        a, b = jrns.prime_tables(q, p.N), rns.prime_tables(q, p.N)
        for f in ("psi_rev", "psi_rev_shoup", "psi_inv_rev", "psi_inv_rev_shoup"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for f in ("q", "psi", "n_inv", "n_inv_shoup", "qinv_neg", "r2",
                  "mu_hi", "mu_lo"):
            assert getattr(a, f) == getattr(b, f), f
    a, b = jrns.four_step_tables(p.q[0], p.N, 32), rns.four_step_tables(p.q[0], p.N, 32)
    for f in ("twiddle", "twiddle_shoup", "row_stage", "row_stage_inv"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.c_inv, a.col.n_inv) == (b.c_inv, b.col.n_inv)


def test_bconv_tables_and_stacked_consts_equal():
    p = prm.test_medium()
    for src, dst in ((p.q[:2], p.q[2:] + p.p), (p.p, p.q)):
        a, b = jrns.bconv_tables(src, dst), rns.bconv_tables(src, dst)
        for f in ("qhat_inv", "qhat_inv_shoup", "table", "table_shoup"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    a, b = jntt.stacked_ntt_consts(p.q, p.N), nttm.stacked_ntt_consts(p.q, p.N)
    for f in nttm.NttConsts._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------- modmath

_MM_CASES = {
    # name: (port fn, reference fn, operand ranges as multiples of q)
    "addmod": (lambda x, y, q, c: mm.addmod(x, y, q),
               lambda x, y, q, c: jmm.addmod(x, y, q), (1, 1)),
    "submod": (lambda x, y, q, c: mm.submod(x, y, q),
               lambda x, y, q, c: jmm.submod(x, y, q), (1, 1)),
    "negmod": (lambda x, y, q, c: mm.negmod(x, q),
               lambda x, y, q, c: jmm.negmod(x, q), (1, 1)),
    "addmod_lazy": (lambda x, y, q, c: mm.addmod_lazy(x, y, 2 * q),
                    lambda x, y, q, c: jmm.addmod_lazy(x, y, q + q), (2, 2)),
    "submod_lazy": (lambda x, y, q, c: mm.submod_lazy(x, y, 2 * q),
                    lambda x, y, q, c: jmm.submod_lazy(x, y, q + q), (2, 2)),
    "reduce_once": (lambda x, y, q, c: mm.reduce_once(x, q),
                    lambda x, y, q, c: jmm.reduce_once(x, q), (2, 1)),
    "mulmod_shoup_lazy": (
        lambda x, y, q, c: mm.mulmod_shoup_lazy(x, c[0], c[1], q),
        lambda x, y, q, c: jmm.mulmod_shoup_lazy(x, c[2], c[3], q), (2, 1)),
    "mulmod_shoup": (
        lambda x, y, q, c: mm.mulmod_shoup(x, c[0], c[1], q),
        lambda x, y, q, c: jmm.mulmod_shoup(x, c[2], c[3], q), (2, 1)),
    "mulmod": (lambda x, y, q, c: mm.mulmod(x, y, q),
               lambda x, y, q, c: jmm.mulmod(x, y, q, c[4], c[5]), (1, 1)),
}


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("name", sorted(_MM_CASES))
def test_modmath_matches_reference(name, preset):
    p = getattr(prm, preset)()
    basis, N = p.q + p.p, 128
    port_fn, ref_fn, (hx, hy) = _MM_CASES[name]
    x = rand(basis, N, seed=1, hi=hx)
    y = rand(basis, N, seed=2, hi=hy)
    w = rand(basis, N, seed=3)                     # Shoup constants, one per slot
    ws = np.array([[rns.shoup(int(v), q) for v in row]
                   for row, q in zip(w, basis)], dtype=np.uint32)
    jc = jntt.stacked_ntt_consts(basis, N)
    qn = np.array(basis, dtype=np.uint32).reshape(-1, 1)
    got = port_fn(t(x), t(y), torch.tensor(qn.astype(np.int64)),
                  (torch.tensor(w.astype(np.int64)), torch.tensor(ws.astype(np.int64))))
    want = ref_fn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(qn),
                  (None, None, jnp.asarray(w), jnp.asarray(ws),
                   jnp.asarray(jc.qinv_neg), jnp.asarray(jc.r2)))
    np.testing.assert_array_equal(u32(got), np.asarray(want))


# -------------------------------------------------------------------- NTT

@pytest.mark.parametrize("preset", ("test_small", "test_medium"))
def test_ntt_intt_match_reference(preset):
    p = getattr(prm, preset)()
    basis = p.q + p.p
    x = rand(basis, p.N, lead=(2,), seed=4)
    jc = jntt.stacked_ntt_consts(basis, p.N)
    c = const_cache.device_ntt_consts(basis, p.N, CPU)
    want_f = np.asarray(jax.jit(lambda v: jntt.ntt(v, jc))(jnp.asarray(x)))
    want_i = np.asarray(jax.jit(lambda v: jntt.intt(v, jc))(jnp.asarray(x)))
    got_f, got_i = nttm.ntt(t(x), c), nttm.intt(t(x), c)
    assert got_f.dtype == torch.int32 and got_f.shape == x.shape
    np.testing.assert_array_equal(u32(got_f), want_f)
    np.testing.assert_array_equal(u32(got_i), want_i)
    np.testing.assert_array_equal(u32(nttm.intt(got_f, c)), x)


# ---------------------------------------------------------------- RnsPoly

_POLY_OPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "neg": lambda a, b: -a,
    "mul": lambda a, b: a * b,
    "mul_scalar": lambda a, b: a.mul_scalar(
        np.array([7 + i for i in range(a.ell)], dtype=np.uint32)),
    # the port's fused tail of ModDown and rescale against the reference's
    # (a − b).mul_scalar(…)
    "sub_scaled": lambda a, b: (
        a.sub_scaled(b, np.arange(3, 3 + a.ell, dtype=np.uint32))
        if isinstance(a, pl.RnsPoly)
        else (a - b).mul_scalar(np.arange(3, 3 + a.ell, dtype=np.uint32))),
    "automorphism": lambda a, b: a.automorphism_by_gelt(25),
    "limbs": lambda a, b: a.limbs(slice(1, 3)),
}


@pytest.mark.parametrize("op", sorted(_POLY_OPS))
def test_rnspoly_op_matches_reference(op):
    p = prm.test_small()
    x, y = rand(p.q, p.N, seed=5), rand(p.q, p.N, seed=6)
    want = _POLY_OPS[op](jpl.RnsPoly(jnp.asarray(x), p.q, jpl.NTT),
                         jpl.RnsPoly(jnp.asarray(y), p.q, jpl.NTT))
    got = _POLY_OPS[op](pl.RnsPoly(t(x), p.q, pl.NTT),
                        pl.RnsPoly(t(y), p.q, pl.NTT))
    assert (got.basis, got.domain) == (want.basis, want.domain)
    np.testing.assert_array_equal(u32(got.data), np.asarray(want.data))


def test_samplers_match_reference():
    p = prm.test_small()
    for fn in ("uniform_poly", "gaussian_poly"):
        a = getattr(jpl, fn)(np.random.default_rng(9), p.q, p.N)
        b = getattr(pl, fn)(np.random.default_rng(9), p.q, p.N, device=CPU)
        np.testing.assert_array_equal(u32(b.data), np.asarray(a.data))
    for h in (None, 64):
        np.testing.assert_array_equal(
            pl.ternary_secret(np.random.default_rng(3), p.N, h),
            jpl.ternary_secret(np.random.default_rng(3), p.N, h))
    for g in (5, 25, 2 * p.N - 1):
        np.testing.assert_array_equal(pl.automorphism_perm(p.N, g),
                                      jpl.automorphism_perm(p.N, g))
        assert pl.galois_elt(g, p.N) == jpl.galois_elt(g, p.N)


# ------------------------------------------------------- BConv / ModUp / ModDown

def test_bconv_raw_eager_matches_reference_and_oracle():
    p = prm.test_medium()
    src, dst = p.p, p.q
    x = rand(src, p.N, lead=(2,), seed=8)
    want = bconv_ref.bconv_ref(x, src, dst)
    ref = np.asarray(jbc.bconv_raw_eager(jnp.asarray(x), src, dst))
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(u32(bc.bconv_raw_eager(t(x), src, dst)), want)
    np.testing.assert_array_equal(u32(bc.bconv_raw(t(x), src, dst)), want)


def test_centered_lift_matches_reference():
    p = prm.test_small()
    ql, new = p.q[-1], p.q[:-1]
    x = rand((ql,), p.N, lead=(2,), seed=10)[:, 0]
    want = np.asarray(jbc.centered_lift_single(jnp.asarray(x), ql, new))
    np.testing.assert_array_equal(u32(bc.centered_lift_single(t(x), ql, new)), want)


def _ref_mod_up_down(d, ext, full_q, p):
    """The reference's ModUp of every digit of d and ModDown of ext."""
    jd = jpl.RnsPoly(d, full_q, jpl.NTT)
    jdc = jd.to_coeff()
    ups, start = [], 0
    for dj in p.digit_bases(len(full_q)):
        sl = slice(start, start + len(dj))
        ups.append(jbc.mod_up_digit(
            jpl.RnsPoly(jdc.data[..., sl, :], dj, jpl.COEFF), full_q, p.p,
            jpl.RnsPoly(jd.data[..., sl, :], dj, jpl.NTT)))
        start += len(dj)
    down = jbc.mod_down(jpl.RnsPoly(ext, full_q + p.p, jpl.NTT), full_q, p.p)
    return ups, down


def test_mod_up_and_mod_down_match_reference():
    p = prm.test_small()
    ell = p.L
    full_q = p.q[:ell]
    d = rand(full_q, p.N, lead=(2,), seed=11)
    ext = rand(full_q + p.p, p.N, lead=(2,), seed=12)
    with jbc.use_engine("eager"):
        ups, down = _ref_mod_up_down(jnp.asarray(d), jnp.asarray(ext), full_q, p)
    pd = pl.RnsPoly(t(d), full_q, pl.NTT)
    start = 0
    for dj, want in zip(p.digit_bases(ell), ups):
        sl = slice(start, start + len(dj))
        got = bc.mod_up_digit(
            pl.RnsPoly(pd.to_coeff().data[..., sl, :], dj, pl.COEFF), full_q,
            p.p, pl.RnsPoly(pd.data[..., sl, :], dj, pl.NTT))
        assert got.basis == want.basis
        np.testing.assert_array_equal(u32(got.data), np.asarray(want.data))
        start += len(dj)
    got = bc.mod_down(pl.RnsPoly(t(ext), full_q + p.p, pl.NTT), full_q, p.p)
    np.testing.assert_array_equal(u32(got.data), np.asarray(down.data))


def test_const_cache_stages_once():
    p = prm.test_small()
    const_cache.device_ntt_consts(p.q, p.N, CPU)
    const_cache.device_bconv_consts(p.p, p.q, CPU)
    const_cache.device_galois_perm_stack(p.N, (5, 25), CPU)
    before = const_cache.stage_events()
    c1 = const_cache.device_ntt_consts(p.q, p.N, "cpu")
    const_cache.device_bconv_consts(p.p, p.q, CPU)
    const_cache.device_galois_perm_stack(p.N, (5, 25), CPU)
    assert const_cache.stage_events() == before
    assert c1.brev.dtype == torch.int64 and c1.q.shape == (len(p.q), 1)


# ------------------------------------------- the kernels' staged constants

def test_bconv_kernel_consts_equal_python_ints():
    """What the BConvU kernel reads: the Shoup companions of q̂⁻¹ (the
    reference's qhat_inv_shoup), the table as u32 bits and ⌊2⁶⁴/p_j⌋."""
    for p in (prm.test_medium(), prm.paper_full()):
        alpha = len(p.digit_bases(p.L)[0])
        for src, dst in ((p.q[:alpha], p.q[alpha:] + p.p), (p.p, p.q[:p.L - 2])):
            c = const_cache.device_bconv_consts(src, dst, CPU)
            Q = int(np.prod([int(q) for q in src], dtype=object))
            w = [pow(Q // q % q, -1, q) for q in src]
            assert u32(c.qhat_inv_shoup).tolist() == [(wi << 32) // q
                                                      for wi, q in zip(w, src)]
            np.testing.assert_array_equal(u32(c.qhat_inv_shoup),
                                          jrns.bconv_tables(src, dst).qhat_inv_shoup)
            assert u32(c.table_u32).tolist() == [[Q // q % pj for q in src]
                                                 for pj in dst]
            assert c.barrett.tolist() == [(1 << 64) // pj for pj in dst]
    assert const_cache.device_barrett(p.q, CPU).tolist() == [(1 << 64) // q
                                                              for q in p.q]


def kernel_barrett(x, p, mu):
    """common.cuh's barrett on Python ints, word by word as the kernel: the
    quotient estimate from three partial products of x·mu/2⁶⁴, the low word
    of x − a·p, then two unsigned-min steps."""
    m32 = 0xFFFFFFFF
    xh, xl, mh, ml = x >> 32, x & m32, mu >> 32, mu & m32
    a = (xh * mh + (xh * ml >> 32) + (xl * mh >> 32)) & m32
    r = (xl - a * p) & m32
    r = min(r, (r - 2 * p) & m32)
    return min(r, (r - p) & m32)


def test_kernel_barrett_is_exact_for_every_paper_prime():
    """On the edge sums (0, the 15-product sum 15·(q−1)² with and without a
    reduced carry, 2⁶⁴ − 1), multiples of q and their neighbours, and a
    random sweep of u64 values and of 15-term sums, for every prime of
    paper_full."""
    p = prm.paper_full()
    rng = np.random.default_rng(0)
    for q in p.q + p.p:
        mu = int(const_cache.barrett_consts((q,))[0])
        top = 15 * (q - 1) ** 2
        xs = [0, 1, q - 1, q, 2 * q - 1, top, top + q - 1, 2 ** 64 - 1]
        xs += [int(v) for v in rng.integers(0, 2 ** 64, 64, dtype=np.uint64)]
        xs += [int(k) * q + d for k in rng.integers(1, 2 ** 64 // q, 16, dtype=np.uint64)
               for d in (-1, 0, 1)]
        xs += [sum(int(a) * int(b) for a, b in rng.integers(0, q, (15, 2)))
               for _ in range(16)]
        assert all(x < 2 ** 64 and kernel_barrett(x, q, mu) == x % q for x in xs), q


def test_galois_affine_form_reproduces_the_perm_table():
    """(a·k + c) mod N in wrapping u32 arithmetic, as the AutoU∘KS kernel
    computes it, equals automorphism_perm for the rotations and conjugation
    the pipeline uses and for random odd g."""
    rng = np.random.default_rng(1)
    for N in (1 << 11, 1 << 16):
        k = np.arange(N, dtype=np.uint32)
        gs = {pl.galois_elt(r, N) for r in range(-8, 9) if r} | {2 * N - 1}
        gs |= {int(g) | 1 for g in rng.integers(1, 2 * N, 24)}
        for g in sorted(gs):
            a, c = pl.galois_affine(N, g)
            got = (k * np.uint32(a) + np.uint32(c)) & np.uint32(N - 1)
            np.testing.assert_array_equal(got, pl.automorphism_perm(N, g))
            np.testing.assert_array_equal(got, np.asarray(jpl.automorphism_perm(N, g)))
        staged = const_cache.device_galois_affine(N, tuple(sorted(gs)), CPU)
        assert u32(staged).tolist() == [list(pl.galois_affine(N, g)) for g in sorted(gs)]
    for N, g in ((1 << 11, 4), (1000, 5)):
        with pytest.raises(ValueError):
            pl.galois_affine(N, g)
