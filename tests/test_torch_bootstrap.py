"""The port's bootstrap and the CKKS ops it needs, against the JAX package.

Exact equality throughout, no tolerance: the same seeds give the same bytes.
Configuration ``make_params(N=2⁷, L=14, K=2, dnum=7)`` with
``setup_bootstrap(hamming=8, K_range=4, cheb_deg=47, use_min_ks=True,
seed=0)``; the port runs on the CPU, where every kernel wrapper takes its
plain version.

* Live against JAX (skipped without ``jax``): one module-scoped fixture runs
  the JAX package once on its eager engines (eager CKKS, eager BConv) and the
  port's eager engine repeats each op on the same ciphertexts and keys,
  carried across with :mod:`repro_torch.interop`.
* Against the recorded digests (no JAX): the whole bootstrap and a degree-5
  ``eval_chebyshev`` on both engines, against the SHA-256 digests that
  ``tests/make_torch_bootstrap_ref.py`` recorded from the JAX package in
  ``tests/torch_bootstrap_ref.json`` (the JAX bootstrap takes many minutes).
* The port alone: the hoisted branch of ``hrot_by_progression``, the
  reference's fast bootstrap tests, and the bootstrap's precision.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import bconv, bootstrap as B, ckks, encoding as enc
from repro_torch.core import keys as K, params as prm, poly as pl

CPU = torch.device("cpu")
with open(os.path.join(os.path.dirname(__file__), "torch_bootstrap_ref.json")) as _f:
    REF = json.load(_f)
CFG = REF["config"]
BOOT = {k: CFG[k] for k in ("hamming", "K_range", "cheb_deg", "use_min_ks", "seed")}
ENGINES = {"fused": "kernel", "eager": "eager"}       # CKKS engine → BConv engine
# the ops held live against the JAX package, one test case each
LIVE_OPS = ("mul_const", "mul_monomial_half", "mul_monomial_three_halves",
            "match_scale", "add_matched_rescales_c2", "sub_matched_rescales_c1",
            "add_const", "hrot_by_progression_0", "hrot_by_progression_1",
            "mod_raise", "linear_transform")
LT_DIAGS = (0, 5, 37)
NEW_ROTATIONS = (1, 16, 24)        # 1 has a key already; 16, 24 are new


def boot_params():
    return prm.make_params(N=CFG["N"], L=CFG["L"], K=CFG["K"], dnum=CFG["dnum"])


def digest(ct) -> str:
    """SHA-256 of the u32 bytes of a, then b (as the recording script)."""
    h = hashlib.sha256()
    for x in (ct.a.data, ct.b.data):
        h.update(np.ascontiguousarray(pl.to_numpy(x)).tobytes())
    return h.hexdigest()


def message(n):
    return np.random.default_rng(CFG["z_seed"]).normal(size=n) * CFG["z_scale"]


def _np_ct(ct):
    return {"a": np.asarray(ct.a.data), "b": np.asarray(ct.b.data),
            "scale": ct.scale, "basis": ct.basis, "domain": ct.a.domain}


def _np_evk(ek):
    return int(ek.seed), [np.asarray(b.data) for b in ek.b]


def _port_ct(d):
    return interop.ciphertext_from_numpy(d["a"], d["b"], d["scale"], d["basis"],
                                         d["domain"], device=CPU)


def assert_ct_equal(got: K.Ciphertext, want: dict):
    assert got.basis == tuple(want["basis"])
    assert got.a.domain == want["domain"] and got.b.domain == want["domain"]
    assert got.scale == want["scale"]
    np.testing.assert_array_equal(pl.to_numpy(got.a.data), want["a"])
    np.testing.assert_array_equal(pl.to_numpy(got.b.data), want["b"])


def _inputs(p):
    """(message, scale, encryption seed, limbs kept) of the three input
    ciphertexts: the full basis at scale q_L; 13 limbs at scale 1.0012·q_L;
    one limb at scale q₁.  Each is encrypted at the full basis and dropped to
    its limbs, so the reference compiles one encryption shape."""
    rng = np.random.default_rng(11)
    z = rng.normal(size=16) + 1j * rng.normal(size=16)
    return ((z, float(p.q[-1]), 3, p.L), (z[::-1], 1.0012 * float(p.q[-1]), 4, 13),
            (z.real * 0.05, float(p.q[0]), 5, 1))


def _lt_diags(n):
    rng = np.random.default_rng(12)
    diags = {d: np.zeros(n, dtype=np.complex128) for d in range(n)}
    for d in LT_DIAGS:
        diags[d] = rng.normal(size=n) + 1j * rng.normal(size=n)
    return diags


def _ops(mod_ckks, mod_B, cts, keys, ctx, p):
    """{op: ciphertext} of every live op, in one order for both packages."""
    ct, ct13, ct1 = cts
    N = p.N
    prog = mod_ckks.hrot_by_progression(ct, 1, 2, keys)
    return {"mul_const": mod_ckks.mul_const(ct, 0.37, p),
            "mul_monomial_half": mod_ckks.mul_monomial(ct, N // 2),
            "mul_monomial_three_halves": mod_ckks.mul_monomial(ct, 3 * N // 2),
            "match_scale": mod_ckks.match_scale(ct, 1.0012 * ct.scale, p),
            "add_matched_rescales_c2": mod_ckks.add_matched(ct13, ct, p),
            "sub_matched_rescales_c1": mod_ckks.add_matched(ct, ct13, p, sub=True),
            "add_const": mod_ckks.add_const(ct, -0.25),
            "hrot_by_progression_0": prog[0], "hrot_by_progression_1": prog[1],
            "mod_raise": mod_B.mod_raise(ct1, p),
            "linear_transform": mod_B.linear_transform(ct, _lt_diags(p.slots), ctx)}


@pytest.fixture(scope="module")
def ref():
    """Everything the JAX package computes, as numpy, built once on its eager
    engines."""
    pytest.importorskip("jax")
    from repro.core import bconv as jbc, bootstrap as jB, ckks as jckks
    from repro.core import encoding as jenc, keys as jK, params as jprm

    p = jprm.make_params(N=CFG["N"], L=CFG["L"], K=CFG["K"], dnum=CFG["dnum"])
    out = {}
    with jckks.use_engine("eager"), jbc.use_engine("eager"):
        ctx = jB.setup_bootstrap(p, **BOOT)
        keys = ctx.keys
        out["ctx"] = {"s_small": np.asarray(keys.sk.s_small),
                      "relin": _np_evk(keys.relin),
                      "galois": {g: _np_evk(ek) for g, ek in keys.galois.items()},
                      "K_range": ctx.K_range, "cheb_coeffs": ctx.cheb_coeffs,
                      "bs": ctx.bs, "use_min_ks": ctx.use_min_ks,
                      "cts_diags": ctx.cts_diags, "stc_diags": ctx.stc_diags}
        cts = [jckks.level_drop(jK.encrypt(jenc.encode(z, s, p.q, p.N), s,
                                           keys.sk, p.q, p.N,
                                           rng=np.random.default_rng(seed)), ell)
               for z, s, seed, ell in _inputs(p)]
        out["cts"] = [_np_ct(c) for c in cts]
        out["ops"] = {k: _np_ct(c) for k, c in
                      _ops(jckks, jB, cts, keys, ctx, p).items()}
        before = dict(keys.galois)
        jK.add_galois_keys(keys, NEW_ROTATIONS, seed=1)
        out["added"] = {g: _np_evk(ek) for g, ek in keys.galois.items()
                        if g not in before}
        after = dict(keys.galois)
        jK.add_galois_keys(keys, NEW_ROTATIONS, seed=1)
        out["idempotent"] = keys.galois == after and all(
            keys.galois[g] is after[g] for g in after)
    return out


@pytest.fixture(scope="module")
def port(ref):
    """The port's eager engine on the JAX context and ciphertexts (CPU)."""
    p = boot_params()
    c = ref["ctx"]
    ctx = interop.bootcontext_from_numpy(
        p, c["s_small"], c["relin"], c["galois"], c["K_range"], c["cheb_coeffs"],
        c["bs"], c["use_min_ks"], device=CPU)
    cts = [_port_ct(d) for d in ref["cts"]]
    with ckks.use_engine("eager"), bconv.use_engine("eager"):
        ops = _ops(ckks, B, cts, ctx.keys, ctx, p)
    return {"params": p, "ctx": ctx, "ops": ops}


@pytest.mark.parametrize("op", LIVE_OPS)
def test_op_matches_reference(ref, port, op):
    assert_ct_equal(port["ops"][op], ref["ops"][op])


def test_add_galois_keys_matches_reference(ref, port):
    """Seeds and b-halves of the added keys equal the reference's; a present
    rotation is skipped without drawing, and a second call adds nothing."""
    keys = port["ctx"].keys
    before = dict(keys.galois)
    K.add_galois_keys(keys, NEW_ROTATIONS, seed=1, device=CPU)
    added = {g: ek for g, ek in keys.galois.items() if g not in before}
    assert sorted(added) == sorted(ref["added"]) and len(added) == 2
    for g, (seed, bs) in ref["added"].items():
        assert added[g].seed == seed
        for got, want in zip(added[g].b, bs, strict=True):
            np.testing.assert_array_equal(pl.to_numpy(got.data), want)
    after = dict(keys.galois)
    K.add_galois_keys(keys, NEW_ROTATIONS, seed=1, device=CPU)
    assert all(keys.galois[g] is after[g] for g in after) and keys.galois == after
    assert ref["idempotent"]
    for g in added:                       # leave the shared context as it was
        del keys.galois[g]


def test_apply_automorphism_coeff_matches_reference():
    pytest.importorskip("jax")
    from repro.core import poly as jpl
    p = boot_params()
    q = np.array(p.q[:3], dtype=np.uint32)
    rng = np.random.default_rng(13)
    data = np.stack([rng.integers(0, qi, p.N) for qi in q]).astype(np.uint32)
    for g in (pl.galois_elt(3, p.N), 2 * p.N - 1):
        np.testing.assert_array_equal(pl.apply_automorphism_coeff(data, p.N, g, q),
                                      jpl.apply_automorphism_coeff(data, p.N, g, q))
    assert pl.CONJ_GELT == jpl.CONJ_GELT


def test_bootcontext_from_numpy_matches_setup_bootstrap(ref, port):
    """The JAX context carried across equals the port's own setup: diagonals,
    Chebyshev coefficients, BSGS split and keys."""
    mine = B.setup_bootstrap(port["params"], **BOOT, device=CPU)
    carried = port["ctx"]
    c = ref["ctx"]
    for name in ("cts_diags", "stc_diags"):
        for d, want in c[name].items():
            np.testing.assert_array_equal(getattr(mine, name)[d], want)
            np.testing.assert_array_equal(getattr(carried, name)[d], want)
    np.testing.assert_array_equal(mine.cheb_coeffs, c["cheb_coeffs"])
    assert (mine.bs, mine.K_range, mine.use_min_ks) == (c["bs"], c["K_range"],
                                                       c["use_min_ks"])
    np.testing.assert_array_equal(mine.keys.sk.s_small, c["s_small"])
    assert sorted(mine.keys.galois) == sorted(c["galois"])
    for ek, (seed, bs) in [(mine.keys.relin, c["relin"])] + [
            (mine.keys.galois[g], c["galois"][g]) for g in c["galois"]]:
        assert ek.seed == seed
        for got, want in zip(ek.b, bs, strict=True):
            np.testing.assert_array_equal(pl.to_numpy(got.data), want)


# ---------------------------------------------------- the recorded digests

DIGEST_STAGES = ("mod_raise", "cts_u0", "cts_u1", "eval_mod_u0", "bootstrap",
                 "chebyshev5")


@pytest.fixture(scope="module", params=sorted(ENGINES))
def boot_run(request):
    """The port's bootstrap pieces at the recorded configuration (CPU)."""
    engine = request.param
    p = boot_params()
    with ckks.use_engine(engine), bconv.use_engine(ENGINES[engine]):
        ctx = B.setup_bootstrap(p, **BOOT, device=CPU)
        z = message(p.slots)
        scale = float(p.q[0])
        ct = K.encrypt(enc.encode(z, scale, p.q[:1], p.N), scale, ctx.keys.sk,
                       p.q[:1], p.N, device=CPU)
        raised = B.mod_raise(ct, p)
        u0, u1 = B.coeff_to_slot(raised, ctx)
        stages = {"mod_raise": raised, "cts_u0": u0, "cts_u1": u1,
                  "eval_mod_u0": B.eval_mod(u0, ctx),
                  "bootstrap": B.bootstrap(ct, ctx),
                  "chebyshev5": B.eval_chebyshev(u0, np.array(REF["cheb5"]), ctx)}
    return {"engine": engine, "params": p, "ctx": ctx, "z": z, "stages": stages}


@pytest.mark.parametrize("stage", DIGEST_STAGES)
def test_bootstrap_matches_recorded_reference(boot_run, stage):
    want = REF["engines"][boot_run["engine"]][stage]
    ct = boot_run["stages"][stage]
    assert (ct.scale, list(ct.basis), ct.level, ct.a.domain) == (
        want["scale"], want["basis"], want["level"], want["domain"])
    assert digest(ct) == want["sha256"]


def test_bootstrap_precision_and_levels(boot_run):
    """The reference's bound: decode error < 5e-3 and output level ≥ 3."""
    out, p = boot_run["stages"]["bootstrap"], boot_run["params"]
    assert out.level >= 3, "bootstrap must refresh usable levels"
    got = enc.decode(K.decrypt(out, boot_run["ctx"].keys.sk), out.scale,
                     out.basis, p.N, p.slots)
    assert np.max(np.abs(got - boot_run["z"])) < 5e-3


# Each step against the host on the decrypted input of that step
# (``bootstrap.stage_errors``, rms error over rms value); each bound is about
# ten times what the port reads at the recorded configuration.
STAGE_BOUNDS = {"cts": 1e-5, "eval_mod": 2e-4, "stc": 1e-3, "stc_probe": 4e-6}


def _stage_input(ctx, p):
    """The recorded configuration's level-1 input (as ``boot_run``'s)."""
    scale = float(p.q[0])
    return K.encrypt(enc.encode(message(p.slots), scale, p.q[:1], p.N), scale,
                     ctx.keys.sk, p.q[:1], p.N, device=CPU)


def test_bootstrap_stage_errors(boot_run):
    """Every step within its bound, and the steps give the bootstrap's bytes."""
    engine, p, ctx = boot_run["engine"], boot_run["params"], boot_run["ctx"]
    with ckks.use_engine(engine), bconv.use_engine(ENGINES[engine]):
        got = B.stage_errors(_stage_input(ctx, p), ctx)
    assert got["mod_raise_exact"]
    assert all(got[k] < b for k, b in STAGE_BOUNDS.items()), got
    assert got["signal_corr"] > 0.9999
    assert digest(got["out"]) == REF["engines"][engine]["bootstrap"]["sha256"]


@pytest.mark.parametrize("step", ("cts", "eval_mod", "stc"))
def test_stage_errors_flag_a_broken_step(step, monkeypatch):
    """One CoeffToSlot or SlotToCoeff diagonal negated, or EvalMod reduced to
    its 1/K pre-scale: that step's error exceeds its bound."""
    p = boot_params()
    ctx = B.setup_bootstrap(p, **BOOT, device=CPU)
    if step == "cts":
        ctx.cts_diags[5] = -ctx.cts_diags[5]
    elif step == "stc":
        ctx.stc_diags[5] = -ctx.stc_diags[5]
    else:
        monkeypatch.setattr(B, "eval_mod", lambda ct, c: ckks.mul_const(
            ct, 1.0 / c.K_range, c.params))
    got = B.stage_errors(_stage_input(ctx, p), ctx)
    broken = [k for k, b in STAGE_BOUNDS.items() if got[k] >= b]
    assert step in broken, got
    if step == "stc":
        assert "stc_probe" in broken, got


# ------------------------------------------------------------ the port alone

def test_hrot_by_progression_hoisted_equals_hrot_hoisted():
    """With a key for every multiple, the fused engine computes the
    progression as one hoisted call, byte for byte."""
    p = prm.test_small()
    keys = K.keygen(p, rotations=(2, 4, 6), seed=1, device=CPU)
    scale = float(p.q[-1])
    z = np.linspace(-1, 1, 8) + 0.25j
    ct = K.encrypt(enc.encode(z, scale, p.q, p.N), scale, keys.sk, p.q, p.N,
                   device=CPU)
    with ckks.use_engine("fused"):
        got = ckks.hrot_by_progression(ct, 2, 3, keys)
        want = ckks.hrot_hoisted(ct, [2, 4, 6], keys)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g.a.data, w.a.data) and torch.equal(g.b.data, w.b.data)


def test_monomial_multiplication_exact():
    """ckks.mul_monomial(N/2) multiplies every slot by exactly i (free)."""
    p = prm.test_small()
    ks = K.keygen(p, seed=3, device=CPU)
    rng = np.random.default_rng(4)
    z = rng.normal(size=16) + 1j * rng.normal(size=16)
    scale = float(p.q[-1])
    ct = K.encrypt(enc.encode(z, scale, p.q, p.N), scale, ks.sk, p.q, p.N,
                   device=CPU)
    out = ckks.mul_monomial(ct, p.N // 2)
    got = enc.decode(K.decrypt(out, ks.sk), out.scale, out.basis, p.N, 16)
    np.testing.assert_allclose(got, 1j * z, atol=1e-4)
    # −i via 3N/2
    out2 = ckks.mul_monomial(ct, 3 * p.N // 2)
    got2 = enc.decode(K.decrypt(out2, ks.sk), out2.scale, out2.basis, p.N, 16)
    np.testing.assert_allclose(got2, -1j * z, atol=1e-4)


def test_match_scale_correction():
    p = prm.test_small()
    ks = K.keygen(p, seed=5, device=CPU)
    rng = np.random.default_rng(6)
    z = rng.normal(size=8)
    scale = float(p.q[-1])
    ct = K.encrypt(enc.encode(z, scale, p.q, p.N), scale, ks.sk, p.q, p.N,
                   device=CPU)
    target = scale * 1.0012      # typical prime-chain drift
    out = ckks.match_scale(ct, target, p)
    assert abs(out.scale - target) / target < 1e-6
    got = enc.decode(K.decrypt(out, ks.sk), out.scale, out.basis, p.N, 8)
    np.testing.assert_allclose(got, z, atol=1e-4)


def test_min_ks_uses_single_giant_key():
    """§V-B: with min-KS the giant steps need only evk_bs — key count drops."""
    p = prm.make_params(N=1 << 9, L=14, K=2, dnum=7)
    ctx_min = B.setup_bootstrap(p, use_min_ks=True, device=CPU)
    ctx_full = B.setup_bootstrap(p, use_min_ks=False, device=CPU)
    assert len(ctx_min.keys.galois) < len(ctx_full.keys.galois)
