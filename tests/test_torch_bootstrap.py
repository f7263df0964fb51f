"""The port's bootstrap and the CKKS ops it needs, against the JAX package.

Exact equality throughout, no tolerance: the same seeds give the same bytes.
Configuration ``make_params(N=2⁷, L=14, K=2, dnum=7)`` with
``setup_bootstrap(hamming=8, K_range=4, cheb_deg=47, use_min_ks=True,
seed=0)``; the port runs on the CPU, where every kernel wrapper takes its
plain version.

* Op by op, against the SHA-256 digests ``tests/make_torch_bootstrap_ref.py
  --live`` recorded from the JAX package's eager engines (eager CKKS, eager
  BConv) under ``live`` in ``tests/torch_bootstrap_ref.json``: the port's
  ``setup_bootstrap`` context, carried across with
  :mod:`repro_torch.interop`, and its eager engine on the same three inputs;
  ``apply_automorphism_coeff`` live against the JAX package (skipped
  without ``jax``).
* The whole bootstrap and a degree-5 ``eval_chebyshev`` on both engines,
  against the digests the same script recorded (the JAX bootstrap takes
  many minutes).
* The port alone: the hoisted branch of ``hrot_by_progression``, the
  reference's fast bootstrap tests, and the bootstrap's precision.
"""
import json
import os

import numpy as np
import pytest
import torch

from make_torch_bootstrap_ref import (LIVE_OPS, NEW_ROTATIONS, context_record,
                                      evk_record, inputs, live_ops, record)
from repro_torch import interop
from repro_torch.core import bconv, bootstrap as B, ckks, encoding as enc
from repro_torch.core import keys as K, params as prm, poly as pl

CPU = torch.device("cpu")
with open(os.path.join(os.path.dirname(__file__), "torch_bootstrap_ref.json")) as _f:
    REF = json.load(_f)
CFG = REF["config"]
BOOT = {k: CFG[k] for k in ("hamming", "K_range", "cheb_deg", "use_min_ks", "seed")}
ENGINES = {"fused": "kernel", "eager": "eager"}       # CKKS engine → BConv engine


def boot_params():
    return prm.make_params(N=CFG["N"], L=CFG["L"], K=CFG["K"], dnum=CFG["dnum"])


def message(n):
    return np.random.default_rng(CFG["z_seed"]).normal(size=n) * CFG["z_scale"]


def _np_evk(ek):
    return int(ek.seed), [pl.to_numpy(b.data) for b in ek.b]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's eager-engine records (``live`` of
    tests/torch_bootstrap_ref.json)."""
    return REF["live"]


@pytest.fixture(scope="module")
def port():
    """The port's ``setup_bootstrap`` context, a copy carried across with
    :mod:`repro_torch.interop` from its secret and keys, and the eager engine's
    ops on that copy and three native encryptions (CPU)."""
    p = boot_params()
    mine = B.setup_bootstrap(p, **BOOT, device=CPU)
    keys = mine.keys
    ctx = interop.bootcontext_from_numpy(
        p, keys.sk.s_small.copy(), _np_evk(keys.relin),
        {g: _np_evk(ek) for g, ek in keys.galois.items()}, mine.K_range,
        mine.cheb_coeffs, mine.bs, mine.use_min_ks, device=CPU)
    cts = [ckks.level_drop(K.encrypt(enc.encode(z, s, p.q, p.N), s, ctx.keys.sk,
                                     p.q, p.N, rng=np.random.default_rng(seed),
                                     device=CPU), ell)
           for z, s, seed, ell in inputs(p)]
    with ckks.use_engine("eager"), bconv.use_engine("eager"):
        ops = live_ops(ckks, B, cts, ctx.keys, ctx, p)
    return {"params": p, "mine": mine, "ctx": ctx, "cts": cts, "ops": ops}


@pytest.mark.parametrize("op", LIVE_OPS)
def test_op_matches_reference(ref, port, op):
    assert [record(c) for c in port["cts"]] == ref["cts"]
    assert record(port["ops"][op]) == ref["ops"][op]


def test_add_galois_keys_matches_reference(ref, port):
    """Seeds and b-halves of the added keys equal the reference's; a present
    rotation is skipped without drawing, and a second call adds nothing."""
    keys = port["ctx"].keys
    before = dict(keys.galois)
    K.add_galois_keys(keys, NEW_ROTATIONS, seed=1, device=CPU)
    added = {str(g): evk_record(ek) for g, ek in keys.galois.items()
             if g not in before}
    assert added == ref["added"] and len(added) == 2
    after = dict(keys.galois)
    K.add_galois_keys(keys, NEW_ROTATIONS, seed=1, device=CPU)
    assert all(keys.galois[g] is after[g] for g in after) and keys.galois == after
    assert ref["idempotent"]
    for g in set(keys.galois) - set(before):     # leave the shared context as it was
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
    """The port's own setup and the context carried across from its secret
    and keys both equal the JAX package's: diagonals, Chebyshev
    coefficients, BSGS split and keys."""
    assert context_record(port["mine"]) == ref["ctx"]
    assert context_record(port["ctx"]) == ref["ctx"]


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
    assert record(boot_run["stages"][stage]) == {k: want[k] for k in (
        "sha256", "scale", "basis", "level", "domain")}


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
    assert record(got["out"])["sha256"] == REF["engines"][engine]["bootstrap"]["sha256"]


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
