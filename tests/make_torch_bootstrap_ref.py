"""Record the JAX package's bootstrap as SHA-256 digests for the port's tests.

    PYTHONPATH=src python tests/make_torch_bootstrap_ref.py [--engine fused|eager|both]
    PYTHONPATH=src python tests/make_torch_bootstrap_ref.py --live

Runs ``repro.core.bootstrap`` at ``make_params(N=2⁷, L=14, K=2, dnum=7)`` with
``setup_bootstrap(hamming=8, K_range=4, cheb_deg=47, use_min_ks=True, seed=0)``
on one engine — ``fused`` (the default CKKS and BConv engines) or ``eager``
(the eager CKKS engine and the eager BConv) — and writes, for every
ciphertext below, the SHA-256 of the u32 bytes of a then b, with its scale,
basis, level and domain, into ``tests/torch_bootstrap_ref.json`` (the entry of
each engine run is replaced, the others kept):

* ``mod_raise`` — the input after ModRaise;
* ``cts_u0``, ``cts_u1`` — the two halves out of CoeffToSlot;
* ``eval_mod_u0`` — EvalMod of ``cts_u0``;
* ``bootstrap`` — ModRaise → CoeffToSlot → EvalMod (both halves) →
  SlotToCoeff, the steps of ``bootstrap()`` in its order;
* ``chebyshev5`` — ``eval_chebyshev(cts_u0, CHEB5)``.

The input is z = 0.05·normal(64) from ``default_rng(0)``, encoded at basis
q[:1] with scale q₁ and encrypted with the default encryption randomness.  The
JAX package runs every compiled shape once, so one engine takes many minutes on
a CPU; ``--engine both`` runs the two one after the other, and two processes
with one engine each can run side by side (each rewrites only its own entry).
The test file ``tests/test_torch_bootstrap.py`` reads the JSON and needs no JAX.

``--live`` records instead, under ``live``, what the port's eager engine is
held to op by op: on the JAX package's eager engines (eager CKKS, eager
BConv), the context of ``setup_bootstrap`` (digests of the secret, of each
key's b-halves with its seed, of the Chebyshev coefficients and of both
transforms' diagonals, and the BSGS split), three input ciphertexts
(:func:`inputs`), every op of :func:`live_ops` on them, and the keys
``add_galois_keys(NEW_ROTATIONS, seed=1)`` adds (about two minutes).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

OUT = os.path.join(ROOT, "tests", "torch_bootstrap_ref.json")
CONFIG = {"N": 1 << 7, "L": 14, "K": 2, "dnum": 7, "hamming": 8, "K_range": 4,
          "cheb_deg": 47, "use_min_ks": True, "seed": 0, "z_seed": 0,
          "z_scale": 0.05}
CHEB5 = [0.1, 0.2, -0.3, 0.05, 0.02, 0.01]


# the ops of --live, one test case each in tests/test_torch_bootstrap.py
LIVE_OPS = ("mul_const", "mul_monomial_half", "mul_monomial_three_halves",
            "match_scale", "add_matched_rescales_c2", "sub_matched_rescales_c1",
            "add_const", "hrot_by_progression_0", "hrot_by_progression_1",
            "mod_raise", "linear_transform")
LT_DIAGS = (0, 5, 37)
NEW_ROTATIONS = (1, 16, 24)        # 1 has a key already; 16, 24 are new


def digest(a: np.ndarray, b: np.ndarray) -> str:
    """SHA-256 of the u32 bytes of a, then of b."""
    h = hashlib.sha256()
    for x in (a, b):
        h.update(np.ascontiguousarray(np.asarray(x, dtype=np.uint32)).tobytes())
    return h.hexdigest()


def record(ct) -> dict:
    return {"sha256": digest(np.asarray(ct.a.data), np.asarray(ct.b.data)),
            "scale": float(ct.scale), "basis": [int(q) for q in ct.basis],
            "level": int(ct.level), "domain": ct.a.domain}


def sha(*arrays) -> str:
    """SHA-256 of the arrays' bytes, one after the other: residues as u32,
    int8 and floating arrays as they are."""
    h = hashlib.sha256()
    for x in arrays:
        x = np.asarray(x)
        if x.dtype.kind in "iu" and x.dtype != np.int8:
            x = x.astype(np.uint32)
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def evk_record(ek) -> dict:
    return {"seed": int(ek.seed), "b": [sha(b.data) for b in ek.b]}


def context_record(ctx) -> dict:
    """A bootstrap context's key material and constants, as digests."""
    keys = ctx.keys
    diags = lambda m: sha(*(x for d in sorted(m) for x in (
        np.int64(d), np.asarray(m[d], dtype=np.complex128))))
    return {"s_small": sha(keys.sk.s_small), "relin": evk_record(keys.relin),
            "galois": {str(g): evk_record(ek) for g, ek in keys.galois.items()},
            "K_range": int(ctx.K_range), "bs": int(ctx.bs),
            "use_min_ks": bool(ctx.use_min_ks),
            "cheb_coeffs": sha(np.asarray(ctx.cheb_coeffs, dtype=np.float64)),
            "cts_diags": diags(ctx.cts_diags), "stc_diags": diags(ctx.stc_diags)}


def inputs(p):
    """(message, scale, encryption seed, limbs kept) of the three input
    ciphertexts of --live: the full basis at scale q_L; 13 limbs at scale
    1.0012·q_L; one limb at scale q₁.  Each is encrypted at the full basis
    and dropped to its limbs, so the JAX package compiles one encryption
    shape."""
    rng = np.random.default_rng(11)
    z = rng.normal(size=16) + 1j * rng.normal(size=16)
    return ((z, float(p.q[-1]), 3, p.L), (z[::-1], 1.0012 * float(p.q[-1]), 4, 13),
            (z.real * 0.05, float(p.q[0]), 5, 1))


def lt_diags(n):
    rng = np.random.default_rng(12)
    diags = {d: np.zeros(n, dtype=np.complex128) for d in range(n)}
    for d in LT_DIAGS:
        diags[d] = rng.normal(size=n) + 1j * rng.normal(size=n)
    return diags


def live_ops(mod_ckks, mod_B, cts, keys, ctx, p):
    """{op: ciphertext} of every op of LIVE_OPS, in one order for both
    packages."""
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
            "linear_transform": mod_B.linear_transform(ct, lt_diags(p.slots), ctx)}


def live(config: dict = CONFIG) -> dict:
    """The --live records, from the JAX package's eager engines."""
    from repro.core import bconv, bootstrap as B, ckks, encoding as enc
    from repro.core import keys as K, params as prm

    t0 = time.perf_counter()
    p = prm.make_params(N=config["N"], L=config["L"], K=config["K"],
                        dnum=config["dnum"])
    with ckks.use_engine("eager"), bconv.use_engine("eager"):
        ctx = B.setup_bootstrap(p, hamming=config["hamming"],
                                K_range=config["K_range"],
                                cheb_deg=config["cheb_deg"],
                                use_min_ks=config["use_min_ks"],
                                seed=config["seed"])
        keys = ctx.keys
        cts = [ckks.level_drop(K.encrypt(enc.encode(z, s, p.q, p.N), s, keys.sk,
                                         p.q, p.N, rng=np.random.default_rng(seed)),
                               ell) for z, s, seed, ell in inputs(p)]
        out = {"ctx": context_record(ctx), "cts": [record(c) for c in cts],
               "ops": {k: record(c) for k, c in
                       live_ops(ckks, B, cts, keys, ctx, p).items()}}
        before = dict(keys.galois)
        K.add_galois_keys(keys, NEW_ROTATIONS, seed=1)
        out["added"] = {str(g): evk_record(ek) for g, ek in keys.galois.items()
                        if g not in before}
        after = dict(keys.galois)
        K.add_galois_keys(keys, NEW_ROTATIONS, seed=1)
        out["idempotent"] = keys.galois == after and all(
            keys.galois[g] is after[g] for g in after)
    out["seconds"] = time.perf_counter() - t0
    return out


def run(engine: str, config: dict = CONFIG) -> dict:
    """The JAX package's bootstrap pieces on ``engine`` at ``config``."""
    from repro.core import bconv, bootstrap as B, ckks, encoding as enc
    from repro.core import keys as K, params as prm

    t0 = time.perf_counter()
    p = prm.make_params(N=config["N"], L=config["L"], K=config["K"],
                        dnum=config["dnum"])
    with ckks.use_engine(engine), bconv.use_engine(
            "pallas" if engine == "fused" else "eager"):
        ctx = B.setup_bootstrap(p, hamming=config["hamming"],
                                K_range=config["K_range"],
                                cheb_deg=config["cheb_deg"],
                                use_min_ks=config["use_min_ks"],
                                seed=config["seed"])
        z = np.random.default_rng(config["z_seed"]).normal(size=p.slots) \
            * config["z_scale"]
        scale = float(p.q[0])
        ct = K.encrypt(enc.encode(z, scale, p.q[:1], p.N), scale, ctx.keys.sk,
                       p.q[:1], p.N)
        raised = B.mod_raise(ct, p)
        u0, u1 = B.coeff_to_slot(raised, ctx)
        v0 = B.eval_mod(u0, ctx)
        out = B.slot_to_coeff(v0, B.eval_mod(u1, ctx), ctx)
        cheb = B.eval_chebyshev(u0, np.array(CHEB5), ctx)
    got = enc.decode(K.decrypt(out, ctx.keys.sk), out.scale, out.basis, p.N,
                     p.slots)
    return {"mod_raise": record(raised), "cts_u0": record(u0),
            "cts_u1": record(u1), "eval_mod_u0": record(v0),
            "bootstrap": record(out), "chebyshev5": record(cheb),
            "max_error": float(np.max(np.abs(got - z))),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("fused", "eager", "both"), default="both")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--live", action="store_true",
                    help="record the op-by-op section instead")
    args = ap.parse_args(argv)
    if args.live:
        with open(args.out) as f:
            doc = json.load(f)
        doc["live"] = live()
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print("live", json.dumps({"seconds": doc["live"]["seconds"]}), flush=True)
        return 0
    engines = ("eager", "fused") if args.engine == "both" else (args.engine,)
    for engine in engines:
        entry = run(engine)
        doc = {"config": CONFIG, "cheb5": CHEB5, "engines": {}}
        if os.path.exists(args.out):
            with open(args.out) as f:
                doc = json.load(f)
        doc["engines"][engine] = entry
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(engine, json.dumps({k: entry[k] for k in ("max_error", "seconds")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
