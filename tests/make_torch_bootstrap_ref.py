"""Record the JAX package's bootstrap as SHA-256 digests for the port's tests.

    PYTHONPATH=src python tests/make_torch_bootstrap_ref.py [--engine fused|eager|both]

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
    args = ap.parse_args(argv)
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
