"""Record the JAX package's CKKS pipeline as SHA-256 digests for the port.

    PYTHONPATH=src python tests/make_torch_ckks_ref.py

At ``test_small`` (N = 2¹⁰, L = 6, K = 2, dnum = 3) runs the JAX package's
``keygen(rotations=(1, 4), seed=0)``, encrypts the two messages of
``tests/test_torch_ckks.py`` (scale q_top, encryption randomness
``default_rng(i + 1)``), then hmult → rescale → hrot_hoisted([1, 4]) on the
fused and on the eager engine, and writes into ``tests/torch_ckks_ref.json``
the SHA-256 of the u32 bytes of everything the tests compare: the ternary
secret (int8 bytes), each evaluation key's seed and b-halves, the relin key's
regenerated a-halves, the two ciphertexts, each stage's ciphertext (a then b,
with scale, basis and domain) and its decryption.  ``tests/test_torch_ckks.py``
reads the JSON and needs no JAX.
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
OUT = os.path.join(ROOT, "tests", "torch_ckks_ref.json")
ROTS = [1, 4]
ENGINES = ("fused", "eager")
STAGES = ("hmult", "rescale", "rot1", "rot4")


def sha(*arrays) -> str:
    """SHA-256 of the arrays' bytes, one after the other (residues as u32)."""
    h = hashlib.sha256()
    for x in arrays:
        x = np.asarray(x)
        if x.dtype != np.int8:
            x = x.astype(np.uint32) if x.dtype != np.int32 else x.view(np.uint32)
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def ct_record(a, b, scale, basis, domain) -> dict:
    return {"sha256": sha(a, b), "scale": float(scale),
            "basis": [int(q) for q in basis], "domain": domain}


def messages():
    rng = np.random.default_rng(0)
    z1 = rng.normal(size=8) + 1j * rng.normal(size=8)
    z2 = rng.normal(size=8) + 1j * rng.normal(size=8)
    return z1, z2


def record() -> dict:
    from repro.core import ckks, encoding as enc, keys as K, params as prm
    p = prm.test_small()
    keys = K.keygen(p, rotations=tuple(ROTS), seed=0)
    scale = float(p.q[-1])
    cts = [K.encrypt(enc.encode(z, scale, p.q, p.N), scale, keys.sk, p.q, p.N,
                     rng=np.random.default_rng(i + 1))
           for i, z in enumerate(messages())]
    rec = lambda c: ct_record(np.asarray(c.a.data), np.asarray(c.b.data), c.scale,
                              c.basis, c.a.domain)
    evk = lambda ek: {"seed": int(ek.seed),
                      "b": [sha(np.asarray(b.data)) for b in ek.b]}
    out = {"s_small": sha(np.asarray(keys.sk.s_small, dtype=np.int8)),
           "relin": {**evk(keys.relin),
                     "a": [sha(np.asarray(a.data)) for a in keys.relin.a()]},
           "galois": {str(g): evk(ek) for g, ek in keys.galois.items()},
           "cts": [rec(c) for c in cts], "engines": {}}
    for engine in ENGINES:
        with ckks.use_engine(engine):
            m = ckks.hmult(*cts, keys)
            r = ckks.rescale(m, p)
            rots = ckks.hrot_hoisted(r, ROTS, keys)
        stages = dict(zip(STAGES, [m, r, *rots]))
        out["engines"][engine] = {
            s: {**rec(c), "decrypt_sha256": sha(np.asarray(K.decrypt(c, keys.sk)))}
            for s, c in stages.items()}
    return out


def main(argv=None) -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    doc = {"config": {"preset": "test_small", "rotations": ROTS, "seed": 0},
           **record()}
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out} in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
