"""Record the JAX package's single-device pipeline digests for the port's
distributed engine.

    PYTHONPATH=src python tests/make_torch_dist_ref.py

At ``make_params(N, L=8, K=2, dnum=4)`` for N = 256 and N = 1024 runs the
reference self-test's inputs (``repro.core._dist_selftest._make_inputs``:
``keygen(rotations=(1, 2), seed=7)``, two encryptions of normal(slots)
messages at scale q_top) and hmult → rescale → ``hrot_hoisted([1, 2])`` on
the JAX package's **eager** engine, the single-device form of the sharded
pipeline (the reference turns the fused engine off under ``dist_scope``,
``src/repro/core/ckks.py:78-87``), and on its fused engine beside it.  It
writes into ``tests/torch_dist_ref.json`` the reference's
``pipeline_digests`` of each, and the SHA-256 of the inputs (the ternary
secret, each evaluation key's seed and b-halves, both ciphertexts), so that
``tests/test_torch_distributed.py`` can show the port's own keygen and
encryption carry the same bytes across and needs no JAX.

    PYTHONPATH=src python tests/make_torch_dist_ref.py --batched

adds (or replaces) only the key ``batched``: at N = 256 the digests of the
batched families on the same inputs (``repro_torch.core._dist_selftest.
batched_chain``: hmult_many → rescale_many → hrot_many → hadd_many →
pmult_many, B = 4) on the JAX package's eager engine; every other entry of
the file stays byte for byte.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_dist_ref.json")
SIZES = (256, 1024)
ROTS = [1, 2]
SEED = 7


def inputs_record(ks, ct1, ct2) -> dict:
    """SHA-256 of the pipeline's inputs, as ``make_torch_ckks_ref`` takes them."""
    from make_torch_ckks_ref import sha
    evk = lambda ek: {"seed": int(ek.seed),
                      "b": [sha(np.asarray(b.data)) for b in ek.b]}
    return {"s_small": sha(np.asarray(ks.sk.s_small, dtype=np.int8)),
            "relin": evk(ks.relin),
            "galois": {str(g): evk(ek) for g, ek in ks.galois.items()},
            "cts": [sha(np.asarray(c.a.data), np.asarray(c.b.data))
                    for c in (ct1, ct2)]}


def record(N: int) -> dict:
    from repro.core import ckks, keys as keysm, params as prm
    from repro.core._dist_selftest import _make_inputs, pipeline_digests
    p = prm.make_params(N=N, L=8, K=2, dnum=4)
    ks, ct1, ct2 = _make_inputs(p, seed=SEED)
    out = {"inputs": inputs_record(ks, ct1, ct2), "engines": {}}
    for engine in ("eager", "fused"):
        with ckks.use_engine(engine):
            mult = ckks.rescale(ckks.hmult(ct1, ct2, ks), p)
            rots = ckks.hrot_hoisted(mult, ROTS, ks)
        out["engines"][engine] = pipeline_digests(
            mult, rots, keysm.decrypt(mult, ks.sk))
    return out


def record_batched(N: int = 256) -> dict:
    import jax.numpy as jnp
    from repro.core import ckks, encoding as enc, params as prm, poly as pl
    from repro.core._dist_selftest import _make_inputs
    from repro_torch.core._dist_selftest import (BATCH_ROTS, batched_chain,
                                                 batched_digests)
    p = prm.make_params(N=N, L=8, K=2, dnum=4)
    ks, ct1, ct2 = _make_inputs(p, seed=SEED)
    make_pt = lambda res, basis: pl.RnsPoly(jnp.asarray(res), basis, pl.COEFF)
    with ckks.use_engine("eager"):
        stages = batched_chain(ckks, enc, make_pt, p, ks, ct1, ct2)
    return {"N": N, "rotations": list(BATCH_ROTS), "engine": "eager",
            "chain": "repro_torch.core._dist_selftest.batched_chain",
            "digests": batched_digests(stages)}


def main(argv=None) -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--batched", action="store_true",
                    help="add only the batched families' digests at N = 256")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if args.batched:
        with open(args.out) as f:
            doc = json.load(f)
        doc["batched"] = {"256": record_batched(256)}
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out} (batched) in {time.perf_counter() - t0:.1f} s")
        return 0
    doc = {"config": {"params": "make_params(N, L=8, K=2, dnum=4)",
                      "inputs": "repro.core._dist_selftest._make_inputs",
                      "seed": SEED, "rotations": ROTS,
                      "pipeline": "hmult -> rescale -> hrot_hoisted",
                      "engine": "eager (the sharded pipeline's single-device "
                                "form); fused beside it",
                      "digest": "repro.core._dist_selftest.pipeline_digests"},
           "N": {str(N): record(N) for N in SIZES}}
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out} in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
