"""Record the JAX package's FHE examples for the port's example tests.

    PYTHONPATH=src python tests/make_torch_examples_ref.py [--part PART] [--engine fused|eager]

Runs one of ``examples/{quickstart,helr_training,bootstrapping_demo,
serving_demo,distributed_mapping_demo}.py`` unchanged through
``runpy.run_path`` (from the repository root, on the JAX package), with
``REPRO_CKKS_ENGINE`` set to the engine, and writes what it checked into
``tests/torch_examples_ref.json`` under ``examples[part][engine]`` (the
entry is replaced, the others kept; the file is locked around each write, so
parts can be recorded by processes side by side):

* ``decrypted`` — every ciphertext the example decrypts, in order: the
  SHA-256 of the u32 bytes of a then b, with its scale, basis, level and
  domain;
* ``decoded`` — every ``decode`` result, in order, as [re, im] pairs;
* ``he_ops`` — the example's own ``trace_ops`` (HELR, the bootstrap), or one
  around the whole script (the quickstart, the serving demo);
* for HELR also its whole op trace, the decrypted weights, the accuracy and
  the weights' level; for the bootstrap its error and the trace summary; for
  the serving demo the traced wave's ``span_summary()``, the steady-state
  uploads and plan builds; for the distributed demo the JAX program's bytes
  per device from the compiled HLO (``repro.core._dist_selftest`` traffic
  mode, ℓ = 12 → K = 48, N = 2048, 8 devices) and its correctness result.

HELR and the quickstart are recorded on both engines, the others on the
fused one (``--engine`` is ignored there).  HELR takes several minutes per
engine on a CPU, the bootstrapping demo about ten; run the parts as
processes side by side.  ``tests/test_torch_examples.py`` and
``chip_smoke.py`` read the JSON and run no JAX.
"""
from __future__ import annotations

import argparse
import fcntl
import hashlib
import json
import os
import runpy
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_examples_ref.json")
PARTS = {"quickstart": "quickstart.py", "helr": "helr_training.py",
         "bootstrapping": "bootstrapping_demo.py", "serving": "serving_demo.py",
         "distributed": "distributed_mapping_demo.py"}
BOTH_ENGINES = ("quickstart", "helr")


def digest(a, b) -> str:
    """SHA-256 of the u32 bytes of a, then of b."""
    h = hashlib.sha256()
    for x in (a, b):
        h.update(np.ascontiguousarray(np.asarray(x, dtype=np.uint32)).tobytes())
    return h.hexdigest()


def ct_record(ct) -> dict:
    return {"sha256": digest(ct.a.data, ct.b.data), "scale": float(ct.scale),
            "basis": [int(q) for q in ct.basis], "level": int(ct.level),
            "domain": ct.a.domain}


def pairs(z) -> list:
    z = np.asarray(z, dtype=np.complex128).ravel()
    return [[float(v.real), float(v.imag)] for v in z]


def trace_record(t) -> dict:
    return {"counts": sorted([f, int(ell), int(n), int(c)]
                             for (f, ell, n), c in t.counts.items()),
            "calls": dict(sorted(t.calls.items())),
            "he_ops": dict(sorted(t.he_ops.items()))}


def run_example(part: str) -> dict:
    """Run the example with ``keys.decrypt`` and ``encoding.decode`` watched;
    returns the record."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro.core import encoding, keys, trace as TR
    decrypted, decoded = [], []
    decrypt, decode = keys.decrypt, encoding.decode

    def watched_decrypt(ct, sk):
        decrypted.append(ct_record(ct))
        return decrypt(ct, sk)

    def watched_decode(*args, **kwargs):
        out = decode(*args, **kwargs)
        decoded.append(pairs(out))
        return out
    keys.decrypt, encoding.decode = watched_decrypt, watched_decode
    os.chdir(ROOT)
    try:
        with TR.trace_ops() as outer:
            g = runpy.run_path(os.path.join(ROOT, "examples", PARTS[part]),
                               run_name="__main__")
    finally:
        keys.decrypt, encoding.decode = decrypt, decode
    rec = {"decrypted": decrypted, "decoded": decoded}
    if part == "quickstart":
        rec["he_ops"] = dict(sorted(outer.he_ops.items()))
    elif part == "helr":
        rec.update(he_ops=dict(sorted(g["tr"].he_ops.items())),
                   trace=trace_record(g["tr"]),
                   w_dec=[float(w) for w in g["w_dec"]], acc=float(g["acc"]),
                   weight_level=min(int(c.level) for c in g["ct_w"]),
                   config={"N": g["p"].N, "L": g["p"].L, "K": g["p"].K,
                           "dnum": g["p"].dnum, "features": g["FEATURES"],
                           "batch": g["BATCH"], "iters": g["ITERS"]})
    elif part == "bootstrapping":
        s = g["tr"].summary()
        rec.update(he_ops=dict(sorted(g["tr"].he_ops.items())),
                   trace=trace_record(g["tr"]), max_error=float(g["err"]),
                   level=int(g["out"].level),
                   summary={k: float(s[k]) for k in
                            ("limb_ntts", "bconv_macs", "evk_bytes")})
    elif part == "serving":
        rec.update(he_ops=dict(sorted(outer.he_ops.items())),
                   span_summary=json.loads(json.dumps(g["summ"], sort_keys=True)),
                   uploads=int(g["uploads"]), plan_builds=int(g["builds"]),
                   served=len(g["requests"]))
    elif part == "distributed":
        rec.update(correctness=g["out"], traffic=g["t"],
                   definition="per-device wire bytes of the compiled HLO's "
                              "collectives (repro.launch.hlo.collective_summary)")
    return rec


def update(path: str, fn) -> None:
    """Read the JSON, apply ``fn`` to it and write it back, the file locked
    throughout."""
    with open(path, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        f.seek(0)
        text = f.read()
        doc = json.loads(text) if text.strip() else {"examples": {}}
        fn(doc)
        f.seek(0)
        f.truncate()
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        fcntl.flock(f, fcntl.LOCK_UN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=tuple(PARTS), required=True)
    ap.add_argument("--engine", choices=("fused", "eager"), default="fused")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    engine = args.engine if args.part in BOTH_ENGINES else "fused"
    os.environ["REPRO_CKKS_ENGINE"] = engine       # read when repro.core.ckks loads
    t0 = time.perf_counter()
    rec = run_example(args.part)
    rec["seconds"] = time.perf_counter() - t0
    update(args.out, lambda d: d.setdefault("examples", {}).setdefault(
        args.part, {}).__setitem__(engine, rec))
    print(args.part, engine, f"{rec['seconds']:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
