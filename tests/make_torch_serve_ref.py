"""Record the JAX package's served waves as SHA-256 digests for the port.

    PYTHONPATH=src python tests/make_torch_serve_ref.py [--engine fused|eager|both]

Serves the mixed wave of ``tests/torch_serve_wave.py`` through
``repro.serve.FheServeEngine``, both runs (``batched``, ``sequential``) on
each CKKS engine, and writes each run's record — output digests, start
order, key-store and plan-cache accounting, a mid-wave snapshot's digests —
into ``tests/torch_serve_ref.json`` (the entry of each engine run is
replaced, the others kept).  ``tests/test_torch_serve.py`` and
``chip_smoke.py`` hold the port's records to it.  One engine takes about
five minutes on a CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from torch_serve_wave import CONFIG, RUNS, Api, keysets_for, serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_serve_ref.json")


def jax_api() -> Api:
    """The JAX package's side of the wave."""
    import jax.numpy as jnp

    from repro import serve as S
    from repro.core import ckks, encoding as enc, keys as K, poly as pl
    return Api(S=S, ckks=ckks, encode=enc.encode,
               encrypt=lambda m, s, sk, b, N, rng: K.encrypt(m, s, sk, b, N, rng=rng),
               coeff_poly=lambda m, b: pl.RnsPoly(jnp.asarray(m), b, pl.COEFF),
               u32=lambda x: np.asarray(x, dtype=np.uint32))


def record_engine(engine: str) -> dict:
    from repro.core import keys as K, params as prm
    api = jax_api()
    p = prm.make_params(N=CONFIG["N"], L=CONFIG["L"], K=CONFIG["K"],
                        dnum=CONFIG["dnum"])
    keysets = keysets_for(K, p)
    out = {}
    with api.ckks.use_engine(engine):
        for run in RUNS:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                out[run], _, _ = serve(api, p, keysets, run, snapshot_dir=tmp)
            out[run]["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("fused", "eager", "both"), default="both")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    engines = ("fused", "eager") if args.engine == "both" else (args.engine,)
    for engine in engines:
        entry = record_engine(engine)
        doc = {"config": CONFIG, "engines": {}}
        if os.path.exists(args.out):
            with open(args.out) as f:
                doc = json.load(f)
        doc["config"] = CONFIG
        doc["engines"][engine] = entry
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(engine, {run: entry[run]["seconds"] for run in RUNS}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
