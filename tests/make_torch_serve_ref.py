"""Record the JAX package's served waves as SHA-256 digests for the port.

    PYTHONPATH=src python tests/make_torch_serve_ref.py [--engine fused|eager|both]
    PYTHONPATH=src python tests/make_torch_serve_ref.py --batched-ops

Serves the mixed wave of ``tests/torch_serve_wave.py`` through
``repro.serve.FheServeEngine``, both runs (``batched``, ``sequential``) on
each CKKS engine, and writes each run's record — output digests, start
order, key-store and plan-cache accounting, a mid-wave snapshot's digests —
into ``tests/torch_serve_ref.json`` (the entry of each engine run is
replaced, the others kept).  ``tests/test_torch_serve.py`` and
``chip_smoke.py`` hold the port's records to it.  One engine takes about
five minutes on a CPU.

``--batched-ops`` records instead, under ``batched_ops``, each batched op of
``torch_serve_wave.BATCHED_OPS`` (``hadd_many``, ``hadd_many(sub=True)``,
``pmult_many``, ``hmult_many``, ``square_many``, ``rescale_many``) over
``batch_inputs`` with tenant "alice"'s keys, on both CKKS engines: each
output's digest, scale, basis and domain (about a minute and a half, almost
all of it XLA compiling each op once per shape).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from torch_serve_wave import (CONFIG, RUNS, Api, batch_inputs, batched_ops,
                              ct_record, keysets_for, serve)

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


def record_batched_ops() -> dict:
    from repro.core import keys as K, params as prm
    api = jax_api()
    p = prm.make_params(N=CONFIG["N"], L=CONFIG["L"], K=CONFIG["K"],
                        dnum=CONFIG["dnum"])
    keys = keysets_for(K, p)["alice"]
    inputs = batch_inputs(api, keys, p)
    out = {}
    for engine in ("fused", "eager"):
        with api.ckks.use_engine(engine):
            ops = batched_ops(api.ckks, *inputs, keys, p)
        out[engine] = {op: [ct_record(api, c) for c in cts]
                       for op, cts in ops.items()}
    return out


def main(argv=None) -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("fused", "eager", "both"), default="both")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--batched-ops", action="store_true",
                    help="record the batched ops' section instead")
    args = ap.parse_args(argv)
    if args.batched_ops:
        t0 = time.perf_counter()
        with open(args.out) as f:
            doc = json.load(f)
        doc["batched_ops"] = record_batched_ops()
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print("batched_ops", f"{time.perf_counter() - t0:.1f}s", flush=True)
        return 0
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
