"""Record the JAX package's op traces and Table III rows for the port's tests.

    PYTHONPATH=src python tests/make_torch_trace_ref.py [--part PART] [--engine fused|eager|both]

Writes into ``tests/torch_trace_ref.json`` (each part's entry replaced, the
others kept; the file is locked around each write, so parts can be recorded
by processes side by side):

* ``traces`` — the ``OpTrace`` (``counts``, ``calls``, ``he_ops``) the JAX
  package records, on each CKKS engine, for
  - ``pipeline``: hmult → rescale → ``hrot_hoisted([1, 4])`` at
    ``test_small`` (keys ``keygen(rotations=(1, 4), seed=0)``; keygen and
    encryption outside the trace);
  - ``bootstrap``: one ``bootstrap`` at the configuration of
    ``tests/torch_bootstrap_ref.json`` (setup and encryption outside);
  - ``serve_batched``, ``serve_sequential``: the serving of the mixed wave of
    ``tests/torch_serve_wave.py`` (its ``during`` context holds the trace;
    the requests are encrypted outside it), with ``pmult_many``: the
    (ℓ, N, B) of each call's coefficient-domain plaintexts, which the
    reference transforms twice each and the port once;
* ``table3`` — ``benchmarks/bench_workloads.py:rows`` (the CiFHER cost
  model's Table III over the paper-scale traces, 4/16/64-core default
  packages), each row with its package's ``total_mm2``.

Traces depend on shapes and control flow, not on values.  The parts take
about: table3 seconds, pipeline a minute, serve five minutes per engine,
bootstrap ten minutes per engine on a CPU.  ``tests/test_torch_ckks.py``,
``test_torch_bootstrap.py``, ``test_torch_serve.py`` and
``test_torch_analytics.py`` read the JSON and run no JAX HE op;
``chip_smoke.py`` holds its Table III rows to ``table3``.
"""
from __future__ import annotations

import argparse
import fcntl
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "tests", "torch_trace_ref.json")
PARTS = ("table3", "pipeline", "bootstrap", "serve")
PIPELINE_ROTS = [1, 4]


def trace_record(t) -> dict:
    """An OpTrace as JSON: counts as sorted [func, limbs, coeffs, count]."""
    return {"counts": sorted([f, int(ell), int(n), int(c)]
                             for (f, ell, n), c in t.counts.items()),
            "calls": dict(sorted(t.calls.items())),
            "he_ops": dict(sorted(t.he_ops.items()))}


def plus_plaintext_transforms(rec: dict, pmult_many: list) -> dict:
    """``rec`` (a :func:`trace_record`) with what the reference records and
    the port does not: for each ``pmult_many`` call [ℓ, N, B], the second
    transform of each of its B plaintexts — B more ``("ntt", ℓ, N)`` counts
    and B more ``ntt`` calls."""
    counts = {(f, ell, n): c for f, ell, n, c in rec["counts"]}
    calls = dict(rec["calls"])
    for ell, n, b in pmult_many:
        counts[("ntt", ell, n)] = counts.get(("ntt", ell, n), 0) + b
        calls["ntt"] = calls.get("ntt", 0) + b
    return {**rec, "counts": sorted([*k, c] for k, c in counts.items()),
            "calls": dict(sorted(calls.items()))}


def table3_rows(bench_rows, A, C) -> list[dict]:
    """``bench_rows()`` with each row's package area."""
    rows = bench_rows()
    for r in rows:
        r["package_area_mm2"] = A.package_area(C.default_package(r["cores"]))["total_mm2"]
    return rows


def part_table3() -> list[dict]:
    from benchmarks.bench_workloads import rows
    from repro.core import area_model as A, cost_model as C
    return table3_rows(rows, A, C)


def part_pipeline(engine: str) -> dict:
    from repro.core import ckks, encoding as enc, keys as K, params as prm
    from repro.core import trace as TR
    p = prm.test_small()
    keys = K.keygen(p, rotations=tuple(PIPELINE_ROTS), seed=0)
    scale = float(p.q[-1])
    rng = np.random.default_rng(0)
    cts = [K.encrypt(enc.encode(rng.normal(size=8), scale, p.q, p.N), scale,
                     keys.sk, p.q, p.N, rng=np.random.default_rng(i + 1))
           for i in range(2)]
    with ckks.use_engine(engine), TR.trace_ops() as t:
        r = ckks.rescale(ckks.hmult(cts[0], cts[1], keys), p)
        ckks.hrot_hoisted(r, PIPELINE_ROTS, keys)
    return trace_record(t)


def part_bootstrap(engine: str) -> dict:
    from make_torch_bootstrap_ref import CONFIG
    from repro.core import bconv, bootstrap as B, ckks, encoding as enc
    from repro.core import keys as K, params as prm, trace as TR
    p = prm.make_params(N=CONFIG["N"], L=CONFIG["L"], K=CONFIG["K"],
                        dnum=CONFIG["dnum"])
    with ckks.use_engine(engine), bconv.use_engine(
            "pallas" if engine == "fused" else "eager"):
        ctx = B.setup_bootstrap(p, hamming=CONFIG["hamming"],
                                K_range=CONFIG["K_range"],
                                cheb_deg=CONFIG["cheb_deg"],
                                use_min_ks=CONFIG["use_min_ks"], seed=CONFIG["seed"])
        z = np.random.default_rng(CONFIG["z_seed"]).normal(size=p.slots) \
            * CONFIG["z_scale"]
        scale = float(p.q[0])
        ct = K.encrypt(enc.encode(z, scale, p.q[:1], p.N), scale, ctx.keys.sk,
                       p.q[:1], p.N)
        with TR.trace_ops() as t:
            B.bootstrap(ct, ctx)
    return trace_record(t)


def part_serve(engine: str) -> dict:
    from make_torch_serve_ref import jax_api
    from torch_serve_wave import CONFIG, RUNS, keysets_for, serve
    from repro.core import keys as K, params as prm, trace as TR
    api = jax_api()
    p = prm.make_params(N=CONFIG["N"], L=CONFIG["L"], K=CONFIG["K"],
                        dnum=CONFIG["dnum"])
    keysets = keysets_for(K, p)
    many = api.ckks.pmult_many
    out = {}
    for run in RUNS:
        calls = []

        def pmult_many(cts, pts, scales):
            coeff = [pt for pt in pts if pt.domain == "coeff"]
            if coeff:
                calls.append([coeff[0].ell, coeff[0].N, len(coeff)])
            return many(cts, pts, scales)
        t = TR.OpTrace()
        api.ckks.pmult_many = pmult_many
        try:
            with api.ckks.use_engine(engine):
                serve(api, p, keysets, run, during=lambda: TR.trace_ops(t))
        finally:
            api.ckks.pmult_many = many
        out[f"serve_{run}"] = {**trace_record(t), "pmult_many": calls}
    return out


def update(path: str, fn) -> None:
    """Read the JSON, apply ``fn`` to it and write it back, the file locked
    throughout."""
    with open(path, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        f.seek(0)
        text = f.read()
        doc = json.loads(text) if text.strip() else {"traces": {}}
        fn(doc)
        f.seek(0)
        f.truncate()
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
        f.flush()
        fcntl.flock(f, fcntl.LOCK_UN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=PARTS + ("all",), default="all")
    ap.add_argument("--engine", choices=("fused", "eager", "both"), default="both")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    parts = PARTS if args.part == "all" else (args.part,)
    engines = ("fused", "eager") if args.engine == "both" else (args.engine,)
    for part in parts:
        t0 = time.perf_counter()
        if part == "table3":
            rows = part_table3()
            update(args.out, lambda d: d.__setitem__("table3", rows))
            print(part, f"{time.perf_counter() - t0:.1f}s", flush=True)
            continue
        for engine in engines:
            t0 = time.perf_counter()
            got = {"pipeline": lambda: {"pipeline": part_pipeline(engine)},
                   "bootstrap": lambda: {"bootstrap": part_bootstrap(engine)},
                   "serve": lambda: part_serve(engine)}[part]()

            def put(doc):
                doc.setdefault("traces", {})
                for name, rec in got.items():
                    doc["traces"].setdefault(name, {})[engine] = rec
            update(args.out, put)
            print(part, engine, f"{time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
