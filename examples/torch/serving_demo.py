"""Multi-tenant FHE serving demo on the PyTorch/CUDA port.

    python examples/torch/serving_demo.py                 # the card
    python examples/torch/serving_demo.py --device cpu    # plain versions

``examples/serving_demo.py`` on ``repro_torch``: two tenants with independent
secret keys submit encrypted multiply-rotate-accumulate requests at N = 2¹⁰,
L = 4; the serving engine batches the same-shaped ops of different requests
into single stacked dispatches, keeps each tenant's evks device-resident
through the key store and reuses cached plans.  Decrypted results are checked
per tenant; a second, traced wave must stage no constant and build no plan.
The traced wave is written as a Perfetto trace and the metrics as Prometheus
text into ``--out-dir`` (default: a fresh temporary directory).  On
``--device cuda`` without a GPU it fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.core import const_cache, encoding as enc, keys as K, params as prm
from repro_torch.runtime import tracing
from repro_torch.serve import (FheServeEngine, TenantKeyStore, standard_reference,
                               standard_request)

BOUND = 1e-2


def run_serving_demo(device="cuda", out_dir=None, verbose: bool = False) -> dict:
    """Serve two waves of 8 requests; returns {"outputs": the first wave's
    decrypted ciphertexts, "decoded", "uploads", "plan_builds",
    "span_summary", "trace_path", "prometheus_path"}."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not available")
    out_dir = Path(out_dir or tempfile.mkdtemp(prefix="serving_demo_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    p = prm.make_params(N=1 << 10, L=4, K=2, dnum=2)
    if verbose:
        print(f"CKKS params: N={p.N}, L={p.L}, dnum={p.dnum}")
    store = TenantKeyStore(max_resident=4)
    for i, tenant in enumerate(("alice", "bob")):
        store.register(tenant, K.keygen(p, rotations=(1,), seed=i, device=device))

    def make_request(tenant: str, seed: int):
        return standard_request(p, store.keyset(tenant), tenant, seed, device=device)

    engine = FheServeEngine(store, max_batch=8)
    requests = []
    for i in range(8):
        req, z = make_request("alice" if i % 2 == 0 else "bob", 100 + i)
        assert engine.submit(req)
        requests.append((req, z))
    engine.run_until_drained()
    if verbose:
        print(f"served: {engine.summary()}")

    outputs, decoded = [], []
    for req, (z1, z2) in requests:
        ks = store.keyset(req.tenant)
        out = req.result()["out"]
        got = enc.decode(K.decrypt(out, ks.sk), out.scale, out.basis, p.N, 8)
        err = float(np.max(np.abs(got.real - standard_reference(z1, z2))))
        assert err < BOUND, f"req {req.rid}: err {err}"
        outputs.append(out)
        decoded.append(got)
    if verbose:
        print("all decrypted results match plaintext math")

    # steady state: a second identical wave stages nothing and builds no plans —
    # traced this time, to show the observability surfaces.  Its requests are
    # encrypted before the trace opens: on card data encryption launches
    # kernels (NTT, EFU) that belong to no span, where the JAX package's
    # encryption launches none.
    before = const_cache.stage_events()
    misses = engine.plans.misses
    wave = [make_request("alice" if i % 2 == 0 else "bob", 300 + i)[0]
            for i in range(8)]
    with tracing.capture() as tr:
        for req in wave:
            engine.submit(req)
        engine.run_until_drained()
    uploads = const_cache.stage_events_since(before)
    builds = engine.plans.misses - misses
    if verbose:
        print(f"steady-state wave: {uploads} const uploads, {builds} plan builds")
    assert uploads == 0 and builds == 0

    # per-request timelines as a Chrome/Perfetto trace; the span-tree summary
    # is wall-clock-free and identical run to run
    trace_path = out_dir / "serving_demo_trace.json"
    tr.write_perfetto(trace_path)
    doc = json.loads(trace_path.read_text())
    assert isinstance(doc["traceEvents"], list) and doc["traceEvents"]
    summ = tr.span_summary()
    if verbose:
        print(f"traced wave: {len(tr.spans)} spans, "
              f"{len(doc['traceEvents'])} trace events -> {trace_path}")
    attributed = sum(n for v in summ["spans"].values()
                     for n in v["launches"].values())
    assert attributed == sum(tr.launches.values())
    assert summ["requests"]["admitted"] == 8 == summ["requests"]["terminal"]["ok"]

    # metrics snapshot: deterministic counters + p50/p95/p99 latency
    # histograms, rendered as Prometheus text exposition
    snap = tracing.metrics_snapshot(engine.metrics)
    lat = snap["serve"]["latency"]
    if verbose:
        print("latency p50/p95/p99 (s): " + ", ".join(
            f"{k}={v['p50']:.3g}/{v['p95']:.3g}/{v['p99']:.3g}"
            for k, v in lat.items()))
    prom = tracing.render_prometheus(snap)
    assert "repro_kernel_launches_total" in prom
    assert "repro_serve_serve_seconds" in prom
    assert lat["serve"]["count"] == 16      # both waves
    prom_path = out_dir / "serving_demo_metrics.prom"
    prom_path.write_text(prom)
    return {"outputs": outputs, "decoded": decoded, "uploads": uploads,
            "plan_builds": builds, "span_summary": summ,
            "trace_path": str(trace_path), "prometheus_path": str(prom_path)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    res = run_serving_demo(args.device, args.out_dir, verbose=True)
    print(f"Prometheus text -> {res['prometheus_path']}")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
