"""Serving launcher: the multi-tenant FHE serving engine (default) or the
LM decode engine, on the card.

    # FHE serving: T tenants × R requests through the batched engine
    PYTHONPATH=src python -m repro_torch.launch.serve --tenants 2 --requests 16

    # the same on the CPU (the kernels' plain versions)
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

    # LM decode: a reduced architecture through ServeEngine
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --arch qwen3_4b

The flags and defaults are the reference launcher's (``repro.launch.serve``)
plus ``--device``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def _write_metrics(path, eng) -> None:
    """Dump a full metrics snapshot (counters + serve summary + latency
    histograms) as JSON."""
    import json

    from repro_torch.runtime import tracing
    snap = tracing.metrics_snapshot(eng.metrics)
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
        f.write("\n")


def main_fhe(args):
    from repro_torch.core import encoding as enc
    from repro_torch.core import keys as K
    from repro_torch.core import params as prm
    from repro_torch.runtime import tracing
    from repro_torch.serve import (FheServeEngine, TenantKeyStore,
                                   standard_reference, standard_request)

    p = prm.make_params(N=args.N, L=args.L, K=2, dnum=2)
    print(f"FHE serving: N={p.N}, L={p.L}, dnum={p.dnum}, "
          f"{args.tenants} tenants × {args.requests} requests, "
          f"batch={args.batch}, device={args.device}")
    store = TenantKeyStore(max_resident=max(2, args.tenants))
    tenants = [f"tenant{t}" for t in range(args.tenants)]
    for i, t in enumerate(tenants):
        store.register(t, K.keygen(p, rotations=(1,), seed=i,
                                   device=args.device))

    eng = FheServeEngine(store, max_batch=args.batch,
                         batching=not args.no_batching)
    # --trace-out implies a capture even without REPRO_TRACE=on; an
    # env-started tracer (tracing.start at import) is reused as-is
    tracer = None
    if args.trace_out is not None and not tracing.enabled():
        tracer = tracing.start()
    reqs = []
    for i in range(args.requests):
        tenant = tenants[i % len(tenants)]
        req, z = standard_request(p, store.keyset(tenant), tenant, 100 + i,
                                  device=args.device)
        assert eng.submit(req)
        reqs.append((req, z))
    eng.metrics.begin_region()
    t0 = time.time()
    if args.metrics_every > 0 and args.metrics_json is not None:
        # periodic snapshot dump: overwrite the target every N steps so a
        # watching scraper always reads the freshest state
        steps = 0
        while eng.step() or eng.queue:
            steps += 1
            if steps % args.metrics_every == 0:
                _write_metrics(args.metrics_json, eng)
    else:
        eng.run_until_drained()
    dt = time.time() - t0
    region = eng.metrics.region()
    print(f"served {len(reqs)} requests in {dt:.2f}s "
          f"({len(reqs) / dt:.2f} req/s)")
    print(f"  summary: {eng.summary()}")
    print(f"  kernel launches: {region['kernel_launches']} "
          f"(const uploads {region['const_uploads']})")
    if args.trace_out is not None:
        tr = tracing.stop() if tracer is not None else tracing.active_tracer()
        tr.write_perfetto(args.trace_out)
        print(f"  wrote Perfetto trace ({len(tr.spans)} spans) to "
              f"{args.trace_out}")
    if args.metrics_json is not None:
        _write_metrics(args.metrics_json, eng)
        print(f"  wrote metrics snapshot to {args.metrics_json}")
        lat = eng.metrics.summary()["latency"]
        print("  latency p50/p95/p99 (s): " + ", ".join(
            f"{k}={v['p50']:.3g}/{v['p95']:.3g}/{v['p99']:.3g}"
            for k, v in lat.items()))
    # verify one decrypted result against the plaintext pipeline
    req, (z1, z2) = reqs[0]
    out = req.result()["out"]
    ks = store.keyset(req.tenant)
    got = enc.decode(K.decrypt(out, ks.sk), out.scale, out.basis, p.N, 8)
    err = float(np.max(np.abs(got.real - standard_reference(z1, z2))))
    print(f"  decrypt check: max err {err:.2e}")
    assert err < 1e-2


def main_lm(args):
    import torch

    from repro_torch.launch import require_device
    from repro_torch.models import registry
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import Request

    require_device(args.device)
    cfg = registry.get_config(args.arch).reduced()
    mod = registry.get_module(cfg)
    params = mod.init_params(torch.Generator(args.device).manual_seed(0), cfg)
    eng = ServeEngine(cfg, params, batch_slots=args.slots,
                      max_seq=args.max_seq, eos_id=-1)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=4),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    t0 = time.time()
    steps = 0
    while any(not r.done for r in reqs) and steps < 10_000:
        eng.step()          # reads its tokens back: waits for the device
        steps += 1
    dt = time.time() - t0
    total_tokens = sum(len(r.generated) for r in reqs)
    print(f"served {len(reqs)} requests, {total_tokens} tokens in "
          f"{dt:.1f}s ({total_tokens/dt:.1f} tok/s, {steps} engine steps, "
          f"device={args.device})")
    for r in reqs[:3]:
        print(f"  req {r.rid}: prompt {list(r.prompt)} → {r.generated}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="fhe", choices=["fhe", "lm"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="where keys and ciphertexts (lm: the model) live "
                         "(cuda runs the kernels, cpu their plain versions)")
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--no-batching", action="store_true",
                    help="sequential baseline (one op per dispatch)")
    ap.add_argument("--N", type=int, default=1 << 10)
    ap.add_argument("--L", type=int, default=4)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace.json of the run")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write a metrics snapshot (counters + latency "
                         "histograms) as JSON at the end of the run")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="with --metrics-json: also rewrite the snapshot "
                         "every N engine steps (0 = final only)")
    # lm mode
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=64)
    args = ap.parse_args(argv)
    if args.mode == "fhe":
        main_fhe(args)
    else:
        main_lm(args)


if __name__ == "__main__":
    main()
