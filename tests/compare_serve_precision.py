"""The served wave's decode error at its widths, by ring size.

    PYTHONPATH=src python tests/compare_serve_precision.py --log-n 10 [--no-jax]
    PYTHONPATH=src python tests/compare_serve_precision.py --log-n 12 --no-jax --no-hrot
    python tests/compare_serve_precision.py --log-n 16 --cross     # on a CUDA card

At ``make_params(N=2^log_n, L=48, K=12, dnum=4)`` (the L, K and dnum of
``chip_smoke.py`` phase ``serve``), single-prime scale q_top, keys
``keygen(rotations=(1,), seed=0)``: encrypts z = normal(8) from
``default_rng(5)`` at basis q[:47] (the level program A rotates at) and
rotates it by 1 with ``ckks.hrot`` on the port's fused and eager engines
(CPU, plain versions), then on the JAX package's fused engine (eager BConv,
the same bytes as its Pallas one), and prints each decode error against
z rotated on the host and whether the JAX package's rotated ``a`` half has
the port's bytes (``--no-hrot`` skips this part).  It then serves the
mixed wave (``tests/torch_serve_wave.py``; ``--requests``, default 16 as in
``chip_smoke.py``, one batch) through the port on the CPU and prints the
largest decode error of each program, the statistic phase ``serve`` reads.
``--cross`` serves the wave's first request (program A) alone on the CPU
and on the card instead (keys for its tenant only), and prints whether the
two outputs have equal bytes, each one's decode error and its error in each
of the 8 slots.  ``--no-jax`` runs the port alone.  The
JAX run compiles for minutes at log_n ≥ 11.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))


def rotate_once(K, prm, enc, ckks, u32, log_n: int, engine: str, **kw):
    """(decode error of hrot by 1, SHA-256 of the rotated a-half)."""
    p = prm.make_params(N=1 << log_n, L=48, K=12, dnum=4)
    ks = K.keygen(p, rotations=(1,), seed=0, **kw)
    scale, rng = float(p.q[-1]), np.random.default_rng(5)
    z, basis = rng.normal(size=8), p.q[:p.L - 1]
    ct = K.encrypt(enc.encode(z, scale, basis, p.N), scale, ks.sk, basis, p.N,
                   rng=rng, **kw)
    with ckks.use_engine(engine):
        out = ckks.hrot(ct, 1, ks)
    got = enc.decode(np.asarray(K.decrypt(out, ks.sk)), out.scale, out.basis, p.N, 8)
    return (float(np.max(np.abs(got.real - np.append(z[1:], 0.0)))),
            hashlib.sha256(u32(out.a.data).tobytes()).hexdigest())


def serve_wave(W, S, K, enc, p, device: str, n: int, tenants=None):
    """Serve ``n`` requests of the mixed wave in one batch on ``device``
    (keys for the first ``tenants`` tenants only, if given): [(program,
    decode error, output ciphertext)]."""
    cfg = dict(W.CONFIG, tenants=W.CONFIG["tenants"][:tenants])
    keysets = W.keysets_for(K, p, cfg, device=device)
    store = S.TenantKeyStore(max_resident=2)
    for t, ks in keysets.items():
        store.register(t, ks)
    S.set_rid_counter(0)
    wave = W.wave(W.port_api(device), p, keysets, n, W.CONFIG["base_seed"])
    eng = S.FheServeEngine(store, max_batch=max(n, 1))
    for req, _ in wave:
        eng.submit(req)
    eng.run_until_drained()
    out = []
    for req, z in wave:
        ct = req.result()["out"]
        got = enc.decode(K.decrypt(ct, keysets[req.tenant].sk), ct.scale, ct.basis,
                         p.N, 8)
        diff = got - W.expected(z)
        out.append(("A" if z[2] is None else "B", float(np.max(np.abs(diff.real))),
                    ct, diff))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=10)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--no-jax", action="store_true")
    ap.add_argument("--no-hrot", action="store_true")
    ap.add_argument("--cross", action="store_true")
    args = ap.parse_args(argv)
    import torch_serve_wave as W
    from repro_torch import serve as S
    from repro_torch.core import ckks, encoding as enc, keys as K, params as prm
    from repro_torch.core import poly as pl
    t0 = time.perf_counter()
    p = prm.make_params(N=1 << args.log_n, L=48, K=12, dnum=4)
    if args.cross:
        import torch
        runs = {d: serve_wave(W, S, K, enc, p, d, 1, tenants=1)[0]
                for d in ("cpu", "cuda")}
        equal = all(torch.equal(getattr(runs["cpu"][2], h).data,
                                getattr(runs["cuda"][2], h).data.cpu())
                    for h in ("a", "b"))
        print(f"N = 2^{args.log_n}, L = 48: program A request alone, decode error "
              f"CPU {runs['cpu'][1]!r}, card {runs['cuda'][1]!r}; "
              f"equal bytes: {equal}", flush=True)
        for d, run in runs.items():
            print(f"  {d} error by slot: {np.array2string(run[3], precision=6)}")
        print(f"{time.perf_counter() - t0:.0f} s")
        return 0 if equal else 1
    if not args.no_hrot:
        port = {e: rotate_once(K, prm, enc, ckks, pl.to_numpy, args.log_n, e,
                               device="cpu") for e in ("fused", "eager")}
        print(f"N = 2^{args.log_n}, L = 48: port hrot error fused {port['fused'][0]:.4e}, "
              f"eager {port['eager'][0]:.4e}", flush=True)
    errors = serve_wave(W, S, K, enc, p, "cpu", args.requests)
    worst = {k: max(e for prog, e, _, _ in errors if prog == k)
             for k in sorted({prog for prog, *_ in errors})}
    print(f"N = 2^{args.log_n}, L = 48: wave of {args.requests}, largest decode "
          f"error " + ", ".join(f"{k} {e!r}" for k, e in worst.items()), flush=True)
    if not (args.no_jax or args.no_hrot):
        from repro.core import bconv as jbc, ckks as jckks, encoding as jenc
        from repro.core import keys as jK, params as jprm
        with jbc.use_engine("eager"):
            err, digest = rotate_once(jK, jprm, jenc, jckks,
                                      lambda x: np.asarray(x, dtype=np.uint32),
                                      args.log_n, "fused")
        print(f"N = 2^{args.log_n}, L = 48: JAX hrot error fused {err:.4e}, "
              f"bytes equal to the port's: {digest == port['fused'][1]}", flush=True)
    print(f"{time.perf_counter() - t0:.0f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
