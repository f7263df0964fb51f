"""Run the JAX package's bootstrap and the port's, on the CPU, at one ring size.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/compare_bootstrap_precision.py \\
        --log-n 9 [--engine eager|fused]

The configuration is ``tests/make_torch_bootstrap_ref.py``'s (L = 14, K = 2,
dnum = 7, ``setup_bootstrap(hamming=8, K_range=4, cheb_deg=47,
use_min_ks=True, seed=0)``, z = 0.05·normal(n) from ``default_rng(0)`` at
basis q[:1], scale q₁) with N = 2^log_n; at N = 2⁹ it is the reference's own
``tests/test_bootstrap.py``.  Both packages run every stage the digest file
records, on one engine, and the script prints one JSON line: per stage the
two SHA-256 digests and whether they are equal, each package's decode error
and seconds.  It is not collected by pytest; the JAX package takes many
minutes a ring size on a CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_bootstrap_ref as ref  # noqa: E402

STAGES = ("mod_raise", "cts_u0", "cts_u1", "eval_mod_u0", "bootstrap", "chebyshev5")


def run_port(engine: str, config: dict) -> dict:
    """The port's bootstrap pieces on ``engine`` at ``config``, on the CPU."""
    import torch
    from repro_torch.core import bconv, bootstrap as B, ckks, encoding as enc
    from repro_torch.core import keys as K, params as prm
    from repro_torch.core import poly as pl

    def record(ct) -> dict:
        return {"sha256": ref.digest(pl.to_numpy(ct.a.data), pl.to_numpy(ct.b.data))}

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    p = prm.make_params(N=config["N"], L=config["L"], K=config["K"],
                        dnum=config["dnum"])
    with ckks.use_engine(engine), bconv.use_engine(
            "kernel" if engine == "fused" else "eager"):
        ctx = B.setup_bootstrap(p, hamming=config["hamming"],
                                K_range=config["K_range"],
                                cheb_deg=config["cheb_deg"],
                                use_min_ks=config["use_min_ks"],
                                seed=config["seed"], device=cpu)
        z = np.random.default_rng(config["z_seed"]).normal(size=p.slots) \
            * config["z_scale"]
        scale = float(p.q[0])
        ct = K.encrypt(enc.encode(z, scale, p.q[:1], p.N), scale, ctx.keys.sk,
                       p.q[:1], p.N, device=cpu)
        raised = B.mod_raise(ct, p)
        u0, u1 = B.coeff_to_slot(raised, ctx)
        v0 = B.eval_mod(u0, ctx)
        out = B.slot_to_coeff(v0, B.eval_mod(u1, ctx), ctx)
        cheb = B.eval_chebyshev(u0, np.array(ref.CHEB5), ctx)
    got = enc.decode(K.decrypt(out, ctx.keys.sk), out.scale, out.basis, p.N,
                     p.slots)
    return {"mod_raise": record(raised), "cts_u0": record(u0),
            "cts_u1": record(u1), "eval_mod_u0": record(v0),
            "bootstrap": record(out), "chebyshev5": record(cheb),
            "level": out.level, "max_error": float(np.max(np.abs(got - z))),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, required=True)
    ap.add_argument("--engine", choices=("fused", "eager"), default="eager")
    args = ap.parse_args(argv)
    config = dict(ref.CONFIG, N=1 << args.log_n)
    port = run_port(args.engine, config)
    jax = ref.run(args.engine, config)
    print(json.dumps({
        "N": config["N"], "engine": args.engine,
        "stages": {s: {"jax": jax[s]["sha256"], "port": port[s]["sha256"],
                       "equal": jax[s]["sha256"] == port[s]["sha256"]}
                   for s in STAGES},
        "jax": {"level": jax["bootstrap"]["level"], "max_error": jax["max_error"],
                "seconds": jax["seconds"]},
        "port": {k: port[k] for k in ("level", "max_error", "seconds")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
