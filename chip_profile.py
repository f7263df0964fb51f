#!/usr/bin/env python3
"""Where the device time of the port's paper_full pipeline goes, on one GPU.

    python3 chip_profile.py [--trace-dir DIR]

Runs keygen/encrypt and one warm-up pass of hmult → rescale →
hrot_hoisted([1, 4]) at ``paper_full`` (N = 2¹⁶, L = 48, K = 12, dnum = 4),
and of the eager engine's hoisted pair, then profiles one more pass of each
op under ``torch.profiler`` and prints one JSON line per op:

* ``wall_ms`` — median host-clock time of three unprofiled runs of the op,
  each ending in a device sync (``profiled_wall_ms``: the profiled run);
* ``busy_ms`` — union of the profiled run's kernel intervals on the device,
  and ``idle_share`` = 1 − busy / wall_ms (how far the host holds the card
  back);
* ``by_group`` — device ms of the port's CUDA kernels (EFU, BConvU, the NTT
  forward and inverse, AutoU∘KS, the single and multi-permutation) and of the
  plain torch kernels around them (ring ops, stacking, limb reorders), and
  the top torch kernels by name;
* ``remainder_kernels`` — how many of the op's kernels are torch's integer
  ``%`` (the plain ``mulmod``s, and before BConvU took in its q̂⁻¹
  pre-scale, one per BConv launch).

The Chrome traces go to ``--trace-dir`` (default ``build/profile``).
Fails without CUDA.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PORT_KERNELS = {"efu_kernel": "efu", "bconv_kernel": "bconvu",
                "ntt_fwd_kernel": "ntt_fwd", "ntt_inv_kernel": "ntt_inv",
                "auto_ks_kernel": "auto_ks",
                "perm_cluster_kernel": "perm_cluster (automorphism_multi / _eager)",
                "perm_rows_kernel": "automorphism"}


def kernel_events(trace_path: Path) -> list[dict]:
    events = json.loads(trace_path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel" and "dur" in e]


def summarize(kernels: list[dict], wall_ms: float, profiled_wall_ms: float) -> dict:
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:                      # union of intervals (µs)
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    by_group: dict[str, float] = defaultdict(float)
    by_name: dict[str, float] = defaultdict(float)
    for e in kernels:
        port = next((g for k, g in PORT_KERNELS.items() if k in e["name"]), None)
        by_group[port or "torch (plain ops: ring ops, stacking, reorders)"] += e["dur"] / 1e3
        if port is None:
            by_name[e["name"][:90]] += e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "profiled_wall_ms": profiled_wall_ms,
            "busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e3 / wall_ms, "kernels": len(kernels),
            "remainder_kernels": sum("remainder" in e["name"] for e in kernels),
            "by_group_ms": dict(by_group), "top_torch_kernels_ms": dict(top)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=str(ROOT / "build" / "profile"))
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import SEED, _messages, phase_device
    phase_device()                       # fails without CUDA; prints the card
    from repro_torch.core import ckks, encoding as enc, keys as K, params as prm

    params = prm.paper_full()
    keys = K.keygen(params, rotations=(1, 4), seed=SEED, device="cuda")
    scale = params.scale()
    cts = [K.encrypt(enc.encode(z, scale, params.q, params.N), scale, keys.sk,
                     params.q, params.N, rng=np.random.default_rng(i + 1),
                     device="cuda")
           for i, z in enumerate((_messages(16, 1), _messages(16, 2)))]
    def eager_pair():
        with ckks.use_engine("eager"):
            return ckks.hrot_hoisted(r, [1, 4], keys)

    m = ckks.hmult(*cts, keys)
    r = ckks.rescale(m, params)
    ckks.hrot_hoisted(r, [1, 4], keys)                    # warm-up pass
    eager_pair()
    torch.cuda.synchronize()
    ops = {"hmult": lambda: ckks.hmult(*cts, keys),
           "rescale": lambda: ckks.rescale(m, params),
           "hoisted_rotations": lambda: ckks.hrot_hoisted(r, [1, 4], keys),
           "eager_hoisted_rotations": eager_pair}
    trace_dir = Path(args.trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)

    def timed(op) -> float:
        t0 = time.perf_counter()
        op()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for name, op in ops.items():
        wall_ms = statistics.median(timed(op) for _ in range(3))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_ms = timed(op)
        path = trace_dir / f"{name}.json"
        prof.export_chrome_trace(str(path))
        print(json.dumps({"op": name, "params": "paper_full",
                          **summarize(kernel_events(path), wall_ms, profiled_ms)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
