"""Run the dry-run sweep: every (arch × shape × mesh) cell, one subprocess
per cell (a fresh fake world each time), incremental — existing JSONs are
skipped (the port of ``repro.launch.dryrun_all``).  Usage:

    python -m repro_torch.launch.dryrun_all [--out experiments/dryrun] \\
        [--mesh pod|multipod|both] [--archs a,b] [--shapes s,t] [--force]

``--archs`` / ``--shapes`` keep a subset of the sweep, in the sweep's order.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.launch.dryrun import record_path

# cheapest archs first for early signal
ORDER = ["qwen3_4b", "xlstm_1_3b", "seamless_m4t_medium", "deepseek_moe_16b",
         "glm4_9b", "qwen3_8b", "mixtral_8x7b", "internlm2_20b",
         "zamba2_7b", "llava_next_34b"]
SHAPE_ORDER = ["train_4k", "decode_32k", "prefill_32k", "long_500k"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod", "both"])
    ap.add_argument("--timeout", type=int, default=1200)
    ap.add_argument("--archs", default="")
    ap.add_argument("--shapes", default="")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    archs = [a for a in ORDER if not args.archs or a in args.archs.split(",")]
    shapes = [s for s in SHAPE_ORDER if not args.shapes or s in args.shapes.split(",")]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(root, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")

    results = []
    for mesh in meshes:
        for arch in archs:
            for shape in shapes:
                path = record_path(args.out, {"arch": arch, "shape": shape,
                                              "mesh": mesh, "opts": []})
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        rec = json.load(f)
                    if rec.get("ok") or not rec.get("applicable", True):
                        continue
                t0 = time.time()
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh,
                       "--out", args.out]
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True,
                                          timeout=args.timeout, env=env, cwd=root)
                    line = (proc.stdout.strip().splitlines() or ["?"])[0]
                except subprocess.TimeoutExpired:
                    line = f"TIMEOUT {arch} {shape} {mesh}"
                print(f"[{time.strftime('%H:%M:%S')}] {line} "
                      f"({time.time()-t0:.0f}s)", flush=True)
                results.append(line)
    n_ok = sum(1 for r in results if r.startswith("OK"))
    n_skip = sum(1 for r in results if r.startswith("SKIP"))
    print(f"\nsweep done: {n_ok} ok, {n_skip} skip, "
          f"{len(results)-n_ok-n_skip} fail")


if __name__ == "__main__":
    main()
