"""Readings that the limits of ``correct`` are set from, on the card.

    python fhebench/limits.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 4

Runs the cell once per seed in one process (short windows at the cell's
own load) and prints one JSON line per seed with the numbers compared;
then the control once per control seed: the program's own
lower-precision path, single-prime rescale (Δ one 32-bit prime, one prime
dropped per rescale) where the configuration states double-prime, which
has to come out as not correct.  The benchmark's own runs never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def control_config(config: dict) -> dict:
    """The configuration with single-prime rescale."""
    return dict(config, rescale_primes=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    from fhebench import harness
    bench, cell, config, traffic = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("fhebench: no CUDA card", file=sys.stderr)
        return 3
    harness.host_threads(config, torch)
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    worst = {}
    for seed, control in runs:
        t0 = time.perf_counter()
        line = {"workload": args.workload, "control": control, "seed": seed}
        try:
            result, checks = harness.run(
                cell, control_config(config) if control else config, traffic,
                bench["end_to_end"], seed=seed, seconds=args.seconds,
                trace=False, device="cuda:0", t_proc0=t0)
        except Exception as e:          # a control that crashes has failed
            line.update(correct=False, error=repr(e)[:400])
            print(json.dumps(line), flush=True)
            continue
        finally:
            torch.cuda.empty_cache()
        line.update(correct=result["correct"],
                    checks={k: v["value"] for k, v in checks.items()},
                    metrics={k: v["value"] for k, v in result["metrics"].items()},
                    memory_peak_bytes=result["device"]["memory_peak_bytes"])
        print(json.dumps(line), flush=True)
        key = "control" if control else "program"
        for k, v in line["checks"].items():
            w = worst.setdefault(key, {})
            w[k] = max(w.get(k, v), v) if key == "program" else min(w.get(k, v), v)
    print(json.dumps({"workload": args.workload, "worst_program_min_control": worst,
                      "seconds_total": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
