"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python fhebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, and with ``--trace 1``
a ``breakdown``; the numbers that decided ``correct`` come last, under
``checks``, and as the last lines of standard error.  Without a CUDA card,
or with fewer than the cell asks for, it prints no result and exits 3; if
any module of JAX or of the JAX package is loaded once the window has
closed, it names them and exits 4.
"""
import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from fhebench import harness
    bench, cell, config, traffic = harness.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"fhebench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    harness.host_threads(config, torch)
    metrics = bench["per_layer"] if args.trace else bench["end_to_end"]
    result, checks = harness.run(cell, config, traffic, metrics, seed=args.seed,
                                 seconds=args.seconds, trace=bool(args.trace),
                                 device="cuda:0", t_proc0=T_PROC0)
    found = harness.forbidden_modules()
    if found:
        print(f"fhebench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 4
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
