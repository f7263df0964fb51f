"""Shared tiny configuration for the benchmark's CPU tests."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_config(rescale_primes: int = 2) -> dict:
    """A ring small enough for a CPU test, with every mechanism of the
    cells: hybrid key-switching over 3 digits, double-prime rescale."""
    from repro_torch.core import params as prm
    p = prm.make_params(N=1 << 10, L=6, K=2, dnum=3, rescale_primes=rescale_primes)
    full = json.loads((ROOT / "fhebench" / "configs" / "ckks-paper-full.json")
                      .read_text())
    return {"N": p.N, "L": p.L, "K": p.K, "dnum": p.dnum,
            "rescale_primes": rescale_primes, "q": list(p.q), "p": list(p.p),
            "ell_in": p.L, "deployment": full["deployment"]}
