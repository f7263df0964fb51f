"""Paper §IV/§V live on the PyTorch/CUDA port: cluster-mapped NTT + BConv on
8 logical chiplets.

    python examples/torch/distributed_mapping_demo.py                 # the card
    python examples/torch/distributed_mapping_demo.py --device cpu    # plain versions

``examples/distributed_mapping_demo.py`` on ``repro_torch``: the mesh is 8
logical shards on one device (``repro_torch.core.distributed.Mesh``, the
square map 4x2-BK-1x2), run in this process by
``repro_torch.core._dist_selftest``.  It runs the block-clustered distributed
NTT (both dataflows) and BConv (ARK redistribution and limb duplication),
checks them against the single-device results, and prints the bytes each
program's collectives moved between distinct blocks, summed over the 8
blocks.  The JAX demo prints per-device wire bytes of the compiled HLO
instead, which count other things (the README's distributed section has the
table).  On ``--device cuda`` without a GPU it fails.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch

from repro_torch.core import _dist_selftest as selftest

SHARDS = 8
MODUP = (12, 48, 2048)        # ℓ = 12 → K = 48 at N = 2048 (paper §V-A Fig. 4)


def run_distributed_demo(device="cuda", verbose: bool = False) -> dict:
    """Returns {"correctness": …, "traffic": …} (``_dist_selftest``'s
    records); asserts the demo's claims."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not available")
    if verbose:
        print(f"verifying distributed correctness on {SHARDS} logical chiplets...")
    out = selftest.run_correctness(SHARDS, device=device)
    assert out["ok"]
    if verbose:
        print(f"  OK map={out['map']} (bit-exact vs single-device results)")
        print("measuring bytes between distinct blocks (ModUp: ell=12 → K=48, "
              "N=2048)...")
    t = selftest.run_traffic(SHARDS, *MODUP, device=device)
    ark = t["bconv_ark"]["total"]
    dup = t["bconv_limbdup"]["total"]
    ntt2 = t["ntt_baseline"]["total"]
    ntt1 = t["ntt_fourstep"]["total"]
    gather_only = set(t["bconv_limbdup"]) == {"all_gather", "total"}
    if verbose:
        print(f"  BConv  ARK redistribution : {ark/1024:8.1f} KiB between distinct blocks")
        print(f"  BConv  limb duplication   : {dup/1024:8.1f} KiB "
              f"({100*(1-dup/ark):.0f}% less, gather-only: {gather_only})")
        print(f"  NTT    2-exchange baseline: {ntt2/1024:8.1f} KiB")
        print(f"  NTT    single mid-shuffle : {ntt1/1024:8.1f} KiB "
              f"({100*(1-ntt1/ntt2):.0f}% less — paper Fig. 1 dataflow)")
        print(f"  Eq. 3 beneficial here: {t['eq3_beneficial']}")
    assert dup < ark and gather_only, t
    assert 2 * ntt1 == ntt2, t
    assert t["eq3_beneficial"], t
    return {"correctness": out, "traffic": t}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run_distributed_demo(args.device, verbose=True)
    print("distributed mapping demo OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
