"""Quickstart on the PyTorch/CUDA port: encrypted arithmetic with the CKKS core.

    python examples/torch/quickstart.py                 # the card
    python examples/torch/quickstart.py --device cpu    # plain versions

``examples/quickstart.py`` on ``repro_torch``: encrypts two vectors at
``test_small`` (N = 2¹⁰, L = 6, hybrid key-switching with dnum = 3), runs
HAdd / HMult (+relinearize+rescale) / HRot through the 32-bit RNS-CKKS
pipeline (paper §II-B, §III-C) and checks the decrypted results against
plaintext math.  On ``--device cuda`` without a GPU it fails.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.core import ckks, encoding as enc, keys as K, params as prm
from repro_torch.core.trace import trace_ops

BOUND = 1e-2


def run_quickstart(device="cuda", engine: str = "fused", verbose: bool = False):
    """Returns ([(label, ciphertext, decoded slots, error)], OpTrace of the
    whole run); asserts every error < 1e-2."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not available")
    p = prm.test_small()
    if verbose:
        print(f"CKKS params: N={p.N}, L={p.L}, K={p.K}, dnum={p.dnum} "
              f"(32-bit primes, paper §III-C)")
    checked = []
    with ckks.use_engine(engine), trace_ops() as tr:
        keys = K.keygen(p, rotations=(1, 4), seed=0, device=device)
        scale = float(p.q[-1])
        rng = np.random.default_rng(0)
        z1 = rng.normal(size=8) + 1j * rng.normal(size=8)
        z2 = rng.normal(size=8) + 1j * rng.normal(size=8)
        ct1 = K.encrypt(enc.encode(z1, scale, p.q, p.N), scale, keys.sk, p.q, p.N,
                        device=device)
        ct2 = K.encrypt(enc.encode(z2, scale, p.q, p.N), scale, keys.sk, p.q, p.N,
                        device=device)

        def show(label, ct, want, n=8):
            got = enc.decode(K.decrypt(ct, keys.sk), ct.scale, ct.basis, p.N, n)
            err = float(np.max(np.abs(got - want)))
            if verbose:
                print(f"{label:18s} err={err:.2e}  level={ct.level}")
            assert err < BOUND, (label, err)
            checked.append((label, ct, got, err))

        show("enc/dec", ct1, z1)
        show("HAdd", ckks.hadd(ct1, ct2), z1 + z2)
        show("HMult+relin+RS", ckks.rescale(ckks.hmult(ct1, ct2, keys), p, times=1),
             z1 * z2)
        show("HRot(4)", ckks.hrot(ct1, 4, keys),
             np.roll(np.concatenate([z1, np.zeros(p.slots - 8)]), -4)[:8])
    return checked, tr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run_quickstart(args.device, verbose=True)
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
