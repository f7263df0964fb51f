"""Bootstrapping demo (paper §VI-B "Boot") on the PyTorch/CUDA port: refresh
an exhausted ciphertext.

    python examples/torch/bootstrapping_demo.py                 # the card
    python examples/torch/bootstrapping_demo.py --device cpu    # plain versions

``examples/bootstrapping_demo.py`` on ``repro_torch``: the full ModRaise →
CoeffToSlot → EvalMod → SlotToCoeff pipeline at N = 2⁹, L = 14, K = 2,
dnum = 7 with minimum key-switching (§V-B), the primitive-op trace (the
format the CiFHER cost model consumes), and the precision check (error
< 5e-3).  On ``--device cuda`` without a GPU it fails.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.core import bootstrap as B, encoding as enc, keys as K
from repro_torch.core import params as prm
from repro_torch.core.trace import trace_ops

BOUND = 5e-3


def run_bootstrap_demo(device="cuda", verbose: bool = False):
    """Returns (output ciphertext, its decoded slots, max error, OpTrace of
    the bootstrap, seconds); asserts the error < 5e-3."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not available")
    p = prm.make_params(N=1 << 9, L=14, K=2, dnum=7)
    if verbose:
        print(f"params: N={p.N}, L={p.L}, slots={p.slots}")
    t0 = time.time()
    ctx = B.setup_bootstrap(p, hamming=8, K_range=4, cheb_deg=47, use_min_ks=True,
                            device=device)
    setup_s = time.time() - t0
    if verbose:
        print(f"setup (keys + matrices): {setup_s:.1f}s, "
              f"{len(ctx.keys.galois)} galois keys (min-KS)")
    rng = np.random.default_rng(1)
    z = rng.normal(size=p.slots) * 0.05
    scale = float(p.q[0])
    ct = K.encrypt(enc.encode(z, scale, p.q[:1], p.N), scale, ctx.keys.sk,
                   p.q[:1], p.N, device=device)
    if verbose:
        print(f"input ciphertext: level {ct.level} (exhausted)")
    t0 = time.time()
    with trace_ops() as tr:
        out = B.bootstrap(ct, ctx)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    got = enc.decode(K.decrypt(out, ctx.keys.sk), out.scale, out.basis, p.N,
                     p.slots)
    err = float(np.max(np.abs(got - z)))
    if verbose:
        print(f"bootstrap: {dt:.1f}s → level {out.level}, max err {err:.2e}")
        s = tr.summary()
        print(f"trace: {s['he_ops'].get('KS', 0)} key-switches, "
              f"{s['limb_ntts']:.0f} limb-NTTs, "
              f"{s['bconv_macs']/1e6:.1f}M BConv MACs, "
              f"{s['evk_bytes']/2**20:.0f} MiB evk traffic")
    assert err < BOUND, err
    return out, got, err, tr, {"setup_s": setup_s, "bootstrap_s": dt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run_bootstrap_demo(args.device, verbose=True)
    print("bootstrapping demo OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
