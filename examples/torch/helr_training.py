"""HELR (paper §VI-B) on the PyTorch/CUDA port: encrypted logistic-regression
training, executed for real.

    python examples/torch/helr_training.py                      # the card
    python examples/torch/helr_training.py --device cpu         # plain versions
    python examples/torch/helr_training.py --preset paper       # N = 2^16, L = 48

The program of ``examples/helr_training.py`` op for op, on ``repro_torch``:
data plaintext-encoded (batch in slots, one ciphertext per feature), weights
ENCRYPTED, and each iteration evaluates

    p = sigma(X·w),  grad = mean(X^T (p − y)),  w -= lr·grad

homomorphically: PMult for the X products, a degree-3 polynomial sigmoid
(Han et al. coefficients), rotate-and-sum reductions, one prime dropped by
every rescale.  Presets:

* ``example`` — the JAX example's own: N = 2¹¹, L = 14, K = 2, dnum = 7,
  4 features, batch 64, 1 iteration;
* ``paper`` — ``paper_full()``'s ring (N = 2¹⁶, L = 48, K = 12, dnum = 4)
  with the example's single-prime rescales, HELR1024's batch 1024 and 196
  features, 2 iterations (9 levels each, no bootstrap).

Each feature column is encoded once at the full basis and kept on the
device; a use at a lower level reads its first ℓ rows (``encode`` reduces one
integer vector modulo each prime, so these are the residues an encoding at
that level gives).  The example's weight encryptions are all the same
(the zero vector, ``encrypt``'s default randomness), so one is made and
copied.  :func:`run_helr` is the program; :func:`replay` is the
same update in float64 numpy on whole slot vectors.  On ``--device cuda``
without a GPU the script fails; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np
import torch

from repro_torch.core import ckks, encoding as enc, keys as K, params as prm
from repro_torch.core import poly as pl
from repro_torch.core.trace import trace_ops
from repro_torch.kernels import config

LR = 1.0
SIG = (0.5, 0.15012, -0.001593)      # Han et al. degree-3 sigmoid
PRESETS = {
    "example": {"params": lambda: prm.make_params(N=1 << 11, L=14, K=2, dnum=7),
                "features": 4, "batch": 64, "iters": 1},
    "paper": {"params": lambda: prm.make_params(N=1 << 16, L=48, K=12, dnum=4),
              "features": 196, "batch": 1024, "iters": 2},
}


def make_data(features: int, batch: int, seed: int = 0):
    """The example's synthetic separable data: (X, y)."""
    rng = np.random.default_rng(seed)
    true_w = rng.normal(size=features)
    X = rng.normal(size=(batch, features))
    y = (X @ true_w > 0).astype(np.float64)
    return X, y


def replay(X: np.ndarray, y: np.ndarray, iters: int, slots: int,
           lr: float = LR) -> np.ndarray:
    """The encrypted update in float64 on whole slot vectors (rotations as
    ``np.roll``): the weights' slot vectors, (features, slots).  Slot 0 is
    the model the decrypted weights are."""
    batch, features = X.shape
    Xs = np.zeros((features, slots))
    Xs[:, :batch] = X.T
    yc = np.zeros(slots)
    yc[:batch] = y - 0.5
    w = np.zeros((features, slots))
    for _ in range(iters):
        z = (w * Xs).sum(axis=0)
        err = SIG[1] * z + SIG[2] * z ** 3 - yc
        g = err[None, :] * Xs
        k = 1
        while k < batch:
            g = g + np.roll(g, -k, axis=1)
            k *= 2
        w = w - g * (lr / batch)
    return w


def accuracy(X: np.ndarray, y: np.ndarray, w: np.ndarray) -> float:
    return float(((X @ w > 0) == y.astype(bool)).mean())


@dataclasses.dataclass
class HelrRun:
    ct_w: list             # the final weight ciphertexts
    decoded: np.ndarray    # their slot 0, decrypted and decoded
    w_dec: np.ndarray      # its real part: the trained model
    acc: float             # training accuracy of w_dec
    trace: object          # OpTrace of the iterations
    launches: dict         # per-kernel launches of the iterations
    families: dict         # per-family launches of the iterations
    seconds: dict          # keygen, encoding, each iteration, decryption
    levels: list           # weight level after each iteration
    X: np.ndarray
    y: np.ndarray


def run_helr(params, features: int, batch: int, iters: int, seed: int = 0,
             device="cuda", engine: str = "fused") -> HelrRun:
    """Train on the example's data: keygen (rotations 1 << i, i < log₂
    batch), the weights encrypted at Δ = q[-1], then ``iters`` encrypted
    iterations under ``trace_ops()``, the launch counts reset just before
    them and read just after, each iteration ending in a device sync."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not available")
    p = params
    slots = p.slots

    def pad(v):                     # the batch in the first slots
        return np.concatenate([v, np.zeros(slots - batch)])
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    seconds = {}
    t0 = time.perf_counter()
    keys = K.keygen(p, rotations=tuple(1 << i for i in range(int(np.log2(batch)))),
                    seed=seed, device=device)
    sync()
    seconds["keygen_s"] = time.perf_counter() - t0
    scale = float(p.q[-1])
    X, y = make_data(features, batch, seed)

    t0 = time.perf_counter()
    # The example encrypts the zero vector once per feature with encrypt's
    # default randomness, default_rng(42): every call gives the same bytes,
    # so one encryption is made and copied.
    ct0 = K.encrypt(enc.encode(np.zeros(slots), scale, p.q, p.N), scale,
                    keys.sk, p.q, p.N, device=device)
    ct_w = [ckks.Ciphertext(*(pl.RnsPoly(h.data.clone(), h.basis, h.domain)
                              for h in (ct0.a, ct0.b)), ct0.scale)
            for _ in range(features)]
    # each feature column encoded once at the full basis, on the device
    Xenc = [pl.to_tensor(enc.encode(pad(X[:, j]), scale, p.q, p.N), device)
            for j in range(features)]
    yv = pad(y - 0.5)               # centered labels
    sync()
    seconds["encode_encrypt_s"] = time.perf_counter() - t0

    def column(j, basis):
        return pl.RnsPoly(Xenc[j][:len(basis)], basis, pl.COEFF)

    def encode_vec(v, s, basis):
        return pl.RnsPoly(pl.to_tensor(enc.encode(v, s, basis, p.N), device),
                          basis, pl.COEFF)

    def align(cts):
        ell = min(c.level for c in cts)
        s0 = min(c.scale for c in cts)
        out = []
        for c in cts:
            c = ckks.level_drop(c, ell)
            if abs(c.scale - s0) / s0 > 1e-9:
                c = ckks.match_scale(c, s0, p)
            out.append(c)
        ell = min(c.level for c in out)
        return [ckks.level_drop(c, ell) for c in out]

    def rotate_sum(ct, n):
        """Σ over the first n slots, broadcast into slot 0..n (log rotations)."""
        k = 1
        while k < n:
            ct = ckks.hadd(ct, ckks.hrot(ct, k, keys))
            k *= 2
        return ct

    levels = []
    config.reset_launches()
    with ckks.use_engine(engine), trace_ops() as tr:
        for it in range(iters):
            t0 = time.perf_counter()
            # z = Σ_j x_j ⊙ w_j
            terms = [ckks.pmult(ct_w[j], column(j, ct_w[j].basis), scale)
                     for j in range(features)]
            z = terms[0]
            for t in terms[1:]:
                z = ckks.hadd(z, t)
            del terms
            z = ckks.rescale(z, p, times=1)
            # sigma(z) − y − 0.5 → centered error: 0.15012 z − 0.001593 z³ − yc
            z2 = ckks.rescale(ckks.square(z, keys), p, times=1)
            z3 = ckks.rescale(ckks.hmult(*align([z2, z]), keys), p, times=1)
            t1 = ckks.mul_const(ckks.level_drop(z, z3.level), SIG[1], p)
            t3 = ckks.mul_const(z3, SIG[2], p)
            err_ct = ckks.add_matched(t1, t3, p)
            err_ct = ckks.padd(err_ct, encode_vec(-yv, err_ct.scale, err_ct.basis))
            # grad_j = mean(x_j ⊙ err); w_j -= lr grad_j
            for j in range(features):
                g = ckks.pmult(err_ct, column(j, err_ct.basis), scale)
                g = ckks.rescale(g, p, times=1)
                g = rotate_sum(g, batch)
                g = ckks.mul_const(g, LR / batch, p)
                neg = ckks.Ciphertext(-g.a, -g.b, g.scale)
                ct_w[j] = ckks.add_matched(ckks.level_drop(ct_w[j], neg.level),
                                           neg, p)
            sync()
            seconds[f"iter{it}_s"] = time.perf_counter() - t0
            levels.append(min(c.level for c in ct_w))
    launches, families = config.kernel_launch_counts(), config.launch_counts()

    t0 = time.perf_counter()
    decoded = np.array([
        enc.decode(K.decrypt(c, keys.sk), c.scale, c.basis, p.N, 1)[0]
        for c in ct_w])
    w_dec = decoded.real
    seconds["decrypt_s"] = time.perf_counter() - t0
    return HelrRun(ct_w=ct_w, decoded=decoded, w_dec=w_dec,
                   acc=accuracy(X, y, w_dec), trace=tr, launches=launches,
                   families=families, seconds=seconds, levels=levels, X=X, y=y)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--preset", default="example", choices=tuple(PRESETS))
    args = ap.parse_args(argv)
    cfg = PRESETS[args.preset]
    p = cfg["params"]()
    run = run_helr(p, cfg["features"], cfg["batch"], cfg["iters"],
                   device=args.device)
    for it, lvl in enumerate(run.levels):
        print(f"iter {it}: weight level {lvl}")
    print(f"decrypted weights: {np.round(run.w_dec[:8], 4)}"
          + (" ..." if len(run.w_dec) > 8 else ""))
    print(f"training accuracy after {cfg['iters']} encrypted iterations: "
          f"{run.acc:.2%}")
    print(f"HE ops executed: {dict(run.trace.he_ops)}")
    print("seconds: " + ", ".join(f"{k}={v:.3f}" for k, v in run.seconds.items()))
    assert run.acc >= 0.8, "encrypted training should separate the toy data"
    print("HELR example OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
