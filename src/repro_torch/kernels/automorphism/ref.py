"""numpy int64 oracles for the automorphism and fused AutoU∘KS kernels."""
from __future__ import annotations

import numpy as np


def automorphism_ref(x: np.ndarray, perm: np.ndarray) -> np.ndarray:
    return x[..., perm]


def auto_ks_ref(exts: np.ndarray, evk_a: np.ndarray, evk_b: np.ndarray,
                perms: np.ndarray, basis: tuple[int, ...]) -> np.ndarray:
    """Exact int64 oracle of :func:`...kernel.auto_ks_pallas`.

    exts (J, G, L, N) with G ∈ {1, R}; evk_* (R, J, L, N); perms (R, N);
    basis the L extended-basis primes → out (R, 2, L, N).
    """
    J, G, L, N = exts.shape
    R = perms.shape[0]
    q = np.array(basis, dtype=np.int64).reshape(L, 1)
    out = np.zeros((R, 2, L, N), dtype=np.uint32)
    for r in range(R):
        e = exts[:, r if G == R else 0].astype(np.int64)[..., perms[r]]
        acc_a = (e * evk_a[r].astype(np.int64) % q).sum(axis=0) % q
        acc_b = (e * evk_b[r].astype(np.int64) % q).sum(axis=0) % q
        out[r, 0] = acc_a.astype(np.uint32)
        out[r, 1] = acc_b.astype(np.uint32)
    return out
