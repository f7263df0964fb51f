"""Independent numpy-int64 oracle for BConv (exact schoolbook mod-matmul)."""
from __future__ import annotations

import numpy as np

from repro_torch.core import rns


def bconv_ref(x: np.ndarray, src: tuple[int, ...], dst: tuple[int, ...]) -> np.ndarray:
    """Full HPS BConv: (…, ℓ, N) residues in ``src`` → (…, K, N) in ``dst``.

    Leading dims are looped host-side so the oracle stays a plain schoolbook
    sum — it doubles as the reference for the kernel's batched grid.
    """
    if x.ndim > 2:
        return np.stack([bconv_ref(xi, src, dst) for xi in x])
    tab = rns.bconv_tables(tuple(src), tuple(dst))
    ell, N = x.shape
    t = np.empty((ell, N), dtype=np.int64)
    for i, q in enumerate(src):
        t[i] = x[i].astype(np.int64) * int(tab.qhat_inv[i]) % q
    out = np.empty((len(dst), N), dtype=np.uint32)
    for j, p in enumerate(dst):
        acc = np.zeros(N, dtype=np.int64)
        for i in range(ell):
            acc = (acc + t[i] * int(tab.table[j, i])) % p
        out[j] = acc.astype(np.uint32)
    return out


def bconv_matmul_ref(t: np.ndarray, table: np.ndarray,
                     dst: tuple[int, ...]) -> np.ndarray:
    """Just the table matmul on pre-scaled limbs (what the kernel computes)."""
    ell, N = t.shape
    out = np.empty((len(dst), N), dtype=np.uint32)
    for j, p in enumerate(dst):
        acc = np.zeros(N, dtype=np.int64)
        for i in range(ell):
            acc = (acc + t[i].astype(np.int64) * int(table[j, i])) % p
        out[j] = acc.astype(np.uint32)
    return out
