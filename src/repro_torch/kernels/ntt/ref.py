"""Independent numpy-int64 oracle for the NTT kernel.

Products of two <2³⁰ residues fit int64 exactly, so this oracle shares *no*
code with the datapath under test (schoolbook iterative CT/GS with plain
``% q``).  Natural-order in/out, same convention as ``repro_torch.core.ntt``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import rns


def ntt_ref(x: np.ndarray, basis: tuple[int, ...]) -> np.ndarray:
    """x: (P, ℓ, N) u32 → forward negacyclic NTT, natural order."""
    P, ell, N = x.shape
    out = np.empty_like(x)
    brev = rns.bitrev_indices(N)
    for i, q in enumerate(basis):
        psi = rns.find_psi(q, N)
        tab = np.array([pow(psi, int(b), q) for b in brev], dtype=np.int64)
        for p in range(P):
            a = x[p, i].astype(np.int64)
            m, t = 1, N
            while m < N:
                t //= 2
                a = a.reshape(m, 2, t)
                w = tab[m:2 * m][:, None]
                bw = (a[:, 1, :] * w) % q
                a = np.stack([(a[:, 0, :] + bw) % q,
                              (a[:, 0, :] - bw) % q], axis=1).reshape(N)
                m *= 2
            out[p, i] = a[brev].astype(np.uint32)
    return out


def intt_ref(x: np.ndarray, basis: tuple[int, ...]) -> np.ndarray:
    """Inverse of :func:`ntt_ref` (GS, includes N⁻¹ scaling)."""
    P, ell, N = x.shape
    out = np.empty_like(x)
    brev = rns.bitrev_indices(N)
    for i, q in enumerate(basis):
        psi = rns.find_psi(q, N)
        psi_inv = pow(psi, q - 2, q)
        tab = np.array([pow(psi_inv, int(b), q) for b in brev], dtype=np.int64)
        n_inv = pow(N, q - 2, q)
        for p in range(P):
            a = x[p, i].astype(np.int64)[brev]
            t, m = 1, N
            while m > 1:
                h = m // 2
                a = a.reshape(h, 2, t)
                w = tab[h:2 * h][:, None]
                u = (a[:, 0, :] + a[:, 1, :]) % q
                v = ((a[:, 0, :] - a[:, 1, :]) * w) % q
                a = np.stack([u, v], axis=1).reshape(N)
                t *= 2
                m = h
            out[p, i] = (a * n_inv % q).astype(np.uint32)
    return out
