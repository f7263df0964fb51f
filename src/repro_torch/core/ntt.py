"""Negacyclic NTT — the fused iterative Cooley-Tukey / Gentleman-Sande transform.

The plain torch counterpart of the reference's ``core/ntt.ntt``/``intt``
(Longa-Naehrig fused CT forward, GS inverse, Shoup multipliers, lazy [0, 2q)
butterflies, natural-order in and out):

    ntt(a)[k] = Σₙ a[n]·ψ^{(2k+1)n} mod q  —  evaluation at the odd root ψ^{2k+1}.

This is plain tensor code outside any kernel, as in the reference, whose
CKKS path also runs its jnp transform rather than the Pallas NTT.  The
bit-reversal between the stages and natural order is one ``index_select`` on
the staged ``brev`` table: the reference's reshape into log₂N axes of extent 2
would need ~19 dims at N = 2¹⁶ with leading batch dims.

Shapes: ``x`` is ``(..., ℓ, N)`` int32/int64 with one modulus per limb row;
the limb tables are the stacked ``(ℓ, N)`` int64 tensors of :class:`NttConsts`,
staged per (basis, N, device) by :mod:`repro_torch.core.const_cache`.
Outputs are int32 in [0, q).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import modmath as mm
from . import rns


class NttConsts(NamedTuple):
    """Stacked per-limb NTT constants for a prime basis.

    Host form (:func:`stacked_ntt_consts`): numpy u32 tables, field for field
    equal to the reference's.  Device form (``const_cache``): int64 tensors.
    """
    q: object                  # (ℓ, 1)
    psi_rev: object            # (ℓ, N) — fused CT forward table
    psi_rev_shoup: object      # (ℓ, N)
    psi_inv_rev: object        # (ℓ, N) — fused GS inverse table
    psi_inv_rev_shoup: object  # (ℓ, N)
    n_inv: object              # (ℓ, 1)
    n_inv_shoup: object        # (ℓ, 1)
    brev: object               # (N,) — bit-reversal permutation


@functools.lru_cache(maxsize=None)
def stacked_ntt_consts(basis: tuple[int, ...], N: int) -> NttConsts:
    tabs = [rns.prime_tables(q, N) for q in basis]
    stack = lambda f: np.stack([f(t) for t in tabs])
    col = lambda f: np.array([[f(t)] for t in tabs], dtype=np.uint32)
    return NttConsts(
        q=col(lambda t: t.q),
        psi_rev=stack(lambda t: t.psi_rev),
        psi_rev_shoup=stack(lambda t: t.psi_rev_shoup),
        psi_inv_rev=stack(lambda t: t.psi_inv_rev),
        psi_inv_rev_shoup=stack(lambda t: t.psi_inv_rev_shoup),
        n_inv=col(lambda t: t.n_inv),
        n_inv_shoup=col(lambda t: t.n_inv_shoup),
        brev=rns.bitrev_indices(N).astype(np.int64),
    )


def ntt(x: torch.Tensor, c: NttConsts) -> torch.Tensor:
    """Forward negacyclic NTT over the last axis; natural-order in/out.

    Accepts values < 2q; output int32, fully reduced.
    """
    N = x.shape[-1]
    lead = x.shape[:-1]
    q = c.q[..., None]          # (ℓ, 1, 1) against (..., ℓ, m, t)
    two_q = q + q
    x = x.to(torch.int64)
    m, t = 1, N
    while m < N:
        t //= 2
        y = x.reshape(*lead, m, 2, t)
        a, b = y[..., 0, :], y[..., 1, :]
        w = c.psi_rev[:, m:2 * m, None]
        ws = c.psi_rev_shoup[:, m:2 * m, None]
        bw = mm.mulmod_shoup_lazy(b, w, ws, q)
        x = torch.stack([mm.addmod_lazy(a, bw, two_q),
                         mm.submod_lazy(a, bw, two_q)], dim=-2)
        x = x.reshape(*lead, N)
        m *= 2
    x = x.index_select(-1, c.brev)          # bit-reversed → natural
    return mm.reduce_once(x, c.q).to(torch.int32)


def intt(x: torch.Tensor, c: NttConsts) -> torch.Tensor:
    """Inverse negacyclic NTT over the last axis; natural-order in/out.

    Accepts values < 2q; output int32 in [0, q) by the final n⁻¹ Shoup
    multiply.
    """
    N = x.shape[-1]
    lead = x.shape[:-1]
    q = c.q[..., None]
    two_q = q + q
    x = x.to(torch.int64).index_select(-1, c.brev)   # natural → bit-reversed
    t, m = 1, N
    while m > 1:
        h = m // 2
        y = x.reshape(*lead, h, 2, t)
        a, b = y[..., 0, :], y[..., 1, :]
        w = c.psi_inv_rev[:, h:2 * h, None]
        ws = c.psi_inv_rev_shoup[:, h:2 * h, None]
        u = mm.addmod_lazy(a, b, two_q)
        v = mm.mulmod_shoup_lazy(mm.submod_lazy(a, b, two_q), w, ws, q)
        x = torch.stack([u, v], dim=-2).reshape(*lead, N)
        t *= 2
        m = h
    return mm.mulmod_shoup(x, c.n_inv, c.n_inv_shoup, c.q).to(torch.int32)
