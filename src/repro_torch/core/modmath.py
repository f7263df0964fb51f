"""Modular arithmetic for RNS-CKKS on torch tensors (paper §III-C datapath).

The reference builds every helper from u32 element-wise ops (16-bit limbs)
because a TPU has no 64-bit integer ALU.  PyTorch has ``int64`` on every
device, and torch's ``uint32`` lacks ``add``/``sub``/``>>``/``>=`` on the CPU,
so the port stores residues as ``int32`` and computes in ``int64``:

  * every prime is in [2²⁹, 2³⁰) (:mod:`repro_torch.core.rns`), so canonical
    residues and lazy [0, 2q) values are non-negative int32;
  * a product of two residues is < 2⁶⁰ and exact in int64;
  * a Shoup ``mulhi`` of x < 2³¹ by a companion < 2³² is < 2⁶³, still exact.

Functions accept int32 or int64 tensors (and int64 constant tensors that
broadcast against them) and return int64; callers narrow to int32 where a
result is stored.  Every function returns the same value as its counterpart in
the reference ``modmath``: the canonical ones are the unique residue in
[0, q), and the lazy ones repeat the reference's own formula.
"""
from __future__ import annotations

import torch

I64 = torch.int64


def _w(x):
    return x.to(I64)


def addmod(a, b, q):
    """(a + b) mod q for a, b in [0, q)."""
    s = _w(a) + _w(b)
    return torch.where(s >= q, s - q, s)


def submod(a, b, q):
    """(a - b) mod q for a, b in [0, q)."""
    d = _w(a) - _w(b)
    return torch.where(d < 0, d + q, d)


def negmod(a, q):
    """(-a) mod q for a in [0, q)."""
    a = _w(a)
    return torch.where(a == 0, a, q - a)


# ----------------------------------------------------------------------------
# Lazy [0, 2q) arithmetic — Harvey-style NTT butterflies (one select each).
# ----------------------------------------------------------------------------

def addmod_lazy(a, b, two_q):
    """(a + b) with one conditional subtract of 2q; [0, 2q) in and out."""
    s = _w(a) + _w(b)
    return torch.where(s >= two_q, s - two_q, s)


def submod_lazy(a, b, two_q):
    """(a - b) + 2q with one conditional subtract of 2q; [0, 2q) in and out."""
    d = _w(a) + (two_q - _w(b))
    return torch.where(d >= two_q, d - two_q, d)


def mulmod_shoup_lazy(x, w, w_shoup, q):
    """x·w mod q in the lazy range [0, 2q), with w_shoup = ⌊w·2³²/q⌋.

    hi = ⌊x·w_shoup / 2³²⌋ is exact in int64 for x < 2³¹, and the result
    x·w − hi·q equals the reference's wrapping u32 formula because it already
    lies in [0, 2q).
    """
    x = _w(x)
    hi = (x * w_shoup) >> 32
    return x * w - hi * q


def reduce_once(x, q):
    """Final correction [0, 2q) → [0, q): one conditional subtract."""
    x = _w(x)
    return torch.where(x >= q, x - q, x)


def mulmod_shoup(x, w, w_shoup, q):
    """x·w mod q, fully reduced (Shoup, any x < 2³¹)."""
    return reduce_once(mulmod_shoup_lazy(x, w, w_shoup, q), q)


def mulmod(a, b, q):
    """General a·b mod q for a, b in [0, q): the product is < 2⁶⁰.

    The reference reaches the same residue through double Montgomery REDC
    (its ``qinv_neg``/``r2`` constants); here one exact int64 ``%`` does.
    """
    return (_w(a) * _w(b)) % q
