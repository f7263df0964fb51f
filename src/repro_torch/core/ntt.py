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
staged per (basis, N, device) by :mod:`repro_torch.core.const_cache` (tables
with more leading dims broadcast against ``x``'s).  Outputs are int32 in
[0, q).

The paper's recomposable four-step form (§III-B) is here too,
:func:`four_step_ntt` / :func:`four_step_intt`: a length-N polynomial viewed as
an R×C matrix, an R-point negacyclic column NTT (root ψ^C), the inter-step
twiddle ψ^{(2k₁+1)n₂} and a C-point cyclic row DFT (root ω = ψ^{2R}).  Every
valid R gives the fused transform's output exactly.  It is the plain version
of the hand-written NTT kernel (``repro_torch.kernels.ntt``), which runs the
same dataflow on the card; its tables (:class:`FourStepConsts`) come staged as
u32 bit patterns in int32 tensors and are widened here.

The distributed engine (:mod:`repro_torch.core.distributed`) cuts the
four-step at its one exchange, the §III-B shuffle, into the phases
:func:`four_step_col_fwd`, :func:`four_step_row_fwd`,
:func:`four_step_row_inv` and :func:`four_step_col_inv`.  Each runs on a
block of a cluster map (a column slice (ℓ, R, C/cs) or a row slice
(ℓ, R/cs, C)) with that block's slice of the tables, as the reference's
shard bodies do (``src/repro/core/distributed.py:631-660``), and ends fully
reduced; they are the plain versions of the NTT phase kernels
(``repro_torch.kernels.ntt.ops.ntt_phase``).
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


def balanced_submodules(N: int) -> int:
    """CiFHER's balanced default submodule count: R = √N (power of two).

    The untuned fallback for the four-step R×C split: the kernel wrapper
    (``repro_torch.kernels.ntt.ops``) and the autotuner
    (``repro_torch.kernels.autotune``) both resolve R through here.
    """
    R = 1
    while R * R < N:
        R *= 2
    return R


def valid_submodules(N: int, R) -> bool:
    """True when R is a usable four-step split: power of two with C = N/R ≥ 2."""
    return (isinstance(R, int) and R >= 2 and (R & (R - 1)) == 0
            and N % R == 0 and N // R >= 2)


def ntt(x: torch.Tensor, c: NttConsts) -> torch.Tensor:
    """Forward negacyclic NTT over the last axis; natural-order in/out.

    Accepts values < 2q; output int32, fully reduced.
    """
    return mm.reduce_once(_ntt_lazy(x, c), c.q).to(torch.int32)


def _ntt_lazy(x: torch.Tensor, c: NttConsts) -> torch.Tensor:
    """Fused-CT forward stages in the lazy range, natural-order output.

    Input any values < 2q; output int64 in [0, 2q).
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
        w = c.psi_rev[..., m:2 * m, None]
        ws = c.psi_rev_shoup[..., m:2 * m, None]
        bw = mm.mulmod_shoup_lazy(b, w, ws, q)
        x = torch.stack([mm.addmod_lazy(a, bw, two_q),
                         mm.submod_lazy(a, bw, two_q)], dim=-2)
        x = x.reshape(*lead, N)
        m *= 2
    return x.index_select(-1, c.brev)       # bit-reversed → natural


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
        w = c.psi_inv_rev[..., h:2 * h, None]
        ws = c.psi_inv_rev_shoup[..., h:2 * h, None]
        u = mm.addmod_lazy(a, b, two_q)
        v = mm.mulmod_shoup_lazy(mm.submod_lazy(a, b, two_q), w, ws, q)
        x = torch.stack([u, v], dim=-2).reshape(*lead, N)
        t *= 2
        m = h
    return mm.mulmod_shoup(x, c.n_inv, c.n_inv_shoup, c.q).to(torch.int32)


# ----------------------------------------------------------------------------
# Four-step recomposable NTT (paper §III-B dataflow) — the NTT kernel's plain
# version
# ----------------------------------------------------------------------------

class FourStepConsts(NamedTuple):
    """Stacked per-limb constants for the R×C four-step decomposition.

    Host form (:func:`stacked_four_step_consts`): numpy u32 tables, field for
    field equal to the reference's.  Device form
    (``const_cache.device_four_step_consts``): the same bits in int32 tensors.
    """
    R: int
    C: int
    q: object                    # (ℓ, 1)
    col: NttConsts               # stacked negacyclic tables, length R, root ψ^C
    twiddle: object              # (ℓ, R, C) — ψ^{(2k₁+1)n₂}, k₁ natural
    twiddle_shoup: object
    twiddle_inv: object
    twiddle_inv_shoup: object
    row_pow: object              # (ℓ, C/2) — ω^i, ω = ψ^{2R}
    row_pow_shoup: object
    row_pow_inv: object
    row_pow_inv_shoup: object
    c_inv: object                # (ℓ, 1)
    c_inv_shoup: object
    brev_c: object               # (C,)
    # pre-permuted stage-major DIT twiddles (stage m = slice [m-1, 2m-1))
    row_stage: object            # (ℓ, C-1)
    row_stage_shoup: object
    row_stage_inv: object
    row_stage_inv_shoup: object


@functools.lru_cache(maxsize=None)
def stacked_four_step_consts(basis: tuple[int, ...], N: int,
                             R: int) -> FourStepConsts:
    tabs = [rns.four_step_tables(q, N, R) for q in basis]
    stack = lambda f: np.stack([f(t) for t in tabs])
    colv = lambda f: np.array([[f(t)] for t in tabs], dtype=np.uint32)
    col = NttConsts(
        q=colv(lambda t: t.col.q),
        psi_rev=stack(lambda t: t.col.psi_rev),
        psi_rev_shoup=stack(lambda t: t.col.psi_rev_shoup),
        psi_inv_rev=stack(lambda t: t.col.psi_inv_rev),
        psi_inv_rev_shoup=stack(lambda t: t.col.psi_inv_rev_shoup),
        n_inv=colv(lambda t: t.col.n_inv),
        n_inv_shoup=colv(lambda t: t.col.n_inv_shoup),
        brev=rns.bitrev_indices(R).astype(np.int64),
    )
    return FourStepConsts(
        R=R, C=N // R,
        q=colv(lambda t: t.col.q),
        col=col,
        twiddle=stack(lambda t: t.twiddle),
        twiddle_shoup=stack(lambda t: t.twiddle_shoup),
        twiddle_inv=stack(lambda t: t.twiddle_inv),
        twiddle_inv_shoup=stack(lambda t: t.twiddle_inv_shoup),
        row_pow=stack(lambda t: t.row_pow),
        row_pow_shoup=stack(lambda t: t.row_pow_shoup),
        row_pow_inv=stack(lambda t: t.row_pow_inv),
        row_pow_inv_shoup=stack(lambda t: t.row_pow_inv_shoup),
        c_inv=colv(lambda t: t.c_inv),
        c_inv_shoup=colv(lambda t: t.c_inv_shoup),
        brev_c=rns.bitrev_indices(N // R).astype(np.int32),
        row_stage=stack(lambda t: t.row_stage),
        row_stage_shoup=stack(lambda t: t.row_stage_shoup),
        row_stage_inv=stack(lambda t: t.row_stage_inv),
        row_stage_inv_shoup=stack(lambda t: t.row_stage_inv_shoup),
    )


def _u32(t: torch.Tensor) -> torch.Tensor:
    """u32 bits stored as int32 → their int64 values (Shoup companions reach
    2³²−1, so they read negative as int32)."""
    return t.to(torch.int64) & 0xFFFFFFFF


def _cyclic_dft_lazy(x, stage, stage_shoup, brev_c, q):
    """Length-C cyclic DIT NTT over the last axis, natural order in and out.

    Lazy butterflies: inputs < 2q, outputs in [0, 2q).  ``stage`` is the
    (ℓ, C-1) stage-major table: stage m reads the slice [m-1, 2m-1).  x is
    (..., ℓ, rows, C) int64; q (ℓ, 1).
    """
    C = x.shape[-1]
    lead = x.shape[:-1]
    qb = q[..., None]
    two_q = qb + qb
    x = x.index_select(-1, brev_c)
    m = 1
    while m < C:
        y = x.reshape(*lead[:-1], lead[-1] * (C // (2 * m)), 2, m)
        a, b = y[..., 0, :], y[..., 1, :]
        w = stage[:, None, m - 1:2 * m - 1]                  # (ℓ, 1, m)
        ws = stage_shoup[:, None, m - 1:2 * m - 1]
        bw = mm.mulmod_shoup_lazy(b, w, ws, qb)
        x = torch.stack([mm.addmod_lazy(a, bw, two_q),
                         mm.submod_lazy(a, bw, two_q)], dim=-2)
        x = x.reshape(*lead, C)
        m *= 2
    return x


def _col_consts(fc: FourStepConsts) -> NttConsts:
    return NttConsts(*(_u32(t) for t in fc.col))


def four_step_ntt(x: torch.Tensor, fc: FourStepConsts) -> torch.Tensor:
    """Forward negacyclic NTT via the R×C four-step dataflow.

    Natural order in and out, equal to :func:`ntt` for every valid R.  The
    data is viewed as A[n₁, n₂] = a[C·n₁ + n₂] and the output flattened as
    â[k₁ + R·k₂] = B[k₁, k₂].  Accepts values < 2q; output int32 in [0, q).
    ``fc`` holds device tensors (u32 bits in int32).
    """
    R, C = fc.R, fc.C
    lead = x.shape[:-1]
    q = _u32(fc.q)
    q3 = q[..., None]
    A = x.to(torch.int64).reshape(*lead, R, C)
    # 1) R-point negacyclic NTT along the columns: n₂ moves before the limb
    #    axis so the (ℓ, R) tables broadcast
    A = _ntt_lazy(A.movedim(-1, -3), _col_consts(fc)).movedim(-3, -1)
    # 2) inter-step twiddle ψ^{(2k₁+1)·n₂}
    A = mm.mulmod_shoup_lazy(A, _u32(fc.twiddle), _u32(fc.twiddle_shoup), q3)
    # 3) C-point cyclic DFT along the rows, root ω = ψ^{2R}
    A = _cyclic_dft_lazy(A, _u32(fc.row_stage), _u32(fc.row_stage_shoup),
                         fc.brev_c, q)
    A = mm.reduce_once(A, q3)
    # 4) transpose so that flattening gives â[k₁ + R·k₂]
    return A.transpose(-1, -2).reshape(*lead, R * C).to(torch.int32)


def four_step_intt(x: torch.Tensor, fc: FourStepConsts) -> torch.Tensor:
    """Inverse of :func:`four_step_ntt`; natural order in and out.

    Accepts values < 2q; output int32 in [0, q) by the column iNTT's final
    R⁻¹ Shoup multiply.
    """
    R, C = fc.R, fc.C
    lead = x.shape[:-1]
    q = _u32(fc.q)
    q3 = q[..., None]
    B = x.to(torch.int64).reshape(*lead, C, R).transpose(-1, -2)  # [k₁, k₂]
    # inverse row DFT (ω⁻¹), then C⁻¹ and the inverse twiddle, all lazy
    B = _cyclic_dft_lazy(B, _u32(fc.row_stage_inv),
                         _u32(fc.row_stage_inv_shoup), fc.brev_c, q)
    B = mm.mulmod_shoup_lazy(B, _u32(fc.c_inv)[..., None],
                             _u32(fc.c_inv_shoup)[..., None], q3)
    B = mm.mulmod_shoup_lazy(B, _u32(fc.twiddle_inv),
                             _u32(fc.twiddle_inv_shoup), q3)
    # inverse column NTT with its R⁻¹ scaling, which fully reduces
    B = intt(B.movedim(-1, -3), _col_consts(fc)).movedim(-3, -1)
    return B.reshape(*lead, R * C)


# ----------------------------------------------------------------------------
# The four-step cut at its exchange: the phases of the distributed transform
# (the bodies of the reference's sharded programs, distributed.py:631-660)
# ----------------------------------------------------------------------------

def _cyclic_dft(x, pow_tab, pow_tab_shoup, brev_c, q):
    """Length-C cyclic DIT NTT over the last axis, natural order and fully
    reduced in and out (the reference's ``core/ntt._cyclic_dft``).

    ``pow_tab``: (..., ℓ, C/2) int64 powers ω^i, stage m reading every
    C/(2m)-th; x (..., ℓ, rows, C); q (..., ℓ, 1).  The tables' leading dims
    broadcast against x's.
    """
    C = x.shape[-1]
    lead = x.shape[:-1]
    qb = q[..., None]
    two_q = qb + qb
    x = x.to(torch.int64).index_select(-1, brev_c)
    m = 1
    while m < C:
        y = x.reshape(*lead[:-1], lead[-1] * (C // (2 * m)), 2, m)
        a, b = y[..., 0, :], y[..., 1, :]
        stride = C // (2 * m)
        w = pow_tab[..., ::stride][..., :m][..., None, :]
        ws = pow_tab_shoup[..., ::stride][..., :m][..., None, :]
        bw = mm.mulmod_shoup_lazy(b, w, ws, qb)
        x = torch.stack([mm.addmod_lazy(a, bw, two_q),
                         mm.submod_lazy(a, bw, two_q)], dim=-2)
        x = x.reshape(*lead, C)
        m *= 2
    return mm.reduce_once(x, qb)


def four_step_col_fwd(A, col: NttConsts, tw, tw_shoup, q) -> torch.Tensor:
    """Forward column phase on a column slice (..., ℓ, R, Cl): the R-point
    negacyclic column NTT (root ψ^C, natural k₁ out), then the block's
    twiddle columns ψ^{(2k₁+1)n₂}; fully reduced int64.

    ``col``: int64 column tables whose leading dims broadcast against
    (..., Cl, ℓ, R); ``tw`` (..., ℓ, R, Cl); q (..., ℓ, 1).
    """
    A = ntt(A.movedim(-1, -3), col).movedim(-3, -1)
    return mm.mulmod_shoup(A, tw, tw_shoup, q[..., None])


def four_step_row_fwd(A, row_pow, row_pow_shoup, brev_c, q) -> torch.Tensor:
    """Forward row phase on a row slice (..., ℓ, Rl, C): the C-point cyclic
    DFT of each row (root ω = ψ^{2R}); fully reduced."""
    return _cyclic_dft(A, row_pow, row_pow_shoup, brev_c, q)


def four_step_row_inv(B, row_pow_inv, row_pow_inv_shoup, c_inv, c_inv_shoup,
                      brev_c, q) -> torch.Tensor:
    """Inverse row phase on a row slice (..., ℓ, Rl, C): the inverse row DFT
    (ω⁻¹), then C⁻¹; fully reduced.  ``c_inv`` (..., ℓ, 1)."""
    B = _cyclic_dft(B, row_pow_inv, row_pow_inv_shoup, brev_c, q)
    return mm.mulmod_shoup(B, c_inv[..., None], c_inv_shoup[..., None],
                           q[..., None])


def four_step_col_inv(B, col: NttConsts, tw_inv, tw_inv_shoup,
                      q) -> torch.Tensor:
    """Inverse column phase on a column slice (..., ℓ, R, Cl): the block's
    inverse twiddle columns, then the R-point column iNTT with its R⁻¹;
    fully reduced int32."""
    B = mm.mulmod_shoup(B, tw_inv, tw_inv_shoup, q[..., None])
    return intt(B.movedim(-1, -3), col).movedim(-3, -1)
