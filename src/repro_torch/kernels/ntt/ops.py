"""Four-step NTT: the wrappers, the CUDA kernel's launch, and its plain version.

``ntt_fwd`` / ``ntt_inv`` transform (..., ℓ, N) int32 residues over ``basis``
(one prime per limb row, any leading dims, any values below 2q) into
canonical [0, q) residues, natural order in and out.  A CUDA tensor runs the
hand-written kernel (``csrc/ntt.cu``, one launch = its column and row
passes); a CPU tensor runs the plain four-step of
:mod:`repro_torch.core.ntt` at the same R.  Unpinned knobs resolve through
:func:`repro_torch.kernels.autotune.best_config`: R (a cold cache gives
R = √N) and ``tile``, the column pass's tile width.
"""
from __future__ import annotations

import torch

from repro_torch.core import const_cache
from repro_torch.core import ntt as nttm
from repro_torch.kernels import autotune, config, native

ROW_SMEM = 48 * 1024        # the row pass's tile: TR rows of C+1 words


def default_submodules(N: int) -> int:
    """CiFHER's default submodule count R = √N (see
    :func:`repro_torch.core.ntt.balanced_submodules`)."""
    return nttm.balanced_submodules(N)


def resolve(x: torch.Tensor, R, tile) -> tuple[int, int]:
    """(R, tile) for operand ``x``: pinned values win, the rest come from
    the autotuner's cache for x's device (a cold cache gives R = √N)."""
    ell, N = x.shape[-2], x.shape[-1]
    if R is None or tile is None:
        cfg = autotune.best_config("ntt", N, ell, backend=x.device.type)
        R = cfg["R"] if R is None else R
        tile = cfg["tile"] if tile is None else tile
    if not nttm.valid_submodules(N, R):
        raise ValueError(f"R = {R} is no four-step split of N = {N}")
    return R, tile


def ntt_fwd(x: torch.Tensor, basis: tuple[int, ...], R: int | None = None,
            tile: int | None = None) -> torch.Tensor:
    """Forward negacyclic NTT of (..., ℓ, N) over ``basis``."""
    return _transform(x, tuple(basis), R, tile, forward=True)


def ntt_inv(x: torch.Tensor, basis: tuple[int, ...], R: int | None = None,
            tile: int | None = None) -> torch.Tensor:
    """Inverse negacyclic NTT of (..., ℓ, N) over ``basis``."""
    return _transform(x, tuple(basis), R, tile, forward=False)


def _transform(x, basis, R, tile, forward: bool) -> torch.Tensor:
    kernel = native.on_cuda(x)
    if x.dim() < 2 or x.shape[-2] != len(basis):
        raise ValueError(f"ntt: operand {tuple(x.shape)} for {len(basis)} primes")
    R, tile = resolve(x, R, tile)
    fc = const_cache.device_four_step_consts(basis, x.shape[-1], R, x.device)
    if kernel:
        return ntt_cuda(x.contiguous(), fc, forward, tile)
    return ntt_plain(x, fc, forward)


def ntt_plain(x: torch.Tensor, fc: nttm.FourStepConsts, forward: bool) -> torch.Tensor:
    """The plain four-step transform at the tables' R (int64 torch)."""
    return (nttm.four_step_ntt if forward else nttm.four_step_intt)(x, fc)


def tiles(R: int, C: int, tile: int) -> tuple[int, int]:
    """(TC, TR): the column tile width clamped to C and to a CTA's shared
    memory, and the largest power-of-two row block whose tile fits 48 KB."""
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"tile {tile} is not a power of two")
    tc = min(tile, C)
    while tc > 1 and R * tc * 4 > autotune.SMEM_MAX:
        tc //= 2
    tr = 1
    while tr < R and 2 * tr * (C + 1) * 4 <= ROW_SMEM:
        tr *= 2
    if R * tc * 4 > autotune.SMEM_MAX or tr * (C + 1) * 4 > autotune.SMEM_MAX:
        raise ValueError(f"R = {R}, C = {C}: a column or row exceeds a CTA's "
                         "shared memory")
    return tc, tr


def ntt_cuda(x: torch.Tensor, fc: nttm.FourStepConsts, forward: bool,
             tile: int) -> torch.Tensor:
    """Launch the four-step kernel (``csrc/ntt.cu``) on the current stream."""
    ell, N = x.shape[-2], x.shape[-1]
    R, C = fc.R, fc.C
    native.require({"x": x}, torch.int32, x.device)
    if forward:
        tabs = (fc.col.psi_rev, fc.col.psi_rev_shoup, fc.twiddle,
                fc.twiddle_shoup, fc.row_stage, fc.row_stage_shoup, fc.q)
    else:
        tabs = (fc.col.psi_inv_rev, fc.col.psi_inv_rev_shoup, fc.twiddle_inv,
                fc.twiddle_inv_shoup, fc.row_stage_inv, fc.row_stage_inv_shoup,
                fc.col.n_inv, fc.col.n_inv_shoup, fc.c_inv, fc.c_inv_shoup, fc.q)
    native.require({f"table {i}": t for i, t in enumerate(tabs)}, torch.int32,
                   x.device)
    if R * C != N or fc.q.shape[0] != ell:
        raise ValueError(f"ntt: operand {tuple(x.shape)} with tables for "
                         f"{fc.q.shape[0]} limbs of {R}×{C}")
    tc, tr = tiles(R, C, tile)
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)
    lib = native.lib("ntt")
    launch = lib.ntt_fwd_launch if forward else lib.ntt_inv_launch
    err = launch(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                 *(t.data_ptr() for t in tabs), x.numel() // N, ell, R, C, tc,
                 tr, native.stream_of(x))
    name = "ntt_fwd" if forward else "ntt_inv"
    native.check("ntt", err, name)
    config.count_launch("ntt", name)
    return out
