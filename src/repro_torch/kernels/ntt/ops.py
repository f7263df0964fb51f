"""Four-step NTT: the wrappers, the CUDA kernel's launch, and its plain version.

``ntt_fwd`` / ``ntt_inv`` transform (..., ℓ, N) int32 residues over ``basis``
(one prime per limb row, any leading dims, any values below 2q) into
canonical [0, q) residues, natural order in and out.  A CUDA tensor runs the
hand-written kernel (``csrc/ntt.cu``: one launch, each limb held in the
shared memory of a thread-block cluster); a CPU tensor runs the plain
four-step of :mod:`repro_torch.core.ntt` at the same R.  Unpinned knobs
resolve through :func:`repro_torch.kernels.autotune.best_config`: R (a cold
cache gives R = √N) and ``cluster``, the CTAs that share one limb (a cold
cache gives :func:`cluster_plan`).

:func:`ntt_phase` runs one phase of the distributed four-step
(:mod:`repro_torch.core.distributed`) on every block of a mesh at once: the
forward column phase, the forward row phase, the inverse row phase or the
inverse column phase (``csrc/ntt.cu``: ``ntt_col_phase_kernel`` and
``ntt_row_phase_kernel``, one launch per phase at :func:`phase_plan`'s tile;
on CPU tensors the phases of :mod:`repro_torch.core.ntt`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import const_cache
from repro_torch.core import ntt as nttm
from repro_torch.kernels import autotune, config, native

#: The portable thread-block cluster sizes.
CLUSTER_SIZES = (1, 2, 4, 8)
#: Shared memory per CTA at which two CTAs of the kernel (compiled for two
#: CTAs of 512 threads per SM) fit on one H100 SM: half of the SM's 228 KiB,
#: less the 1 KiB each CTA leaves to the system.
PAIR_SMEM = 228 * 1024 // 2 - 1024


def default_submodules(N: int) -> int:
    """CiFHER's default submodule count R = √N (see
    :func:`repro_torch.core.ntt.balanced_submodules`)."""
    return nttm.balanced_submodules(N)


def stage_pairs(N: int, R: int, cluster: int) -> bool:
    """Whether the kernel copies the limb's R + N/R - 1 column and row
    twiddles, with their companions, to shared memory (else it reads them
    from device memory): when they take at most a quarter of the CTA's
    N/cluster words (R and N/R near √N) and fit beside them, so that they
    never cost a CTA per SM.  A butterfly then reads its twiddle pair with one
    shared-memory load."""
    words, pairs = N // cluster, 2 * (R + N // R - 1)
    return 4 * pairs <= words and (words + pairs) * 4 <= autotune.SMEM_MAX


def smem_bytes_per_cta(N: int, R: int, cluster: int) -> int:
    """Shared memory one CTA of the kernel takes: its N/cluster words, and
    the twiddle pairs where :func:`stage_pairs` stages them."""
    return (N // cluster + 2 * (R + N // R - 1) * stage_pairs(N, R, cluster)) * 4


def cluster_ok(N: int, R: int, cluster: int) -> bool:
    """True when clusters of ``cluster`` CTAs can run the R × N/R split: a
    portable size, at most R (each CTA holds whole rows, R/cluster of them),
    a per-CTA share within :data:`autotune.SMEM_MAX`, and N a multiple of
    4·cluster² (the stages across CTAs move 16 bytes at a time)."""
    return (cluster in CLUSTER_SIZES and cluster <= R
            and N // cluster * 4 <= autotune.SMEM_MAX
            and (cluster == 1 or N % (4 * cluster * cluster) == 0))


def cluster_plan(N: int, R: int) -> int:
    """The untuned cluster size for the R × N/R split: the largest per-CTA
    share at which two CTAs still share an SM (:data:`PAIR_SMEM`; 1 when the
    whole limb fits), else the largest that fits one CTA.  Two CTAs per SM
    hide each other's memory phases: at N = 2¹⁶ a cluster of 4 (64 KiB per
    CTA) beat one of 2 (128 KiB) at every shape of the main path on the H100
    (PERF.md §6).  Raises when no cluster size fits."""
    for budget in (PAIR_SMEM, autotune.SMEM_MAX):
        for cluster in CLUSTER_SIZES:
            if (cluster_ok(N, R, cluster)
                    and smem_bytes_per_cta(N, R, cluster) <= budget):
                return cluster
    raise ValueError(f"no cluster of {CLUSTER_SIZES} CTAs holds a limb of "
                     f"N = {N} words split R = {R} within {autotune.SMEM_MAX} "
                     "bytes per CTA")


def resolve(x: torch.Tensor, R, cluster) -> tuple[int, int]:
    """(R, cluster) for operand ``x``: pinned values win, the rest come from
    the autotuner's cache for x's device (a cold cache gives R = √N and
    :func:`cluster_plan`; a cached cluster counts only with its own R)."""
    ell, N = x.shape[-2], x.shape[-1]
    cfg = {}
    if R is None or cluster is None:
        cfg = autotune.best_config("ntt", N, ell, backend=x.device.type)
        R = cfg["R"] if R is None else R
    if not nttm.valid_submodules(N, R):
        raise ValueError(f"R = {R} is no four-step split of N = {N}")
    if cluster is None:
        cached = cfg.get("cluster")
        tuned = cfg.get("R") == R and cached is not None and cluster_ok(N, R, cached)
        cluster = cached if tuned else cluster_plan(N, R)
    elif not cluster_ok(N, R, cluster):
        raise ValueError(f"cluster = {cluster} cannot hold N = {N} split R = {R}")
    return R, cluster


def ntt_fwd(x: torch.Tensor, basis: tuple[int, ...], R: int | None = None,
            cluster: int | None = None) -> torch.Tensor:
    """Forward negacyclic NTT of (..., ℓ, N) over ``basis``."""
    return _transform(x, tuple(basis), R, cluster, forward=True)


def ntt_inv(x: torch.Tensor, basis: tuple[int, ...], R: int | None = None,
            cluster: int | None = None) -> torch.Tensor:
    """Inverse negacyclic NTT of (..., ℓ, N) over ``basis``."""
    return _transform(x, tuple(basis), R, cluster, forward=False)


def _transform(x, basis, R, cluster, forward: bool) -> torch.Tensor:
    kernel = native.on_cuda(x)
    if x.dim() < 2 or x.shape[-2] != len(basis):
        raise ValueError(f"ntt: operand {tuple(x.shape)} for {len(basis)} primes")
    R, cluster = resolve(x, R, cluster)
    fc = const_cache.device_four_step_consts(basis, x.shape[-1], R, x.device)
    if kernel:
        return ntt_cuda(x.contiguous(), fc, forward, cluster)
    return ntt_plain(x, fc, forward)


def ntt_plain(x: torch.Tensor, fc: nttm.FourStepConsts, forward: bool) -> torch.Tensor:
    """The plain four-step transform at the tables' R (int64 torch)."""
    return (nttm.four_step_ntt if forward else nttm.four_step_intt)(x, fc)


def ntt_cuda(x: torch.Tensor, fc: nttm.FourStepConsts, forward: bool,
             cluster: int) -> torch.Tensor:
    """Launch the one-pass kernel (``csrc/ntt.cu``) on the current stream:
    one launch, ``cluster`` CTAs per limb row, no scratch."""
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
    if not cluster_ok(N, R, cluster):
        raise ValueError(f"cluster = {cluster} cannot hold N = {N} split R = {R}")
    out = torch.empty_like(x)
    lib = native.lib("ntt")
    launch = lib.ntt_fwd_launch if forward else lib.ntt_inv_launch
    config.before_launch("ntt")
    with native.on_device(x):
        err = launch(x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tabs),
                     x.numel() // N, ell, R, C, cluster,
                     int(stage_pairs(N, R, cluster)), native.stream_of(x))
    name = "ntt_fwd" if forward else "ntt_inv"
    native.check("ntt", err, name)
    config.count_launch("ntt", name, device=x.device)
    return out


# ----------------------------------------------------------------------------
# The distributed four-step's phases, on the blocks of a mesh
# ----------------------------------------------------------------------------

#: The four phases, in the order a forward then an inverse transform runs them.
PHASES = ("fwd_col", "fwd_row", "inv_row", "inv_col")
#: The phase kernels' limits (``csrc/ntt.cu``): R and C at most, and the words
#: of a tile (R × TC for a column phase, TR × C for a row phase).
PHASE_MAX_SIDE = 4096
TILE_WORDS = 4096
#: An H100's SM count, the default of :func:`phase_plan`'s ``sms``.
H100_SMS = 132


class PhasePlan(NamedTuple):
    """How a phase kernel cuts its launch: ``tile`` columns (column phases,
    TC) or rows (row phases, TR) of a block slice per CTA, each CTA one tile
    of one batch row of one limb of one block (the B CTAs of a tile next to
    each other in the grid, so all but the first can find its tables in L2);
    ``ctas`` in all; ``smem`` dynamic shared bytes per CTA (the tile, and for
    a column phase its twiddle columns in two planes and the R column pairs,
    for a row phase the C − 1 stage pairs)."""
    tile: int
    ctas: int
    smem: int


def phase_plan(phase: str, lc: int, cs: int, B: int, ell: int, R: int, C: int,
               sms: int = H100_SMS) -> PhasePlan:
    """The phase kernel's plan for (lc, cs, B, ℓ) blocks of an R × C split.

    The widest tile that fits (:data:`TILE_WORDS`); where that leaves fewer
    than ``sms`` CTAs, the tile narrowed down to 4 columns or rows (a column
    tile's rows stay 16-byte copies; a row tile of 4 × 256 words keeps half
    of its 128 threads busy in a radix-16 pass) until the launch fills the
    SMs or cannot be cut further.  Raises where the launcher refuses the
    shapes."""
    col = phase.endswith("col")
    if phase not in PHASES:
        raise ValueError(f"unknown NTT phase {phase!r} — one of {PHASES}")
    pow2 = all(v >= 1 and v & (v - 1) == 0 for v in (R, C, cs))
    if not (pow2 and 2 <= R <= PHASE_MAX_SIDE and 2 <= C <= PHASE_MAX_SIDE
            and R % cs == 0 and C % cs == 0 and min(lc, B, ell) > 0
            and ell <= 65535 and lc * cs <= 65535):
        raise ValueError(f"ntt_phase {phase}: no launch for ({lc}, {cs}, {B}, {ell}) "
                         f"blocks of {R}×{C}")
    span, other = (C // cs, R) if col else (R // cs, C)
    tile = min(span, max(1, TILE_WORDS // other))
    least = min(tile, 4)
    while lc * cs * ell * B * (span // tile) < sms and tile > least:
        tile //= 2
    words = other * tile
    smem = 4 * (3 * words + 2 * R) if col else 4 * (words + 2 * (C - 1))
    return PhasePlan(tile, lc * cs * ell * B * (span // tile), smem)


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


_sms: dict[int, int] = {}


def _phase_shape(x: torch.Tensor, fc: nttm.FourStepConsts,
                 phase: str) -> tuple[int, int]:
    """(rows, cols) of one block of ``x`` for ``phase``: the column slice
    (R, C/cs) or the row slice (R/cs, C)."""
    if phase not in PHASES:
        raise ValueError(f"unknown NTT phase {phase!r} — one of {PHASES}")
    if x.dim() != 5:
        raise ValueError(f"ntt_phase takes (lc, cs, B, ℓ, n) blocks, got {tuple(x.shape)}")
    cs = x.shape[1]
    R, C = fc.R, fc.C
    if R % cs or C % cs:
        raise ValueError(f"ntt_phase: {cs} blocks per limb cluster cannot split {R}×{C}")
    rows, cols = (R, C // cs) if phase.endswith("col") else (R // cs, C)
    if x.shape[-1] != rows * cols:
        raise ValueError(f"ntt_phase {phase}: blocks of {x.shape[-1]} words, "
                         f"expected {rows}×{cols}")
    return rows, cols


def _check_limbs(x: torch.Tensor, fc: nttm.FourStepConsts, limb_block: int) -> None:
    lc, ell = x.shape[0], fc.q.shape[0]
    want = lc * x.shape[3] if limb_block else x.shape[3]
    if want != ell or (limb_block and limb_block != x.shape[3]):
        raise ValueError(f"ntt_phase: {lc} limb clusters of {x.shape[3]} limbs "
                         f"(limb_block {limb_block}) for tables of {ell} limbs")


def ntt_phase(x: torch.Tensor, fc: nttm.FourStepConsts, phase: str,
              limb_block: int) -> torch.Tensor:
    """One phase of the distributed four-step on every block of a mesh.

    ``x``: (lc, cs, B, ℓ_loc, n_loc) int32 blocks, any strides over the first
    four dims and n_loc contiguous words: block (i, j) holds ℓ_loc limbs of
    the column slice (R, C/cs) j (column phases) or of the row slice
    (R/cs, C) j (row phases).  ``limb_block``: ℓ_loc when the limbs are split
    over the limb clusters (block row i holds limbs i·ℓ_loc …), 0 when every
    cluster holds all ℓ.  ``fc``: the four-step tables of the whole basis.
    Returns fresh contiguous (lc, cs, B, ℓ_loc, n_loc) int32 blocks, fully
    reduced.  CUDA tensors run the phase kernel, CPU tensors the plain phase.
    """
    _phase_shape(x, fc, phase)
    _check_limbs(x, fc, limb_block)
    if native.on_cuda(x):
        return ntt_phase_cuda(x, fc, phase, limb_block)
    return ntt_phase_plain(x, fc, phase, limb_block)


def _limb_rows(t: torch.Tensor, lc: int, limb_block: int) -> torch.Tensor:
    """A per-limb table (ℓ, ...) as (lc or 1, 1, 1, ℓ_loc, ...): the rows of
    each limb cluster's limbs, broadcast over the coef and batch dims."""
    t = nttm._u32(t)
    if limb_block:
        return t.reshape(lc, 1, 1, limb_block, *t.shape[1:])
    return t.reshape(1, 1, 1, *t.shape)


def _twiddle_blocks(t: torch.Tensor, lc: int, cs: int,
                    limb_block: int) -> torch.Tensor:
    """The twiddles (ℓ, R, C) sliced as the blocks hold them: block (i, j)
    reads its limbs' rows and the columns [j·C/cs, (j+1)·C/cs)."""
    ell, R, C = t.shape
    t = nttm._u32(t).reshape(ell, R, cs, C // cs).permute(2, 0, 1, 3)
    if limb_block:
        t = t.reshape(cs, lc, limb_block, R, C // cs).transpose(0, 1)
        return t.unsqueeze(2)
    return t.unsqueeze(0).unsqueeze(2)


def ntt_phase_plain(x: torch.Tensor, fc: nttm.FourStepConsts, phase: str,
                    limb_block: int) -> torch.Tensor:
    """The plain version of :func:`ntt_phase`: the phase functions of
    :mod:`repro_torch.core.ntt` on the block batch, each block reading its
    slice of the tables."""
    rows, cols = _phase_shape(x, fc, phase)
    lc, cs = x.shape[:2]
    A = x.reshape(*x.shape[:4], rows, cols)
    q = _limb_rows(fc.q, lc, limb_block)
    if phase.endswith("col"):
        # column tables against (..., cols, ℓ, R): one more broadcast dim
        col = nttm.NttConsts(*(
            _limb_rows(t, lc, limb_block).unsqueeze(3) if t.dim() == 2 else t.to(torch.int64)
            for t in fc.col))
        if phase == "fwd_col":
            out = nttm.four_step_col_fwd(
                A, col, _twiddle_blocks(fc.twiddle, lc, cs, limb_block),
                _twiddle_blocks(fc.twiddle_shoup, lc, cs, limb_block), q)
        else:
            out = nttm.four_step_col_inv(
                A, col, _twiddle_blocks(fc.twiddle_inv, lc, cs, limb_block),
                _twiddle_blocks(fc.twiddle_inv_shoup, lc, cs, limb_block), q)
    elif phase == "fwd_row":
        out = nttm.four_step_row_fwd(
            A, _limb_rows(fc.row_pow, lc, limb_block),
            _limb_rows(fc.row_pow_shoup, lc, limb_block), fc.brev_c, q)
    else:
        out = nttm.four_step_row_inv(
            A, _limb_rows(fc.row_pow_inv, lc, limb_block),
            _limb_rows(fc.row_pow_inv_shoup, lc, limb_block),
            _limb_rows(fc.c_inv, lc, limb_block),
            _limb_rows(fc.c_inv_shoup, lc, limb_block), fc.brev_c, q)
    return out.reshape(x.shape).to(torch.int32)


def ntt_phase_cuda(x: torch.Tensor, fc: nttm.FourStepConsts, phase: str,
                   limb_block: int) -> torch.Tensor:
    """Launch the phase kernel (``csrc/ntt.cu``) at :func:`phase_plan`'s
    plan: one launch over every block, which reads ``x`` through its
    strides."""
    _phase_shape(x, fc, phase)
    if x.stride(-1) != 1:
        x = x.contiguous()
    native.require({"x": x}, torch.int32, x.device, contiguous=False)
    tabs = {"fwd_col": (fc.col.psi_rev, fc.col.psi_rev_shoup, fc.twiddle,
                        fc.twiddle_shoup, fc.q),
            "fwd_row": (fc.row_stage, fc.row_stage_shoup, fc.q),
            "inv_row": (fc.row_stage_inv, fc.row_stage_inv_shoup, fc.c_inv,
                        fc.c_inv_shoup, fc.q),
            "inv_col": (fc.col.psi_inv_rev, fc.col.psi_inv_rev_shoup,
                        fc.twiddle_inv, fc.twiddle_inv_shoup, fc.col.n_inv,
                        fc.col.n_inv_shoup, fc.q)}[phase]
    native.require({f"table {i}": t for i, t in enumerate(tabs)}, torch.int32,
                   x.device)
    lc, cs, B, ell = x.shape[:4]
    plan = phase_plan(phase, lc, cs, B, ell, fc.R, fc.C, _sm_count(x.device))
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    launch = getattr(native.lib("ntt"), f"ntt_{phase}_launch")
    name = f"ntt_{phase}"
    config.before_launch("ntt")
    with native.on_device(x):
        err = launch(x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tabs),
                     *x.stride()[:4], lc, cs, B, ell, limb_block, fc.R, fc.C,
                     plan.tile, native.stream_of(x))
    native.check("ntt", err, name)
    config.count_launch("ntt", name, device=x.device)
    return out
