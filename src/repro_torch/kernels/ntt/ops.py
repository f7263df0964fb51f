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
"""
from __future__ import annotations

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
    with native.on_device(x):
        err = launch(x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tabs),
                     x.numel() // N, ell, R, C, cluster,
                     int(stage_pairs(N, R, cluster)), native.stream_of(x))
    name = "ntt_fwd" if forward else "ntt_inv"
    native.check("ntt", err, name)
    config.count_launch("ntt", name)
    return out
