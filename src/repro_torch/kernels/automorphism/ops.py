"""AutoU kernels: the single permutation (batched and eager), the
multi-permutation and the fused AutoU∘KS, with their plain torch versions and
wrappers.

Permutation tables are device-resident int64 index vectors from
:mod:`repro_torch.core.const_cache`: (N,) per Galois element, (R, N) per
rotation set, staged once per device.  The fused AutoU∘KS kernel reads none:
it computes each Galois map from its affine form (two words per rotation).  The single-permutation kernel's
``rows_per_cta`` resolves through
:func:`repro_torch.kernels.autotune.best_config` when the caller pins none.
The multi-permutation and eager kernels are one thread-block-cluster kernel
that stages each source row once across the cluster's shared memory; how
many CTAs share a row is :func:`cluster_plan`'s rule.  :func:`automorphism_blocks`
is the AutoU gather of the distributed engine's slot-parallel automorphism:
the single-permutation kernel with an output row shorter than its input row.
"""
from __future__ import annotations

import torch

from repro_torch.core import const_cache
from repro_torch.kernels import autotune, config, native

#: Bytes of a staged row that one CTA of a cluster may hold (the per-CTA
#: budget of :func:`cluster_plan`): nearly all of a Hopper CTA's 227 KB, so
#: that the windows of a two-CTA cluster overlap and most reads are local —
#: a scattered read of another CTA's shared memory costs several times a
#: local one on the H100 (PERF.md §6).
WINDOW_BUDGET = 224 * 1024
#: The portable thread-block cluster sizes.
CLUSTER_SIZES = (1, 2, 4, 8)


def cluster_plan(N: int) -> tuple[int, int, int]:
    """(C, S, T) for staging a length-N u32 row across a cluster of C CTAs.
    CTA r holds the window of S = min(N, budget) words from min(r·T, N - S),
    T the least power of two ≥ 4 with C·T ≥ N, so CTA w // T holds word w
    when S ≥ min(T, N); C is the smallest portable cluster size for which
    that holds within :data:`WINDOW_BUDGET`.  The cluster kernels receive all
    three numbers."""
    words = WINDOW_BUDGET // 4
    for C in CLUSTER_SIZES:
        T = max(4, 1 << (-(-N // C) - 1).bit_length())
        if min(T, N) <= words:
            return C, min(N, words), T
    raise ValueError(f"a row of N = {N} words does not fit a cluster of "
                     f"{CLUSTER_SIZES[-1]} CTAs of {WINDOW_BUDGET} bytes")


def automorphism(x: torch.Tensor, perm: torch.Tensor,
                 rows_per_cta: int | None = None) -> torch.Tensor:
    """out[..., k] = x[..., perm[k]] over every leading dim, one launch."""
    if native.on_cuda(x, perm):
        if rows_per_cta is None:
            ell = x.shape[-2] if x.dim() > 1 else 1
            rows_per_cta = autotune.best_config(
                "automorphism", x.shape[-1], ell, backend="cuda")["rows_per_cta"]
        return automorphism_cuda(x.contiguous(), perm, rows_per_cta)
    return automorphism_plain(x, perm)


def apply_galois(x: torch.Tensor, N: int, g: int,
                 rows_per_cta: int | None = None) -> torch.Tensor:
    """φ_g of (..., N) NTT-domain residues, batched over all leading dims."""
    return automorphism(x, const_cache.device_galois_perm(N, g, x.device),
                        rows_per_cta)


def apply_rotation(x: torch.Tensor, N: int, r: int,
                   rows_per_cta: int | None = None) -> torch.Tensor:
    """Slot rotation by ``r``: φ_g with g = 5^r mod 2N."""
    from repro_torch.core import poly
    return apply_galois(x, N, poly.galois_elt(r, N), rows_per_cta)


def automorphism_plain(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Plain version of the batched kernel: one gather along the last axis."""
    return x.index_select(-1, perm)


def automorphism_cuda(x: torch.Tensor, perm: torch.Tensor,
                      rows_per_cta: int) -> torch.Tensor:
    """Launch the batched single-permutation kernel (``csrc/automorphism.cu``)."""
    N = x.shape[-1]
    _check_perm(x, perm)
    _require_words(x, perm)
    B = x.numel() // N if N else 0
    rows = config.effective_block(max(B, 1), rows_per_cta)
    out = torch.empty_like(x)
    config.before_launch("automorphism")
    with native.on_device(x):
        err = native.lib("automorphism").automorphism_rows_launch(
            x.data_ptr(), perm.data_ptr(), out.data_ptr(), B, N, rows,
            native.stream_of(x))
    native.check("automorphism", err, "automorphism")
    config.count_launch("automorphism", "automorphism", device=x.device)
    return out


def automorphism_blocks(full: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The AutoU gather on every block of a (limb, coef) mesh at once.

    ``full``: (lc, cs, B, ℓ, N) int32, each block's rows all-gathered to the
    whole length N; ``table``: (cs·n,) int64 index table, the Galois map
    conjugated by the scope's layout (n = N/cs, or on one part of a mesh
    split over several, that part's slice of the map for its cs blocks).
    Block (i, j) writes its n outputs out[i, j, b, l, p] = full[i, j, b, l,
    table[j·n + p]].  Returns (lc, cs, B, ℓ, n) int32.
    """
    _check_blocks(full, table)
    if native.on_cuda(full, table):
        return automorphism_blocks_cuda(full.contiguous(), table)
    return automorphism_blocks_plain(full, table)


def automorphism_blocks_plain(full: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`automorphism_blocks`: one ``torch.gather``
    with each block's slice of the table."""
    _check_blocks(full, table)
    lc, cs, B, ell, N = full.shape
    n = table.shape[0] // cs
    idx = table.view(1, cs, 1, 1, n).expand(lc, cs, B, ell, n)
    return torch.gather(full, -1, idx)


def automorphism_blocks_cuda(full: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Launch the single-permutation kernel (``csrc/automorphism.cu``) with
    output rows of N/cs words, each block reading its slice of the table."""
    _check_blocks(full, table)
    _require_words(full, table)
    lc, cs, B, ell, N = full.shape
    n = table.shape[0] // cs
    group = B * ell                         # rows of one block
    rows = config.effective_block(group, None)
    out = torch.empty((lc, cs, B, ell, n), dtype=torch.int32, device=full.device)
    config.before_launch("automorphism")
    with native.on_device(full):
        err = native.lib("automorphism").automorphism_blocks_launch(
            full.data_ptr(), table.data_ptr(), out.data_ptr(), lc * cs * group,
            N, n, rows, group, cs, native.stream_of(full))
    native.check("automorphism", err, "automorphism_blocks")
    config.count_launch("automorphism", "automorphism_blocks", device=full.device)
    return out


def _check_blocks(full: torch.Tensor, table: torch.Tensor) -> None:
    if full.dim() != 5 or full.shape[-1] % full.shape[1]:
        raise ValueError(f"automorphism_blocks takes (lc, cs, B, ℓ, N) with cs "
                         f"dividing N, got {tuple(full.shape)}")
    if (table.dim() != 1 or table.shape[0] % full.shape[1]
            or full.shape[-1] % table.shape[0]):
        raise ValueError(f"perm {tuple(table.shape)} for N = {full.shape[-1]} "
                         f"and {full.shape[1]} blocks")


def automorphism_eager(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """(P, ℓ, N) → out[p, i, k] = x[p, i, perm[k]], one cluster per (poly, limb)."""
    if native.on_cuda(x, perm):
        return automorphism_eager_cuda(x.contiguous(), perm)
    return automorphism_eager_plain(x, perm)


def automorphism_eager_plain(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Plain version of the eager kernel: one gather per (poly, limb) row."""
    _check_eager_shapes(x, perm)
    P, ell, _ = x.shape
    return torch.stack([torch.stack([x[p, i].index_select(0, perm)
                                     for i in range(ell)]) for p in range(P)])


def automorphism_eager_cuda(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Launch the cluster permutation kernel (``csrc/automorphism.cu``) with
    one cluster per (poly, limb) row."""
    _check_eager_shapes(x, perm)
    _require_words(x, perm)
    P, ell, N = x.shape
    out = torch.empty_like(x)
    config.before_launch("automorphism")
    with native.on_device(x):
        err = native.lib("automorphism").automorphism_eager_launch(
            x.data_ptr(), perm.data_ptr(), out.data_ptr(), P * ell, N,
            *cluster_plan(N), native.stream_of(x))
    native.check("automorphism", err, "automorphism_eager")
    config.count_launch("automorphism", "automorphism_eager", device=x.device)
    return out


def _check_eager_shapes(x: torch.Tensor, perm: torch.Tensor) -> None:
    if x.dim() != 3:
        raise ValueError(f"eager automorphism takes (P, ℓ, N), got {tuple(x.shape)}")
    _check_perm(x, perm)


def _check_perm(x: torch.Tensor, perm: torch.Tensor) -> None:
    if perm.shape != (x.shape[-1],):
        raise ValueError(f"perm {tuple(perm.shape)} for N = {x.shape[-1]}")


def _require_words(x: torch.Tensor, perm: torch.Tensor) -> None:
    """A kernel's operands: int32 words and an int64 index table on x's device."""
    native.require({"x": x}, torch.int32, x.device)
    native.require({"perm": perm}, torch.int64, x.device)


def apply_galois_many(x: torch.Tensor, N: int, gs: tuple) -> torch.Tensor:
    """x: (G, L, N) with G ∈ {1, len(gs)} → (R, L, N), one launch for the
    whole rotation set (G = 1 broadcasts a shared operand)."""
    kernel = native.on_cuda(x)
    perms = const_cache.device_galois_perm_stack(N, tuple(gs), x.device)
    if kernel:
        return automorphism_multi_cuda(x.contiguous(), perms)
    return automorphism_multi_plain(x, perms)


def automorphism_multi_plain(x: torch.Tensor, perms: torch.Tensor) -> torch.Tensor:
    """out[r, i, k] = x[r if G == R else 0, i, perms[r, k]]."""
    _check_multi_shapes(x, perms)
    G, R = x.shape[0], perms.shape[0]
    return torch.stack([x[r if G == R else 0].index_select(-1, perms[r])
                        for r in range(R)])


def automorphism_multi_cuda(x: torch.Tensor, perms: torch.Tensor) -> torch.Tensor:
    """Launch the cluster permutation kernel (``csrc/automorphism.cu``): one
    cluster per limb looping over the R rotations when G = 1, one per
    (rotation, limb) when G = R."""
    _check_multi_shapes(x, perms)
    G, L, N = x.shape
    R = perms.shape[0]
    _require_words(x, perms)
    out = torch.empty((R, L, N), dtype=torch.int32, device=x.device)
    config.before_launch("automorphism")
    with native.on_device(x):
        err = native.lib("automorphism").automorphism_multi_launch(
            x.data_ptr(), perms.data_ptr(), out.data_ptr(), G, R, L, N,
            *cluster_plan(N), native.stream_of(x))
    native.check("automorphism", err, "automorphism_multi")
    config.count_launch("automorphism", "automorphism_multi", device=x.device)
    return out


def auto_ks(exts: torch.Tensor, evk_a: torch.Tensor, evk_b: torch.Tensor,
            N: int, gs: tuple, basis: tuple[int, ...]) -> torch.Tensor:
    """Fused φ_g ∘ evk inner product for the rotation set ``gs``.

    exts (J, G, L, N) hoisted digits over the extended basis Q_ℓ ∪ P (``basis``),
    G ∈ {1, R}; evk_a/evk_b (R, J, L, N) level-sliced digit keys →
    (R, 2, L, N): [r, 0] is ka, [r, 1] is kb of rotation r.
    """
    if native.on_cuda(exts, evk_a, evk_b):
        return auto_ks_cuda(exts, evk_a, evk_b, tuple(gs), tuple(basis))
    perms = const_cache.device_galois_perm_stack(N, tuple(gs), exts.device)
    q = const_cache.device_q(tuple(basis), exts.device)
    return auto_ks_plain(exts, evk_a, evk_b, perms, q)


def auto_ks_plain(exts, evk_a, evk_b, perms, q) -> torch.Tensor:
    """out[r, c, i, k] = Σ_j exts[j, g, i, perms[r, k]]·evk_c[r, j, i, k] mod q_i.

    q: (L, 1) int64.  Each product is reduced before the sum over digits.
    """
    G, R = exts.shape[1], perms.shape[0]
    _check_batch(G, R)
    out = []
    for r in range(R):
        e = exts[:, r if G == R else 0].index_select(-1, perms[r]).to(torch.int64)
        acc_a = (e * evk_a[r].to(torch.int64) % q).sum(0) % q
        acc_b = (e * evk_b[r].to(torch.int64) % q).sum(0) % q
        out.append(torch.stack([acc_a, acc_b]))
    return torch.stack(out).to(torch.int32)


def auto_ks_cuda(exts: torch.Tensor, evk_a: torch.Tensor, evk_b: torch.Tensor,
                 gs: tuple, basis: tuple[int, ...]) -> torch.Tensor:
    """Launch the fused AutoU∘KS kernel (``csrc/automorphism.cu``): limb-major,
    each Galois map computed from its affine form
    (:func:`repro_torch.core.poly.galois_affine`; N a power of two)."""
    exts, evk_a, evk_b = exts.contiguous(), evk_a.contiguous(), evk_b.contiguous()
    J, G, L, N = exts.shape
    R = len(gs)
    _check_batch(G, R)
    native.require({"exts": exts, "evk_a": evk_a, "evk_b": evk_b},
                   torch.int32, exts.device)
    if (evk_a.shape != (R, J, L, N) or evk_b.shape != (R, J, L, N)
            or len(basis) != L):
        raise ValueError(f"auto_ks: exts {tuple(exts.shape)}, evk "
                         f"{tuple(evk_a.shape)}/{tuple(evk_b.shape)}, {R} "
                         f"rotations, {len(basis)} primes")
    dev = exts.device
    galois = const_cache.device_galois_affine(N, tuple(gs), dev)
    q = const_cache.device_q(tuple(basis), dev)
    mu = const_cache.device_barrett(tuple(basis), dev)
    out = torch.empty((R, 2, L, N), dtype=torch.int32, device=dev)
    config.before_launch("auto_ks")
    with native.on_device(exts):
        err = native.lib("automorphism").auto_ks_launch(
            exts.data_ptr(), evk_a.data_ptr(), evk_b.data_ptr(), galois.data_ptr(),
            q.data_ptr(), mu.data_ptr(), out.data_ptr(), J, G, R, L, N,
            native.stream_of(exts))
    native.check("automorphism", err, "auto_ks")
    config.count_launch("auto_ks", "auto_ks", device=exts.device)
    return out


def _check_multi_shapes(x: torch.Tensor, perms: torch.Tensor) -> None:
    if x.dim() != 3 or perms.dim() != 2 or perms.shape[1] != x.shape[-1]:
        raise ValueError(f"multi-permutation takes x (G, L, N) and perms (R, N), "
                         f"got {tuple(x.shape)} and {tuple(perms.shape)}")
    _check_batch(x.shape[0], perms.shape[0])


def _check_batch(G: int, R: int) -> None:
    if G not in (1, R):
        raise ValueError(f"data batch {G} must be 1 or match perms batch {R}")
