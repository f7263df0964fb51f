"""AutoU kernels: the multi-permutation and the fused AutoU∘KS, with their
plain torch versions and wrappers.

Permutation tables are device-resident (R, N) int64 stacks from
:mod:`repro_torch.core.const_cache` (staged once per (N, gs, device)).
"""
from __future__ import annotations

import torch

from repro_torch.core import const_cache
from repro_torch.kernels import config, native


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
    G, R = x.shape[0], perms.shape[0]
    _check_batch(G, R)
    return torch.stack([x[r if G == R else 0].index_select(-1, perms[r])
                        for r in range(R)])


def automorphism_multi_cuda(x: torch.Tensor, perms: torch.Tensor) -> torch.Tensor:
    """Launch the multi-permutation kernel (``csrc/automorphism.cu``)."""
    G, L, N = x.shape
    R = perms.shape[0]
    _check_batch(G, R)
    native.require({"x": x}, torch.int32, x.device)
    native.require({"perms": perms}, torch.int64, x.device)
    if perms.shape != (R, N):
        raise ValueError(f"perms {tuple(perms.shape)} for N = {N}")
    out = torch.empty((R, L, N), dtype=torch.int32, device=x.device)
    err = native.lib("automorphism").automorphism_multi_launch(
        x.data_ptr(), perms.data_ptr(), out.data_ptr(), G, R, L, N,
        native.stream_of(x))
    native.check("automorphism", err, "automorphism_multi")
    config.count_launch("automorphism")
    return out


def auto_ks(exts: torch.Tensor, evk_a: torch.Tensor, evk_b: torch.Tensor,
            N: int, gs: tuple, basis: tuple[int, ...]) -> torch.Tensor:
    """Fused φ_g ∘ evk inner product for the rotation set ``gs``.

    exts (J, G, L, N) hoisted digits over the extended basis Q_ℓ ∪ P (``basis``),
    G ∈ {1, R}; evk_a/evk_b (R, J, L, N) level-sliced digit keys →
    (R, 2, L, N): [r, 0] is ka, [r, 1] is kb of rotation r.
    """
    kernel = native.on_cuda(exts, evk_a, evk_b)
    perms = const_cache.device_galois_perm_stack(N, tuple(gs), exts.device)
    q = const_cache.device_q(tuple(basis), exts.device)
    if kernel:
        return auto_ks_cuda(exts.contiguous(), evk_a.contiguous(),
                            evk_b.contiguous(), perms, q)
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


def auto_ks_cuda(exts, evk_a, evk_b, perms, q) -> torch.Tensor:
    """Launch the fused AutoU∘KS kernel (``csrc/automorphism.cu``)."""
    J, G, L, N = exts.shape
    R = perms.shape[0]
    _check_batch(G, R)
    native.require({"exts": exts, "evk_a": evk_a, "evk_b": evk_b},
                   torch.int32, exts.device)
    native.require({"perms": perms, "q": q}, torch.int64, exts.device)
    if (evk_a.shape != (R, J, L, N) or evk_b.shape != (R, J, L, N)
            or perms.shape != (R, N) or q.numel() != L):
        raise ValueError(f"auto_ks: exts {tuple(exts.shape)}, evk "
                         f"{tuple(evk_a.shape)}/{tuple(evk_b.shape)}, perms "
                         f"{tuple(perms.shape)}, {q.numel()} primes")
    out = torch.empty((R, 2, L, N), dtype=torch.int32, device=exts.device)
    err = native.lib("automorphism").auto_ks_launch(
        exts.data_ptr(), evk_a.data_ptr(), evk_b.data_ptr(), perms.data_ptr(),
        q.data_ptr(), out.data_ptr(), J, G, R, L, N, native.stream_of(exts))
    native.check("automorphism", err, "auto_ks")
    config.count_launch("auto_ks")
    return out


def _check_batch(G: int, R: int) -> None:
    if G not in (1, R):
        raise ValueError(f"data batch {G} must be 1 or match perms batch {R}")
