"""BConvU: limb-wise q̂⁻¹ scaling + the table-product kernel (HPS BConv).

    BConv_{Q→P}(x)_j = Σ_i [x_i · q̂_i⁻¹]_{q_i} · (q̂_i mod p_j)   (mod p_j)

The q̂⁻¹ pre-scale is plain torch in :func:`bconv`, as in the reference's
``kernels/bconv/ops.py``; the (K×ℓ)·(ℓ×N) table product is the kernel
(:func:`bconv_matmul_cuda`) or its plain version (:func:`bconv_matmul_plain`).
"""
from __future__ import annotations

import torch

from repro_torch.core import const_cache
from repro_torch.core import modmath as mm
from repro_torch.kernels import config, native


def bconv(x: torch.Tensor, src: tuple[int, ...], dst: tuple[int, ...]) -> torch.Tensor:
    """(…, ℓ, N) coeff-domain residues in ``src`` → (…, K, N) in ``dst``.

    All leading dims flatten into the kernel's batch; the CUDA kernel runs for
    CUDA tensors, the plain version for CPU tensors.
    """
    matmul = bconv_matmul_cuda if native.on_cuda(x) else bconv_matmul_plain
    return _bconv(x, tuple(src), tuple(dst), matmul)


def bconv_plain(x: torch.Tensor, src: tuple[int, ...],
                dst: tuple[int, ...]) -> torch.Tensor:
    """The whole BConv in plain torch on any device (the eager engine)."""
    return _bconv(x, tuple(src), tuple(dst), bconv_matmul_plain)


def _bconv(x, src, dst, matmul):
    c = const_cache.device_bconv_consts(src, dst, x.device)
    t = mm.mulmod(x, c.qhat_inv, c.q_src).to(torch.int32)
    lead, (ell, N) = t.shape[:-2], t.shape[-2:]
    out = matmul(t.reshape(-1, ell, N), c.table, c.q_dst)
    return out.reshape(*lead, len(dst), N)


def bconv_matmul_plain(t: torch.Tensor, table: torch.Tensor,
                       q_dst: torch.Tensor) -> torch.Tensor:
    """out[b, j, n] = Σ_i t[b, i, n]·table[j, i] mod p_j, in int64.

    t: (B, ℓ, N) int32 pre-scaled limbs; table: (K, ℓ) int64; q_dst: (K, 1)
    int64.  Each term is reduced before it is added, so the sum is exact.
    """
    B, ell, N = t.shape
    acc = torch.zeros((B, table.shape[0], N), dtype=torch.int64, device=t.device)
    for i in range(ell):
        acc += t[:, i, None, :].to(torch.int64) * table[:, i, None] % q_dst
    return (acc % q_dst).to(torch.int32)


def bconv_matmul_cuda(t: torch.Tensor, table: torch.Tensor,
                      q_dst: torch.Tensor) -> torch.Tensor:
    """Launch the BConvU kernel (``csrc/bconv.cu``) on the current stream."""
    t = t.contiguous()
    B, ell, N = t.shape
    K = table.shape[0]
    native.require({"t": t}, torch.int32, t.device)
    native.require({"table": table, "q_dst": q_dst}, torch.int64, t.device)
    if table.shape != (K, ell) or q_dst.numel() != K:
        raise ValueError(f"bconv: table {tuple(table.shape)} and "
                         f"{q_dst.numel()} primes for {ell} source limbs")
    out = torch.empty((B, K, N), dtype=torch.int32, device=t.device)
    err = native.lib("bconv").bconv_launch(
        t.data_ptr(), table.data_ptr(), q_dst.data_ptr(), out.data_ptr(),
        B, ell, K, N, native.stream_of(t))
    native.check("bconv", err, "bconv")
    config.count_launch("bconv")
    return out
