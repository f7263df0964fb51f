"""BConvU: the HPS base conversion, q̂⁻¹ pre-scale and table product.

    BConv_{Q→P}(x)_j = Σ_i [x_i · q̂_i⁻¹]_{q_i} · (q̂_i mod p_j)   (mod p_j)

On CUDA tensors :func:`bconv` launches the kernel (``csrc/bconv.cu``), which
applies the pre-scale in registers and computes the table product in the same
pass.  The plain version, :func:`bconv_plain`, is the pre-scale in torch (as in
the reference's ``kernels/bconv/ops.py``) followed by the table product
:func:`bconv_matmul_plain`; it runs for CPU tensors and for the eager BConv
engine on any device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import const_cache
from repro_torch.core import modmath as mm
from repro_torch.kernels import config, native

#: Coefficients of one row that a CTA of the kernel covers (256 threads × 4).
TILE = 1024
#: Destination primes a CTA takes at most by :func:`chunk_plan`: enough to
#: amortise the per-CTA re-read and pre-scale of its input.
PLAN_CHUNK = 16

_resident: dict[tuple[int, int], int] = {}


def chunk_plan(B: int, K: int, N: int, resident: int) -> int:
    """Destination primes per CTA: an even share of the K primes over as many
    splits as one wave of ``resident`` CTAs holds (⌈N / TILE⌉ · B CTAs a
    split), but at least ⌈K / PLAN_CHUNK⌉ splits.  The kernel is bound by its
    multiply-adds, so the grid should fill whole waves: a partial last wave
    leaves SMs idle."""
    tiles = max(1, B * -(-N // TILE))
    splits = min(K, max(-(-K // PLAN_CHUNK), resident // tiles))
    return -(-K // splits)


def resident_ctas(ell: int, device: torch.device) -> int:
    """CTAs of the kernel for ``ell`` source primes that the card holds at
    once: its SMs times the CTAs one SM fits at that instantiation's
    registers and the shared memory of :data:`PLAN_CHUNK` primes."""
    key = (device.index, ell)
    if key not in _resident:
        ctas = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = native.lib("bconv").bconv_ctas_per_sm(ell, PLAN_CHUNK,
                                                        ctypes.byref(ctas))
        native.check("bconv", err, "bconv occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _resident[key] = max(1, ctas.value) * sms
    return _resident[key]


def bconv(x: torch.Tensor, src: tuple[int, ...], dst: tuple[int, ...]) -> torch.Tensor:
    """(…, ℓ, N) coeff-domain residues in ``src`` → (…, K, N) in ``dst``.

    All leading dims flatten into the kernel's batch; the CUDA kernel runs for
    CUDA tensors, the plain version for CPU tensors.
    """
    if native.on_cuda(x):
        return bconv_cuda(x, tuple(src), tuple(dst))
    return bconv_plain(x, tuple(src), tuple(dst))


def bconv_plain(x: torch.Tensor, src: tuple[int, ...],
                dst: tuple[int, ...]) -> torch.Tensor:
    """The whole BConv in plain torch on any device (the eager engine)."""
    c = const_cache.device_bconv_consts(tuple(src), tuple(dst), x.device)
    t = mm.mulmod(x, c.qhat_inv, c.q_src).to(torch.int32)
    lead, (ell, N) = t.shape[:-2], t.shape[-2:]
    out = bconv_matmul_plain(t.reshape(-1, ell, N), c.table, c.q_dst)
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


def bconv_cuda(x: torch.Tensor, src: tuple[int, ...], dst: tuple[int, ...]) -> torch.Tensor:
    """Launch the BConvU kernel (``csrc/bconv.cu``) on the current stream:
    the whole BConv of canonical residues ``x`` in one pass, with
    :func:`chunk_plan`'s destination primes per CTA."""
    src, dst = tuple(src), tuple(dst)
    lead, (ell, N) = x.shape[:-2], x.shape[-2:]
    if ell != len(src):
        raise ValueError(f"bconv: {ell} limbs for {len(src)} source primes")
    flat = x.reshape(-1, ell, N).contiguous()
    native.require({"x": flat}, torch.int32, x.device)
    B, K = flat.shape[0], len(dst)
    chunk = chunk_plan(B, K, N, resident_ctas(ell, x.device))
    c = const_cache.device_bconv_consts(src, dst, x.device)
    out = torch.empty((B, K, N), dtype=torch.int32, device=x.device)
    config.before_launch("bconv")
    with native.on_device(x):
        err = native.lib("bconv").bconv_launch(
            flat.data_ptr(), c.q_src.data_ptr(), c.qhat_inv.data_ptr(),
            c.qhat_inv_shoup.data_ptr(), c.table_u32.data_ptr(), c.q_dst.data_ptr(),
            c.barrett.data_ptr(), out.data_ptr(), B, ell, K, N, chunk,
            native.stream_of(x))
    native.check("bconv", err, "bconv")
    config.count_launch("bconv", "bconvu")
    return out.reshape(*lead, K, N)
