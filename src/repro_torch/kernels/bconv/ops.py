"""BConvU: the HPS base conversion, q̂⁻¹ pre-scale and table product.

    BConv_{Q→P}(x)_j = Σ_i [x_i · q̂_i⁻¹]_{q_i} · (q̂_i mod p_j)   (mod p_j)

On CUDA tensors :func:`bconv` launches the kernel (``csrc/bconv.cu``), which
applies the pre-scale in registers and computes the table product in the same
pass.  :func:`bconv_grouped` runs G conversions of one source basis into G
consecutive slices of the destination primes in one launch: limb duplication
on the distributed engine's mesh, each limb cluster its own destination rows.
The plain versions, :func:`bconv_plain` and :func:`bconv_grouped_plain`, are
the pre-scale in torch (as in the reference's ``kernels/bconv/ops.py``)
followed by the table product :func:`bconv_matmul_plain`; they run for CPU
tensors and for the eager BConv engine on any device.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.core import const_cache
from repro_torch.core import modmath as mm
from repro_torch.kernels import config, native

#: Source primes the kernel takes at most.
MAX_ELL = 64
#: Destination primes a CTA takes at most by :func:`chunk_plan`: enough to
#: amortise the per-CTA re-read and pre-scale of its input.
PLAN_CHUNK = 16

_resident: dict[tuple[int, int], int] = {}
_dispatches: collections.Counter = collections.Counter()
_copies: collections.Counter = collections.Counter()


def tile_of(ell: int) -> int:
    """Coefficients of one row that a CTA of the kernel covers for ``ell``
    source primes: 256 threads × 4 coefficients up to ℓ = 16, × 2 up to 32,
    × 1 up to 64 (the held words stay at most 64 registers a thread)."""
    return 256 * (4 if ell <= 16 else 2 if ell <= 32 else 1)


def chunk_plan(B: int, K: int, N: int, resident: int, tile: int = 1024) -> int:
    """Destination primes per CTA: an even share of the K primes over as many
    splits as one wave of ``resident`` CTAs holds (⌈N / tile⌉ · B CTAs a
    split), but at least ⌈K / PLAN_CHUNK⌉ splits.  The kernel is bound by its
    multiply-adds, so the grid should fill whole waves: a partial last wave
    leaves SMs idle."""
    tiles = max(1, B * -(-N // tile))
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


def dispatch_counts() -> dict:
    """Calls of :func:`bconv` and :func:`bconv_grouped` (on any device) since
    the last :func:`reset_dispatch_counts`: the launches the card makes for
    them, counted on the CPU too."""
    return dict(_dispatches)


def reset_dispatch_counts() -> None:
    _dispatches.clear()


def copy_counts() -> dict:
    """Operands the kernel wrapper copied because their batch dims flatten to
    no single stride, since the last :func:`reset_copy_counts`."""
    return dict(_copies)


def reset_copy_counts() -> None:
    _copies.clear()


def bconv(x: torch.Tensor, src: tuple[int, ...], dst: tuple[int, ...]) -> torch.Tensor:
    """(…, ℓ, N) coeff-domain residues in ``src`` → (…, K, N) in ``dst``.

    All leading dims are the kernel's batch; the CUDA kernel runs for CUDA
    tensors, the plain version for CPU tensors.
    """
    return bconv_grouped(x.unsqueeze(0), src, dst)[0]


def bconv_grouped(x: torch.Tensor, src: tuple[int, ...],
                  dst: tuple[int, ...]) -> torch.Tensor:
    """(G, …, ℓ, N) residues in ``src`` → (G, …, K/G, N): group g converted
    into ``dst[g·K/G : (g+1)·K/G]``, all groups in one launch on CUDA
    tensors, the plain version for CPU tensors."""
    _dispatches["bconv"] += 1
    if native.on_cuda(x):
        return bconv_grouped_cuda(x, tuple(src), tuple(dst))
    return bconv_grouped_plain(x, tuple(src), tuple(dst))


def bconv_plain(x: torch.Tensor, src: tuple[int, ...],
                dst: tuple[int, ...]) -> torch.Tensor:
    """The whole BConv in plain torch on any device (the eager engine)."""
    c = const_cache.device_bconv_consts(tuple(src), tuple(dst), x.device)
    t = mm.mulmod(x, c.qhat_inv, c.q_src).to(torch.int32)
    lead, (ell, N) = t.shape[:-2], t.shape[-2:]
    out = bconv_matmul_plain(t.reshape(-1, ell, N), c.table, c.q_dst)
    return out.reshape(*lead, len(dst), N)


def bconv_grouped_plain(x: torch.Tensor, src: tuple[int, ...],
                        dst: tuple[int, ...]) -> torch.Tensor:
    """:func:`bconv_grouped` in plain torch: :func:`bconv_plain` per group."""
    dst = tuple(dst)
    G = x.shape[0]
    k = _group_size(G, len(dst))
    return torch.stack([bconv_plain(x[g], src, dst[g * k:(g + 1) * k])
                        for g in range(G)])


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


def _group_size(G: int, K: int) -> int:
    if G < 1 or K % G:
        raise ValueError(f"bconv: {K} destination primes do not split into {G} groups")
    return K // G


def batch_layout(x: torch.Tensor) -> tuple[int, int, int, int] | None:
    """(Bg, group stride, batch stride, limb stride) in words of a
    (G, …, ℓ, N) operand that the kernel reads in place: its leading dims
    after the group flatten to one strided batch of Bg rows and each row's
    N words are contiguous.  None when it must be copied."""
    G, *lead, ell, N = x.shape
    sg, *lead_strides, si, sn = x.stride()
    if N > 1 and sn != 1:
        return None
    Bg, sb = 1, ell * N
    for size, st in reversed(list(zip(lead, lead_strides))):
        if size == 1:
            continue
        if Bg == 1:
            sb = st
        elif st != sb * Bg:
            return None
        Bg *= size
    return Bg, (sg if G > 1 else 0), sb, si


def bconv_grouped_cuda(x: torch.Tensor, src: tuple[int, ...],
                       dst: tuple[int, ...]) -> torch.Tensor:
    """Launch the BConvU kernel (``csrc/bconv.cu``) on the current stream:
    G whole BConvs of canonical residues ``x`` (G, …, ℓ, N) in one pass, the
    operand read through its strides (a group stride of 0 for a replicated
    operand), :func:`chunk_plan`'s destination primes per CTA."""
    src, dst = tuple(src), tuple(dst)
    G, lead, (ell, N) = x.shape[0], x.shape[1:-2], x.shape[-2:]
    if ell != len(src):
        raise ValueError(f"bconv: {ell} limbs for {len(src)} source primes")
    if not 1 <= ell <= MAX_ELL:
        raise ValueError(f"bconv: {ell} source primes, the kernel takes 1 … {MAX_ELL}")
    k = _group_size(G, len(dst))
    native.require({"x": x}, torch.int32, x.device, contiguous=False)
    layout = batch_layout(x)
    if layout is None:
        _copies["bconv"] += 1
        x = (x[:1].contiguous().expand(x.shape) if x.stride(0) == 0
             else x.contiguous())
        layout = batch_layout(x)
    Bg, sg, sb, si = layout
    out = torch.empty((G, *lead, k, N), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    chunk = chunk_plan(G * Bg, k, N, resident_ctas(ell, x.device), tile_of(ell))
    c = const_cache.device_bconv_consts(src, dst, x.device)
    config.before_launch("bconv")
    with native.on_device(x):
        err = native.lib("bconv").bconv_launch(
            x.data_ptr(), c.q_src.data_ptr(), c.qhat_inv.data_ptr(),
            c.qhat_inv_shoup.data_ptr(), c.table_u32.data_ptr(), c.q_dst.data_ptr(),
            c.barrett.data_ptr(), out.data_ptr(), G, Bg, ell, k, N, chunk, sg, sb,
            si, native.stream_of(x))
    native.check("bconv", err, "bconv")
    config.count_launch("bconv", "bconvu", device=x.device)
    return out


def bconv_cuda(x: torch.Tensor, src: tuple[int, ...], dst: tuple[int, ...]) -> torch.Tensor:
    """The kernel on one group: :func:`bconv_grouped_cuda` at G = 1."""
    return bconv_grouped_cuda(x.unsqueeze(0), src, dst)[0]
