"""Device-resident constant cache for NTT/BConv/permutation/scalar tables.

The port runs eagerly, so every ``torch.as_tensor(numpy_table, device=...)``
inside a transform would copy the table to the device again on *every call*.
This module stages each constant set exactly once per (key, device) — the
:class:`~repro_torch.core.ntt.NttConsts` of a (basis, N), the BConv tables of
a (src, dst), a Galois permutation, an ad-hoc scalar vector — and hands back
the same tensors on every later lookup.  :func:`stage_events` counts the
copies, so a test can assert the steady-state path makes none.

Host-side table *generation* stays in :mod:`repro_torch.core.rns` /
:mod:`repro_torch.core.ntt` (numpy + Python ints, lru-cached); this cache is
purely the numpy → device staging layer.  Residue tables are staged as int64
(the arithmetic type of :mod:`repro_torch.core.modmath`), index tables as
int64 (what ``index_select`` takes).  The exceptions are the kernels' own
operands, u32 bit patterns in int32 tensors: the four-step NTT tables
(:func:`device_four_step_consts`, half the bytes the kernel has to read), the
BConvU kernel's Shoup companions and table (:class:`BConvConsts`), the
affine Galois maps of the fused AutoU∘KS kernel
(:func:`device_galois_affine`) and the EFU's per-limb scalars with their
Shoup companions (:func:`device_efu_scalars`); the kernels' Barrett
constants ⌊2⁶⁴/q⌋ are int64 (:func:`device_barrett`).
"""
from __future__ import annotations

from typing import Any, Callable, Hashable, NamedTuple

import numpy as np
import torch

from . import ntt as nttm
from . import rns


class ConstCache:
    """Tiny keyed staging cache: builder() runs once per key.

    Bounded: once ``max_entries`` is reached the oldest entry is evicted
    (insertion order), so callers that key on runtime scalar values cannot
    grow it — and pin device buffers — without bound.
    """

    def __init__(self, max_entries: int = 4096) -> None:
        self._store: dict[Hashable, Any] = {}
        self.max_entries = max_entries

    def get(self, key: Hashable, builder: Callable[[], Any]) -> Any:
        out = self._store.get(key)
        if out is None:
            out = builder()
            if len(self._store) >= self.max_entries:
                self._store.pop(next(iter(self._store)))
            self._store[key] = out
        return out


_cache = ConstCache()
_stage_events = 0


def stage_events() -> int:
    """Monotonic count of host→device constant staging copies."""
    return _stage_events


def device_of(device) -> torch.device:
    """Normalize a device spec so "cuda" and "cuda:0" share cache entries."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _stage(x, device: torch.device, u32_bits: bool = False):
    """One host→device copy: int64 values, or with ``u32_bits`` the u32 bit
    patterns kept in int32 (values ≥ 2³¹ read negative)."""
    global _stage_events
    _stage_events += 1
    a = np.asarray(x)
    a = a.astype(np.uint32).view(np.int32) if u32_bits else a.astype(np.int64)
    return torch.as_tensor(a, device=device)


def device_table(key: Hashable, builder: Callable[[], Any], device,
                 u32_bits: bool = False) -> Any:
    """Stage an ad-hoc constant (numpy array or tuple of them) once per
    (key, device); the result is int64 tensors, or with ``u32_bits`` the u32
    bit patterns in int32 (a kernel operand; its key must differ from any
    int64 table's)."""
    dev = device_of(device)

    def stage():
        out = builder()
        if isinstance(out, tuple):
            return tuple(_stage(o, dev, u32_bits) for o in out)
        return _stage(out, dev, u32_bits)
    return _cache.get((key, str(dev)), stage)


def device_ntt_consts(basis: tuple[int, ...], N: int,
                      device) -> nttm.NttConsts:
    """Stacked NTT constants as device-resident int64 tensors, staged once."""
    return nttm.NttConsts(*device_table(
        ("ntt", tuple(basis), N),
        lambda: tuple(nttm.stacked_ntt_consts(tuple(basis), N)), device))


def device_four_step_consts(basis: tuple[int, ...], N: int, R: int,
                            device) -> nttm.FourStepConsts:
    """The four-step tables of (basis, N, R) as device tensors of u32 bits in
    int32, staged once per (basis, N, R, device)."""
    basis = tuple(basis)
    dev = device_of(device)

    def stage():
        fc = nttm.stacked_four_step_consts(basis, N, R)
        bits = lambda t: _stage(t, dev, u32_bits=True)
        return fc._replace(
            col=nttm.NttConsts(*(bits(t) for t in fc.col)),
            **{f: bits(getattr(fc, f)) for f in fc._fields
               if f not in ("R", "C", "col")})
    return _cache.get((("four_step", basis, N, R), str(dev)), stage)


def staged_bytes(kind: str, device) -> int:
    """Device bytes held by the staged entries of one kind ("four_step",
    "ntt", "bconv", ...) on ``device``."""
    dev = str(device_of(device))

    def nbytes(v):
        if isinstance(v, torch.Tensor):
            return v.numel() * v.element_size()
        if isinstance(v, tuple):
            return sum(nbytes(x) for x in v)
        return 0
    return sum(nbytes(v) for (key, d), v in _cache._store.items()
               if d == dev and key[0] == kind)


def device_q(basis: tuple[int, ...], device) -> torch.Tensor:
    """The primes of a basis as an (ℓ, 1) int64 column (no NTT tables)."""
    return device_table(("q", tuple(basis)),
                        lambda: np.array(basis, dtype=np.int64).reshape(-1, 1),
                        device)


class BConvConsts(NamedTuple):
    """Device-resident constants for one {src}→{dst} base conversion: int64
    columns for the plain version, u32 bits (int32) and Barrett constants
    for the BConvU kernel."""
    q_src: torch.Tensor           # (ℓ, 1) — source primes
    qhat_inv: torch.Tensor        # (ℓ, 1) — (Q/q_i)⁻¹ mod q_i
    table: torch.Tensor           # (K, ℓ) — Q/q_i mod p_j
    q_dst: torch.Tensor           # (K, 1) — destination primes
    qhat_inv_shoup: torch.Tensor  # (ℓ,) u32 bits — ⌊qhat_inv·2³²/q_i⌋
    table_u32: torch.Tensor       # (K, ℓ) u32 bits — the table
    barrett: torch.Tensor         # (K,) — ⌊2⁶⁴/p_j⌋


def barrett_consts(primes: tuple[int, ...]) -> np.ndarray:
    """⌊2⁶⁴/p⌋ per prime: the kernels' Barrett constant (common.cuh), < 2⁶³
    for every odd prime, so it fits an int64."""
    return np.array([(1 << 64) // p for p in primes], dtype=np.int64)


def device_bconv_consts(src: tuple[int, ...], dst: tuple[int, ...],
                        device) -> BConvConsts:
    """BConv tables staged once per (src, dst, device)."""
    src, dst = tuple(src), tuple(dst)
    dev = device_of(device)

    def stage():
        tab = rns.bconv_tables(src, dst)
        return BConvConsts(
            q_src=_stage(np.array(src).reshape(-1, 1), dev),
            qhat_inv=_stage(tab.qhat_inv.reshape(-1, 1), dev),
            table=_stage(tab.table, dev),
            q_dst=_stage(np.array(dst).reshape(-1, 1), dev),
            qhat_inv_shoup=_stage(tab.qhat_inv_shoup, dev, u32_bits=True),
            table_u32=_stage(tab.table, dev, u32_bits=True),
            barrett=_stage(barrett_consts(dst), dev))
    return _cache.get((("bconv", src, dst), str(dev)), stage)


def device_barrett(basis: tuple[int, ...], device) -> torch.Tensor:
    """⌊2⁶⁴/q⌋ per prime of a basis as an (ℓ,) int64, staged once."""
    return device_table(("barrett", tuple(basis)),
                        lambda: barrett_consts(tuple(basis)), device)


def device_efu_scalars(basis: tuple[int, ...], scalars: np.ndarray,
                       device) -> torch.Tensor:
    """The EFU's scale/subscale operand: (2, ℓ) u32 bits in int32, row 0 the
    scalars reduced mod their limb's prime (w_i), row 1 their Shoup
    companions ⌊w_i·2³²/q_i⌋; staged once per (basis, scalars, device).
    ``scalars`` is an (ℓ,) u32 array."""
    basis = tuple(basis)
    sv = np.asarray(scalars, dtype=np.uint32).reshape(-1)
    if sv.size != len(basis):
        raise ValueError(f"{sv.size} scalars for {len(basis)} primes")
    dev = device_of(device)

    def stage():
        w = [int(s) % q for s, q in zip(sv, basis)]
        return _stage(np.array([w, [rns.shoup(wi, q) for wi, q in zip(w, basis)]],
                               dtype=np.int64), dev, u32_bits=True)
    return _cache.get((("efu_scalars", basis, sv.tobytes()), str(dev)), stage)


def device_galois_perm(N: int, g: int, device) -> torch.Tensor:
    """Automorphism index vector perm_{N,g} as a device-resident (N,) int64."""
    def build():
        from . import poly
        return poly.automorphism_perm(N, g)
    return device_table(("galois_perm", N, g), build, device)


def device_galois_perm_stack(N: int, gs: tuple, device) -> torch.Tensor:
    """Stacked (R, N) int64 perm table for a rotation *set* — the operand of
    the multi-perm kernel and of the plain AutoU∘KS, staged once per (N, gs)."""
    def build():
        from . import poly
        return np.stack([poly.automorphism_perm(N, g) for g in gs])
    return device_table(("galois_perm_stack", N, tuple(gs)), build, device)


def device_galois_affine(N: int, gs: tuple, device) -> torch.Tensor:
    """The affine form of each Galois map of a rotation set, (R, 2) u32 bits
    in int32 — the fused AutoU∘KS kernel's operand, which computes
    perm[k] = (a·k + c) mod N from each row (a, c); staged once per (N, gs)."""
    dev = device_of(device)

    def stage():
        from . import poly
        return _stage(np.array([poly.galois_affine(N, g) for g in gs],
                               dtype=np.int64).reshape(-1, 2), dev, u32_bits=True)
    return _cache.get((("galois_affine", N, tuple(gs)), str(dev)), stage)
