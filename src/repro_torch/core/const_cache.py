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
int64 (what ``index_select`` takes).
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


def _stage(x, device: torch.device):
    global _stage_events
    _stage_events += 1
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


def device_table(key: Hashable, builder: Callable[[], Any], device) -> Any:
    """Stage an ad-hoc constant (numpy array or tuple of them) once per
    (key, device); the result is int64 tensors."""
    dev = device_of(device)

    def stage():
        out = builder()
        if isinstance(out, tuple):
            return tuple(_stage(o, dev) for o in out)
        return _stage(out, dev)
    return _cache.get((key, str(dev)), stage)


def device_ntt_consts(basis: tuple[int, ...], N: int,
                      device) -> nttm.NttConsts:
    """Stacked NTT constants as device-resident int64 tensors, staged once."""
    return nttm.NttConsts(*device_table(
        ("ntt", tuple(basis), N),
        lambda: tuple(nttm.stacked_ntt_consts(tuple(basis), N)), device))


def device_q(basis: tuple[int, ...], device) -> torch.Tensor:
    """The primes of a basis as an (ℓ, 1) int64 column (no NTT tables)."""
    return device_table(("q", tuple(basis)),
                        lambda: np.array(basis, dtype=np.int64).reshape(-1, 1),
                        device)


class BConvConsts(NamedTuple):
    """Device-resident constants for one {src}→{dst} base conversion."""
    q_src: torch.Tensor           # (ℓ, 1) — source primes
    qhat_inv: torch.Tensor        # (ℓ, 1) — (Q/q_i)⁻¹ mod q_i
    table: torch.Tensor           # (K, ℓ) — Q/q_i mod p_j
    q_dst: torch.Tensor           # (K, 1) — destination primes


def device_bconv_consts(src: tuple[int, ...], dst: tuple[int, ...],
                        device) -> BConvConsts:
    """BConv tables staged once per (src, dst, device)."""
    src, dst = tuple(src), tuple(dst)

    def build():
        tab = rns.bconv_tables(src, dst)
        return (np.array(src).reshape(-1, 1), tab.qhat_inv.reshape(-1, 1),
                tab.table, np.array(dst).reshape(-1, 1))
    return BConvConsts(*device_table(("bconv", src, dst), build, device))


def device_galois_perm(N: int, g: int, device) -> torch.Tensor:
    """Automorphism index vector perm_{N,g} as a device-resident (N,) int64."""
    def build():
        from . import poly
        return poly.automorphism_perm(N, g)
    return device_table(("galois_perm", N, g), build, device)


def device_galois_perm_stack(N: int, gs: tuple, device) -> torch.Tensor:
    """Stacked (R, N) int64 perm table for a rotation *set* — the operand of
    the multi-perm / fused AutoU∘KS kernels, staged once per (N, gs)."""
    def build():
        from . import poly
        return np.stack([poly.automorphism_perm(N, g) for g in gs])
    return device_table(("galois_perm_stack", N, tuple(gs)), build, device)
