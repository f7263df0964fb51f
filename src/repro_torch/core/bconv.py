"""Fast base conversion (BConv) and the ModUp/ModDown legs of key-switching.

    BConv_{Q→P}(x)_j = Σ_i [x_i · q̂_i⁻¹]_{q_i} · (q̂_i mod p_j)   (mod p_j)

HPS-style, as the reference: the result may carry +u·Q for small u ≤ ℓ/2
(no fractional correction), absorbed by the key-switching noise budget.

Engine selection, as the reference's ``core/bconv.py``:

* ``"kernel"`` (default) — :func:`bconv_raw` goes through the BConvU wrapper
  (:mod:`repro_torch.kernels.bconv.ops`): the CUDA kernel for CUDA tensors,
  its plain version for CPU tensors, all leading dims in one launch.
* ``"eager"`` — :func:`bconv_raw_eager`, the plain torch BConv on any device
  (the parity baseline).

Under a :class:`mapping_scope` (either engine) every BConv runs on the
scope's mesh under its policy (``distributed.mapped_bconv``), as the
reference's sharding constraints lay it out at paper scale
(``launch/dryrun_fhe.py``).
"""
from __future__ import annotations

import contextvars
import functools

import numpy as np
import torch

from repro_torch.kernels.bconv import ops as bconv_ops

from . import const_cache
from . import parts as _parts
from . import poly as pl
from . import trace

_ENGINES = ("kernel", "eager")
_engine = "kernel"


def get_engine() -> str:
    return _engine


def set_engine(name: str) -> None:
    """Select the BConv engine globally ("kernel" | "eager")."""
    global _engine
    if name not in _ENGINES:
        raise ValueError(f"unknown BConv engine {name!r} — one of {_ENGINES}")
    _engine = name


class use_engine:
    """Context manager pinning the BConv engine (parity tests, benchmarks)."""

    def __init__(self, name: str):
        if name not in _ENGINES:
            raise ValueError(f"unknown BConv engine {name!r} — one of {_ENGINES}")
        self.name = name

    def __enter__(self):
        self._saved = _engine
        set_engine(self.name)
        return self

    def __exit__(self, *exc):
        set_engine(self._saved)
        return False


# ----------------------------------------------------------------------------
# Distribution policy hook (paper §IV/§V)
# ----------------------------------------------------------------------------

_active_policy: contextvars.ContextVar = contextvars.ContextVar("bconv_policy",
                                                                default=None)


class mapping_scope:
    """Run every BConv on ``mesh`` (a one-part ``distributed.Mesh``, on the
    operands' device) under ``policy`` (``distributed.ARK_POLICY`` or
    ``LIMBDUP_POLICY``) inside the block."""

    def __init__(self, mesh, policy):
        self.value = (mesh, policy)

    def __enter__(self):
        self._tok = _active_policy.set(self.value)
        return self

    def __exit__(self, *exc):
        _active_policy.reset(self._tok)
        return False


def policy_active() -> bool:
    """True when a ``mapping_scope`` is active (the CKKS ops then take the
    eager decomposition, whose BConvs the scope maps)."""
    return _active_policy.get() is not None


def _record(x, src, dst):
    count = int(np.prod(x.shape[:-2])) if x.dim() > 2 else 1
    trace.record("bconv_mul", len(src) * len(dst), x.shape[-1], count)
    trace.record("bconv_in", len(src), x.shape[-1], count)
    trace.record("bconv_out", len(dst), x.shape[-1], count)


def bconv_raw(x: torch.Tensor, src: tuple[int, ...],
              dst: tuple[int, ...]) -> torch.Tensor:
    """(…, ℓ, N) coeff-domain residues in ``src`` → (…, K, N) in ``dst``.
    Under an active ``dist_scope`` the mesh-mapped BConv, under a
    ``mapping_scope`` the policy's (either engine)."""
    from . import distributed as dist  # lazy: distributed imports this module
    ctx = dist.dist_active()
    if ctx is not None:
        _record(x, src, dst)
        return dist.sharded_bconv(ctx, x, tuple(src), tuple(dst))
    scope = _active_policy.get()
    if scope is not None:
        _record(x, src, dst)
        return dist.mapped_bconv(scope[0], scope[1], x, tuple(src), tuple(dst))
    if _engine == "eager":
        return bconv_raw_eager(x, src, dst)
    _record(x, src, dst)
    return bconv_ops.bconv(x, tuple(src), tuple(dst))


def bconv_raw_eager(x: torch.Tensor, src: tuple[int, ...],
                    dst: tuple[int, ...]) -> torch.Tensor:
    """The plain torch BConv (parity baseline), on whatever device x is."""
    _record(x, src, dst)
    return bconv_ops.bconv_plain(x, tuple(src), tuple(dst))


def bconv(x: pl.RnsPoly, dst: tuple[int, ...]) -> pl.RnsPoly:
    assert x.domain == pl.COEFF, "BConv operates on coefficient-domain limbs"
    return pl.RnsPoly(bconv_raw(x.data, x.basis, dst), tuple(dst), pl.COEFF)


def centered_lift_single(x: torch.Tensor, src_q: int,
                         dst: tuple[int, ...]) -> torch.Tensor:
    """Exact centered lift of a *single-limb* residue vector into ``dst``.

    Values in [0, q₁) are centered to (-q₁/2, q₁/2] and embedded exactly mod
    each dst prime.  x: (…, N) int32 → (…, K, N) int32, vectorized over the
    dst axis with a staged (K, 1) prime column; position-wise, so on each
    part of a multi-part value.
    """
    def lift(t: torch.Tensor) -> torch.Tensor:
        pv = const_cache.device_q(tuple(dst), t.device)
        xe = t[..., None, :].to(torch.int64)           # (…, 1, N) vs (K, 1)
        is_neg = xe > src_q // 2                       # maps to negative lift
        pos = xe % pv
        neg_mag = (src_q - xe) % pv                    # |value| when negative
        neg = torch.where(neg_mag == 0, neg_mag, pv - neg_mag)
        return torch.where(is_neg, neg, pos).to(torch.int32)
    return _parts.on_each(x, lift)


# ----------------------------------------------------------------------------
# ModUp / ModDown (hybrid key-switching legs, Han-Ki [36])
# ----------------------------------------------------------------------------

def mod_up_digit(digit: pl.RnsPoly, full_q: tuple[int, ...],
                 p: tuple[int, ...],
                 digit_ntt: pl.RnsPoly | None = None) -> pl.RnsPoly:
    """Digit limbs (coeff domain, basis Q_j) → basis Q_ℓ ∪ P (NTT domain).

    Limbs already present in Q_j are reused from ``digit_ntt`` (the original
    NTT-domain data) — only the BConv-produced limbs pay an NTT.  The output
    limb order is q₁..q_ℓ then p₁..p_K, assembled by one staged index
    permutation over [digit | conv].
    """
    dst_other = tuple(q for q in full_q if q not in digit.basis) + tuple(p)
    conv = bconv_raw(digit.data, digit.basis, dst_other)
    conv_ntt = pl.RnsPoly(conv, dst_other, pl.COEFF).to_ntt()
    if digit_ntt is None:
        digit_ntt = digit.to_ntt()
    nd = len(digit.basis)

    def build_perm():
        order = []
        it = iter(range(len(dst_other)))
        for q in full_q:
            order.append(digit.basis.index(q) if q in digit.basis
                         else nd + next(it))
        for _ in p:
            order.append(nd + next(it))
        return np.array(order, dtype=np.int64)

    basis = tuple(full_q) + tuple(p)
    if _parts.rows_of(conv_ntt.data) > 1:     # a grid: regroup between its rows
        return pl.RnsPoly(pl.take_limbs([digit_ntt.data, conv_ntt.data],
                                        build_perm()), basis, pl.NTT)
    key = ("modup_perm", digit.basis, tuple(full_q), tuple(p))
    stacked = torch.cat([digit_ntt.data, conv_ntt.data], dim=-2)
    return pl.RnsPoly(_parts.on_each(stacked, lambda t: t.index_select(
        -2, const_cache.device_table(key, build_perm, t.device))), basis, pl.NTT)


def mod_down(x: pl.RnsPoly, q_basis: tuple[int, ...],
             p: tuple[int, ...]) -> pl.RnsPoly:
    """⌊x / P⌉ : basis Q∪P (NTT domain) → basis Q (NTT domain).

    The P-part (iNTT → BConv into Q → NTT) is subtracted, then the result is
    multiplied by P⁻¹ mod q_i (one EFU ``subscale`` launch on card data, which
    reads the Q-part of ``x`` in place).  Leading dims of ``x`` ride through
    every step — including the BConv kernel's batch — in one dispatch.
    """
    ellq = len(q_basis)
    assert x.basis == tuple(q_basis) + tuple(p) and x.domain == pl.NTT
    xq, xp = x.limbs(slice(None, ellq)), x.limbs(slice(ellq, None))
    xp_in_q = bconv(xp.to_coeff(), tuple(q_basis)).to_ntt()
    return xq.sub_scaled(xp_in_q, _moddown_pinv(tuple(q_basis), tuple(p)))


@functools.lru_cache(maxsize=None)
def _moddown_pinv(q_basis: tuple[int, ...], p: tuple[int, ...]) -> np.ndarray:
    """P⁻¹ mod q_i for the ModDown division — one host build per basis pair."""
    P = 1
    for pi in p:
        P *= pi
    return np.array([pow(P % q, q - 2, q) for q in q_basis], dtype=np.uint32)
