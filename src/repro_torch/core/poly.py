"""RNS polynomial container and element-wise ring arithmetic.

An :class:`RnsPoly` holds the (ℓ × N) residue matrix of one element of
R_{Q_ℓ} (paper §II-B): row *i* is the limb mod ``basis[i]``.  ``domain`` is
either ``"coeff"`` (power basis) or ``"ntt"`` (evaluations at ψ^{2k+1},
natural order).  Ciphertexts stack two polys on a leading axis.

Residues are int32 torch tensors (every prime is < 2³⁰, so the u32 bits of
the reference are the same non-negative numbers).  On CUDA data the ring ops
(add, sub, neg, mul, mul_scalar and the fused :meth:`RnsPoly.sub_scaled`) run
the EFU kernel (:mod:`repro_torch.kernels.eltwise`), int32 in and out; on CPU
data they run in int64 through :mod:`repro_torch.core.modmath`.  Per-limb
constants come device-resident from :mod:`repro_torch.core.const_cache`.
The samplers are host-side numpy on the reference's ``default_rng`` call
sequence, so the same seed gives byte-identical key material.

On CUDA data the NTT, the iNTT and the automorphism run the hand-written
kernels (:mod:`repro_torch.kernels.ntt`, the single-permutation kernel of
:mod:`repro_torch.kernels.automorphism`); on CPU data they run the fused plain
transform and ``index_select``, as the reference's ``RnsPoly`` does.  Both
give the same canonical residues.  Under an active
:class:`~repro_torch.core.distributed.dist_scope` the NTT, the iNTT and the
automorphism by a Galois element dispatch to the sharded engine instead (the
trace is recorded first, then the dispatch, as the reference does).  There
``data`` may be a :class:`~repro_torch.core.parts.Parts` (a mesh split over
several devices): the ring ops and limb slicing run on each part on its own
device, and a multi-part value has ``devices``, not one ``device``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import const_cache
from . import guards
from . import modmath as mm
from . import ntt as nttm
from . import parts as _parts
from . import trace
from repro_torch.kernels import native
from repro_torch.kernels.automorphism import ops as auto_ops
from repro_torch.kernels.eltwise import ops as elt_ops
from repro_torch.kernels.ntt import ops as ntt_ops

COEFF = "coeff"
NTT = "ntt"


def consts(basis: tuple[int, ...], N: int, device) -> nttm.NttConsts:
    """Per-limb NTT constants, staged to ``device`` once per (basis, N)."""
    return const_cache.device_ntt_consts(tuple(basis), N, device)


def to_tensor(residues: np.ndarray, device) -> torch.Tensor:
    """u32 (or int32) numpy residues → int32 tensor on ``device``."""
    a = np.ascontiguousarray(residues)
    if a.dtype != np.int32:
        a = a.astype(np.uint32).view(np.int32)
    return torch.as_tensor(a, device=device)


def to_numpy(data: torch.Tensor) -> np.ndarray:
    """int32 residue tensor (or the parts of one) → u32 numpy array on the
    host."""
    if isinstance(data, _parts.Parts):
        data = _parts.join(data, "cpu")
    return data.detach().cpu().contiguous().numpy().view(np.uint32)


def _ring_op(op: str, basis: tuple[int, ...], scalars, *datas: torch.Tensor):
    """One ring op on plain tensors of one device: the EFU kernel on card
    data (operands of different shapes broadcast as on the CPU: the smaller
    one, an evk digit against a batch of digit extensions, is expanded to a
    stride-0 view, which the kernel reads in place), int64 modmath on the
    CPU, int32 out."""
    if native.on_cuda(*datas):
        shape = torch.broadcast_shapes(*(d.shape for d in datas))
        datas = [d if d.shape == shape else d.expand(shape) for d in datas]
        return elt_ops.eltwise_cuda(op, basis, *datas, scalars=scalars)
    q = const_cache.device_q(basis, datas[0].device)
    if op == "subscale":
        return _ring_op("scale", basis, scalars, _ring_op("sub", basis, None, *datas))
    if op == "scale":
        sv = np.asarray(scalars, dtype=np.uint32).reshape(-1)
        w = const_cache.device_table(("mul_scalar", basis, sv.tobytes()),
                                     lambda: sv.reshape(-1, 1), datas[0].device)
        return mm.mulmod(datas[0], w, q).to(torch.int32)
    fn = {"add": mm.addmod, "sub": mm.submod, "mul": mm.mulmod,
          "neg": mm.negmod}[op]
    return fn(*datas, q).to(torch.int32)


@dataclasses.dataclass
class RnsPoly:
    """(..., ℓ, N) int32 residues. ``basis`` is the tuple of primes, one per limb."""
    data: torch.Tensor
    basis: tuple[int, ...]
    domain: str

    @property
    def N(self) -> int:
        return self.data.shape[-1]

    @property
    def ell(self) -> int:
        return len(self.basis)

    @property
    def device(self) -> torch.device:
        """The device of the residues.  A value split over several devices
        (:class:`~repro_torch.core.parts.Parts`) has none and raises
        ``PartsError``: read :attr:`devices`."""
        return self.data.device

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """The devices of the residues' parts, in order (one for a tensor)."""
        return _parts.devices_of(self.data)

    def c(self) -> nttm.NttConsts:
        return consts(self.basis, self.N, self.data.device)

    def _q(self) -> torch.Tensor:
        return const_cache.device_q(self.basis, self.data.device)

    # -- domain conversion ---------------------------------------------------
    def to_ntt(self) -> "RnsPoly":
        if self.domain == NTT:
            return self
        trace.record("ntt", int(np.prod(self.data.shape[:-1])), self.N)
        from . import distributed as dist  # lazy: distributed imports bconv
        ctx = dist.dist_active()
        if ctx is not None:
            return RnsPoly(dist.sharded_ntt(ctx, self.data, self.basis, True),
                           self.basis, NTT)
        if native.on_cuda(self.data):
            return RnsPoly(ntt_ops.ntt_fwd(self.data, self.basis), self.basis, NTT)
        return RnsPoly(nttm.ntt(self.data, self.c()), self.basis, NTT)

    def to_coeff(self) -> "RnsPoly":
        if self.domain == COEFF:
            return self
        trace.record("intt", int(np.prod(self.data.shape[:-1])), self.N)
        from . import distributed as dist
        ctx = dist.dist_active()
        if ctx is not None:
            return RnsPoly(dist.sharded_ntt(ctx, self.data, self.basis, False),
                           self.basis, COEFF)
        if native.on_cuda(self.data):
            return RnsPoly(ntt_ops.ntt_inv(self.data, self.basis), self.basis, COEFF)
        return RnsPoly(nttm.intt(self.data, self.c()), self.basis, COEFF)

    # -- ring ops (domain-agnostic element-wise; mul requires NTT) -----------
    def _check_aligned(self, o: "RnsPoly", op: str) -> None:
        """Typed basis/domain mismatch (guards on) instead of a bare assert."""
        guards.check_basis_match(self.basis, o.basis, f"RnsPoly.{op}")
        if guards.active() and self.domain != o.domain:
            raise guards.BasisMismatch(
                f"RnsPoly.{op}: domain mismatch {self.domain} vs {o.domain}")

    def _ring(self, op: str, *others: "RnsPoly", scalars=None,
              domain: str | None = None) -> "RnsPoly":
        """``op`` on the operands' residues (:func:`_ring_op`), part by part
        on a multi-part value, whose operands must hold the same parts; a
        part split over the grid's rows takes its row's moduli and scalars."""
        def part(limbs: slice, *datas):
            return _ring_op(op, self.basis[limbs],
                            None if scalars is None else scalars[limbs], *datas)
        data = _parts.zip_limbs(part, self.data, *(o.data for o in others))
        return RnsPoly(data, self.basis, domain or self.domain)

    def __add__(self, o: "RnsPoly") -> "RnsPoly":
        self._check_aligned(o, "add")
        assert self.basis == o.basis and self.domain == o.domain
        return self._ring("add", o)

    def __sub__(self, o: "RnsPoly") -> "RnsPoly":
        self._check_aligned(o, "sub")
        assert self.basis == o.basis and self.domain == o.domain
        return self._ring("sub", o)

    def __neg__(self) -> "RnsPoly":
        return self._ring("neg")

    def __mul__(self, o: "RnsPoly") -> "RnsPoly":
        self._check_aligned(o, "mul")
        assert self.basis == o.basis
        assert self.domain == NTT and o.domain == NTT, "mul requires NTT domain"
        trace.record("elt_mul", int(np.prod(self.data.shape[:-1])), self.N)
        return self._ring("mul", o, domain=NTT)

    def mul_scalar(self, scalars: np.ndarray) -> "RnsPoly":
        """Multiply limb i by the constant ``scalars[i]``.

        The scalar column is staged once per (basis, scalars, device) —
        rescale/ModDown reuse the same vector every call: on card data with
        its Shoup companions for the EFU's ``scale``, on the CPU as an (ℓ, 1)
        int64 column.
        """
        return self._ring("scale", scalars=scalars)

    def sub_scaled(self, o: "RnsPoly", scalars: np.ndarray) -> "RnsPoly":
        """(self − o) · scalars[i] on limb i: the tail of ModDown and of
        rescale.  One EFU ``subscale`` launch on card data;
        ``(self − o).mul_scalar(scalars)`` on the CPU."""
        self._check_aligned(o, "sub_scaled")
        assert self.basis == o.basis and self.domain == o.domain
        return self._ring("subscale", o, scalars=scalars)

    # -- structure ------------------------------------------------------------
    def limbs(self, idx: slice) -> "RnsPoly":
        """Sub-poly restricted to a contiguous slice of limbs (on a grid of
        several rows, regrouped between them: :func:`take_limbs`)."""
        if _parts.rows_of(self.data) > 1:
            return RnsPoly(take_limbs([self.data], range(self.ell)[idx]),
                           self.basis[idx], self.domain)
        return RnsPoly(self.data[..., idx, :], self.basis[idx], self.domain)

    def automorphism(self, perm: torch.Tensor) -> "RnsPoly":
        """Apply φ as an NTT-domain index permutation (natural order);
        ``perm`` is an int64 index tensor on the data's device."""
        assert self.domain == NTT
        trace.record("auto", int(np.prod(self.data.shape[:-1])), self.N)
        return RnsPoly(auto_ops.automorphism(self.data, perm), self.basis, NTT)

    def automorphism_by_gelt(self, g: int) -> "RnsPoly":
        """φ_g via the device-staged perm table — zero per-call uploads.
        Under a :class:`~repro_torch.core.distributed.dist_scope` the
        slot-parallel sharded automorphism."""
        from . import distributed as dist
        ctx = dist.dist_active()
        if ctx is not None:
            assert self.domain == NTT
            trace.record("auto", int(np.prod(self.data.shape[:-1])), self.N)
            return RnsPoly(dist.sharded_galois(ctx, self.data, self.N, g),
                           self.basis, NTT)
        return self.automorphism(
            const_cache.device_galois_perm(self.N, g, self.device))


def take_limbs(datas, idx):
    """The limbs ``idx`` of residue tensors concatenated along the limb axis,
    on a mesh's grid of several rows: ``Mesh.regroup`` of the active scope,
    into a value split over the rows when its limbs split over the limb
    clusters and some operand is split, else replicated (every part then
    reads its own part: a local slice)."""
    from . import distributed as dist
    mesh = dist._require().mesh
    idx = list(idx)
    split = mesh.split_rows(len(idx)) and any(d.split for d in datas)
    return mesh.regroup(datas, idx, split)


# ----------------------------------------------------------------------------
# Automorphism index maps (paper §II-C) — natural-order NTT domain.
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def automorphism_perm(N: int, g: int) -> np.ndarray:
    """perm[k] = k' s.t. (φ_g m)(ψ^{2k+1}) = m̂[k'], i.e. 2k'+1 = (2k+1)·g mod 2N."""
    k = np.arange(N, dtype=np.int64)
    return ((((2 * k + 1) * g) % (2 * N) - 1) // 2).astype(np.int32)


def galois_affine(N: int, g: int) -> tuple[int, int]:
    """(a, c) with automorphism_perm(N, g)[k] = (a·k + c) mod N, for odd g and
    a power-of-two N: 2k' + 1 = (2k + 1)·g mod 2N gives k' = g·k + (g − 1)/2
    mod N.  Both are reduced mod N, so 32-bit arithmetic that wraps mod 2³²
    (a multiple of N) computes the map."""
    if g % 2 == 0 or N < 1 or N & (N - 1):
        raise ValueError(f"Galois element {g} at N = {N}: needs an odd g and "
                         f"a power-of-two N")
    return g % N, (g - 1) // 2 % N


@functools.lru_cache(maxsize=None)
def automorphism_perm_coeff(N: int, g: int) -> tuple[np.ndarray, np.ndarray]:
    """Coefficient-domain map: X^j → ±X^{j·g mod N}; returns (dst index, sign flip)."""
    j = np.arange(N, dtype=np.int64)
    t = (j * g) % (2 * N)
    return (t % N).astype(np.int32), (t >= N)


def galois_elt(r: int, N: int) -> int:
    """Galois element for slot rotation by r (5^r mod 2N); r may be negative."""
    M = 2 * N
    return pow(5, r % (N // 2), M)


CONJ_GELT = -1  # sentinel: conjugation uses g = 2N - 1


def apply_automorphism_coeff(data: np.ndarray, N: int, g: int,
                             q: np.ndarray) -> np.ndarray:
    """Host-side coefficient-domain automorphism with negacyclic signs."""
    dst, flip = automorphism_perm_coeff(N, g)
    out = np.zeros_like(data)
    vals = np.where(flip, (q.reshape(-1, 1) - data) % q.reshape(-1, 1), data)
    out[..., dst] = vals
    return out


# ----------------------------------------------------------------------------
# Sampling (host-side numpy; keys and encryption randomness)
# ----------------------------------------------------------------------------

def uniform_poly(rng: np.random.Generator, basis: tuple[int, ...], N: int,
                 domain: str = NTT, device="cuda") -> RnsPoly:
    data = np.stack([rng.integers(0, q, N, dtype=np.int64).astype(np.uint32)
                     for q in basis])
    return RnsPoly(to_tensor(data, device), basis, domain)


def small_to_rns(small: np.ndarray, basis: tuple[int, ...]) -> np.ndarray:
    """Signed small integer vector → (ℓ, N) u32 residues."""
    return np.stack([(small.astype(np.int64) % q).astype(np.uint32) for q in basis])


def gaussian_poly(rng: np.random.Generator, basis: tuple[int, ...], N: int,
                  sigma: float = 3.2, device="cuda") -> RnsPoly:
    e = np.round(rng.normal(0.0, sigma, N)).astype(np.int64)
    return RnsPoly(to_tensor(small_to_rns(e, basis), device), basis, COEFF)


def ternary_secret(rng: np.random.Generator, N: int,
                   hamming: int | None = None) -> np.ndarray:
    """Ternary secret in {-1, 0, 1}^N.

    ``hamming=None`` → uniform ternary (non-sparse keys, paper Table I [11]);
    otherwise exactly ``hamming`` nonzeros (sparse secrets for bootstrapping's
    EvalMod range).
    """
    if hamming is None:
        return rng.integers(-1, 2, N, dtype=np.int64).astype(np.int8)
    s = np.zeros(N, dtype=np.int8)
    idx = rng.choice(N, size=hamming, replace=False)
    s[idx] = rng.choice(np.array([-1, 1], dtype=np.int8), size=hamming)
    return s
