"""Frozen work model: the least work each batched HE op needs, and the
least time the card could take for it.

The NTT-limb and BConv-MAC counts are a copy of the program's virtual
executor (``repro_torch.workloads.virtual``: ``mod_up``, ``ks_inner``,
``hmult``, ``rescale``, ``hrot``, ``pmult``, ``hadd``), frozen here so the
yardstick cannot move with the program; ``fhebench/tests`` holds the copy
to the executor at test sizes.  The work is counted from the HE ops the
requests ran, at their levels and batch sizes, never from launches, so a
roofline reads the same work whatever kernels implement it.

Least time = max(bytes / peak bandwidth, operations / peak rate), with
each input read once and each output written once (32-bit words), as in
the kernel table of ``PERF.md``.  An operation is one modular multiply:
one per NTT butterfly, per BConv multiply-accumulate, per elementwise
product.  Key-switching keys are the PRNG form of the paper (§V-B): only
the b-halves are read, once per group, since every request of a keyed
group shares its tenant's key.
"""
from __future__ import annotations

import dataclasses
import math

# NVIDIA H100 SXM5 80 GB data sheet: HBM3 bandwidth, and the FP32 rate
# outside the tensor cores, the rule the port's kernel table uses.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "ops_per_s": 67e12}}
WORD_BYTES = 4


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no peak rates for the device {kind!r}: add them to "
                       f"fhebench/work/model.py's PEAKS")
    return PEAKS[kind]


@dataclasses.dataclass
class Work:
    """Counts of one or more dispatches; ``add`` sums them."""
    ntt_limbs: float = 0.0           # single-limb forward + inverse NTTs
    bconv_macs: float = 0.0          # Σ src·dst·N over every BConv
    bconv_words: float = 0.0         # Σ (src + dst)·N
    ks_macs: float = 0.0             # rotations' key inner products (AutoU∘KS)
    ks_words: float = 0.0            # their digits, key b-halves, outputs
    perm_words: float = 0.0          # b-half automorphisms, in + out
    elt_mults: float = 0.0           # other elementwise products, words
    io_words: float = 0.0            # HE-op inputs, outputs, keys, plaintexts

    def add(self, other: "Work") -> "Work":
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))
        return self


@dataclasses.dataclass(frozen=True)
class Params:
    N: int
    L: int
    K: int
    dnum: int
    rescale_primes: int

    @property
    def alpha(self) -> int:
        return -(-self.L // self.dnum)

    def digits(self, ell: int) -> int:
        return -(-ell // self.alpha)

    @classmethod
    def of(cls, config: dict) -> "Params":
        return cls(config["N"], config["L"], config["K"], config["dnum"],
                   config["rescale_primes"])


def _mod_up(p: Params, ell: int, w: Work, B: int) -> None:
    """Decompose + ModUp of one poly: iNTT ℓ, per digit BConv + NTT."""
    w.ntt_limbs += ell * B
    for j in range(p.digits(ell)):
        src = min(p.alpha, ell - j * p.alpha)
        dst = ell - src + p.K
        _bconv(p, src, dst, w, B)
        w.ntt_limbs += dst * B


def _bconv(p: Params, src: int, dst: int, w: Work, B: int) -> None:
    w.bconv_macs += src * dst * p.N * B
    w.bconv_words += (src + dst) * p.N * B


def _mod_down_pair(p: Params, ell: int, w: Work, B: int) -> None:
    """ModDown of the two key-switch outputs: iNTT K, BConv K→ℓ, NTT ℓ,
    subtract and scale by P⁻¹."""
    for _ in range(2):
        w.ntt_limbs += (p.K + ell) * B
        _bconv(p, p.K, ell, w, B)
        w.elt_mults += 2 * ell * p.N * B


def _key_words(p: Params, ell: int) -> int:
    return p.digits(ell) * (ell + p.K) * p.N


def op_work(p: Params, kind: str, ell: int, B: int, arg=None,
            plaintexts: int = 0) -> Work:
    """Work of one group of ``B`` requests running ``kind`` at level ℓ.
    ``plaintexts``: distinct plaintexts a pmult group reads."""
    w = Work()
    N = p.N
    ct = 2 * ell * N                                 # words of one ciphertext
    if kind == "hmult":
        w.elt_mults += 4 * ell * N * B               # tensor product
        _mod_up(p, ell, w, B)
        d = p.digits(ell)
        w.elt_mults += 2 * (ell + p.K) * d * N * B   # relin inner product
        _mod_down_pair(p, ell, w, B)
        w.io_words += 3 * ct * B + _key_words(p, ell)
    elif kind == "hrot":
        _mod_up(p, ell, w, B)
        d = p.digits(ell)
        w.ks_macs += 2 * (ell + p.K) * d * N * B
        w.ks_words += (d * (ell + p.K) + 2 * (ell + p.K)) * N * B \
            + _key_words(p, ell)
        w.perm_words += 2 * ell * N * B
        _mod_down_pair(p, ell, w, B)
        w.io_words += 2 * ct * B + _key_words(p, ell)
    elif kind == "rescale":
        times = arg or p.rescale_primes
        level = ell
        for _ in range(times):
            w.ntt_limbs += (1 + (level - 1)) * 2 * B
            w.elt_mults += 2 * (level - 1) * N * B
            level -= 1
        w.io_words += (ell + level) * 2 * N * B
    elif kind == "pmult":
        w.elt_mults += 2 * ell * N * B
        w.io_words += 2 * ct * B + plaintexts * ell * N
    elif kind == "hadd":
        w.io_words += 3 * ct * B
    else:
        raise ValueError(f"no work model for op kind {kind!r}")
    return w


# --------------------------------------------------------------------------
# least times (seconds)
# --------------------------------------------------------------------------


def ntt_least_s(p: Params, w: Work, peak: dict) -> float:
    """Each limb transform reads and writes N words and does (N/2)·log₂N
    butterflies."""
    words = 2 * p.N * w.ntt_limbs
    ops = p.N / 2 * math.log2(p.N) * w.ntt_limbs
    return max(words * WORD_BYTES / peak["bytes_per_s"], ops / peak["ops_per_s"])


def keyswitch_least_s(p: Params, w: Work, peak: dict) -> float:
    """BConvs, the rotations' fused automorphism and key inner product,
    and the b-halves' automorphisms, together."""
    words = w.bconv_words + w.ks_words + w.perm_words
    ops = w.bconv_macs + w.ks_macs
    return max(words * WORD_BYTES / peak["bytes_per_s"], ops / peak["ops_per_s"])


def whole_least_s(p: Params, w: Work, peak: dict) -> float:
    """All the HE work: the ops' own inputs and outputs as bytes, every
    modular multiply as an operation."""
    ops = (p.N / 2 * math.log2(p.N) * w.ntt_limbs + w.bconv_macs + w.ks_macs
           + w.elt_mults)
    return max(w.io_words * WORD_BYTES / peak["bytes_per_s"],
               ops / peak["ops_per_s"])
