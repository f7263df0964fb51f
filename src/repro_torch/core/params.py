"""CKKS parameter sets (paper Table I) and test-scale presets.

Paper targets: N = 2¹⁶, L ≤ 48, K = 12, Q ≤ 2¹²¹⁸, P = 2³³⁶, ≥128-bit security,
32-bit words with double-prime rescaling (Δ = q_{2i}·q_{2i+1} ≈ 2⁴⁷–2⁵⁵ via
~2⁴⁷·... here: two ~29-bit primes → Δ ≈ 2⁵⁸; the *mechanism* matches §III-C).

Hybrid key-switching (Han-Ki [36], as in ARK/Lattigo): the L limbs are split
into ``dnum`` digits of α = L/dnum limbs; K = α auxiliary primes.  The paper's
K = 12 with L = 48 corresponds to dnum = 4.

Test-scale presets keep every algorithmic feature (hybrid KS, double-prime
rescale, bootstrapping) but shrink N and L so a CPU can execute them; the
paper-scale preset runs on the GPU (``chip_smoke.py`` at the repo root).
"""
from __future__ import annotations

import dataclasses
import functools

from . import rns


@dataclasses.dataclass(frozen=True)
class CkksParams:
    N: int                      # ring degree
    q: tuple[int, ...]          # L primes (level chain, q[0] = base)
    p: tuple[int, ...]          # K auxiliary primes
    dnum: int                   # number of key-switching digits
    rescale_primes: int = 1     # 1 = classic; 2 = paper's double-prime rescale

    @property
    def L(self) -> int:
        return len(self.q)

    @property
    def K(self) -> int:
        return len(self.p)

    @property
    def alpha(self) -> int:
        return -(-self.L // self.dnum)

    @property
    def slots(self) -> int:
        return self.N // 2

    def basis_q(self, ell: int) -> tuple[int, ...]:
        return self.q[:ell]

    def digit_bases(self, ell: int) -> list[tuple[int, ...]]:
        """Digits D_j (α primes each) covering the first ℓ limbs."""
        a = self.alpha
        return [self.q[j * a:min((j + 1) * a, ell)]
                for j in range(-(-ell // a))]

    def scale(self) -> float:
        """Default encoding scale Δ: product of ``rescale_primes`` top primes."""
        s = 1.0
        for qi in self.q[-self.rescale_primes:]:
            s *= qi
        return s


@functools.lru_cache(maxsize=None)
def make_params(N: int, L: int, K: int, dnum: int,
                rescale_primes: int = 1) -> CkksParams:
    # p primes must be ≥ q primes for ModDown noise; draw them first (largest).
    ps = rns.gen_ntt_primes(K, N)
    qs = rns.gen_ntt_primes(L, N, exclude=tuple(ps))
    # q[0] (base prime, never rescaled away) gets the largest remaining prime.
    return CkksParams(N=N, q=tuple(qs), p=tuple(ps), dnum=dnum,
                      rescale_primes=rescale_primes)


# -- presets -------------------------------------------------------------------

def paper_full() -> CkksParams:
    """Paper Table I: N=2¹⁶, L=48, K=12, dnum=4, double-prime rescale."""
    return make_params(N=1 << 16, L=48, K=12, dnum=4, rescale_primes=2)


def test_small() -> CkksParams:
    """CPU-executable: N=2¹⁰, L=6, K=2, dnum=3 (α=2=K)."""
    return make_params(N=1 << 10, L=6, K=2, dnum=3)


def test_medium() -> CkksParams:
    """CPU-executable with headroom for double-prime rescale tests."""
    return make_params(N=1 << 11, L=8, K=2, dnum=4, rescale_primes=2)


def test_boot() -> CkksParams:
    """Bootstrapping-capable test scale: enough levels for CtS/EvalMod/StC."""
    return make_params(N=1 << 10, L=14, K=2, dnum=7)
