"""Virtual CKKS execution: replay HE-op control flow at arbitrary parameters,
recording primitive-function counts into an OpTrace without touching data.

The cost formulas mirror the real implementation exactly (hybrid KS with
dnum digits, hoisted rotations, minimum-KS giant folding, double-prime
rescale) so that a virtual trace at test-scale parameters matches the
measured trace of the real run (validated in tests/test_torch_analytics.py
on the CPU and by ``chip_smoke.py`` at ``paper_full`` on the card), and
paper-scale traces are therefore trustworthy inputs to the cost model.  The
port of ``repro.workloads.virtual``.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.params import CkksParams
from repro_torch.core.trace import OpTrace


@dataclasses.dataclass
class VirtualCt:
    level: int                      # current ℓ


class VirtualCkks:
    def __init__(self, params: CkksParams, trace: OpTrace | None = None,
                 use_min_ks: bool = True, prng_evk: bool = True):
        self.p = params
        self.t = trace or OpTrace()
        self.use_min_ks = use_min_ks
        self.prng_evk = prng_evk

    # -- primitive recorders ---------------------------------------------------
    def _ntt(self, limbs: int, count: int = 1):
        self.t.add("ntt", limbs, self.p.N, count)

    def _intt(self, limbs: int, count: int = 1):
        self.t.add("intt", limbs, self.p.N, count)

    def _bconv(self, src: int, dst: int, count: int = 1):
        self.t.add("bconv_mul", src * dst, self.p.N, count)
        self.t.add("bconv_in", src, self.p.N, count)
        self.t.add("bconv_out", dst, self.p.N, count)

    def _elt(self, limbs: int, count: int = 1, kind: str = "elt_mul"):
        self.t.add(kind, limbs, self.p.N, count)

    def _auto(self, limbs: int, count: int = 1):
        self.t.add("auto", limbs, self.p.N, count)

    def _evk(self, ell: int, digits: int):
        bytes_ = digits * (ell + self.p.K) * self.p.N * 4
        if not self.prng_evk:
            bytes_ *= 2                     # both halves from HBM
        self.t.add("evk_load_bytes", 1, bytes_)

    # -- compound ops ------------------------------------------------------------
    def digits_at(self, ell: int) -> int:
        return -(-ell // self.p.alpha)

    def mod_up(self, ell: int):
        """Decompose+ModUp of one poly at level ℓ (iNTT ℓ, per-digit BConv+NTT)."""
        a, K = self.p.alpha, self.p.K
        d = self.digits_at(ell)
        self._intt(ell)
        for j in range(d):
            src = min(a, ell - j * a)
            dst = ell - src + K
            self._bconv(src, dst)
            self._ntt(dst)

    def ks_inner(self, ell: int):
        """evk inner product + ModDown (two output polys)."""
        d = self.digits_at(ell)
        K = self.p.K
        self._evk(ell, d)
        self._elt((ell + K) * d * 2)          # ext_j ⊙ (a_j, b_j)
        self._elt((ell + K) * (d - 1) * 2, kind="elt_add")
        for _ in range(2):                    # ModDown per output poly
            self._intt(K)
            self._bconv(K, ell)
            self._ntt(ell)
            self._elt(2 * ell)                # subtract + P⁻¹ scaling
        self.t.add_he("KS")

    def key_switch(self, ell: int):
        self.mod_up(ell)
        self.ks_inner(ell)

    def rescale(self, ct: VirtualCt, times: int | None = None) -> VirtualCt:
        times = times if times is not None else self.p.rescale_primes
        ell = ct.level
        for _ in range(times):
            # per poly: iNTT last limb, lift, NTT into ℓ−1, sub+scale
            self._intt(1, 2)
            self._ntt(ell - 1, 2)
            self._elt(2 * (ell - 1), 2)
            ell -= 1
        self.t.add_he("Rescale")
        return VirtualCt(ell)

    def hmult(self, c1: VirtualCt, c2: VirtualCt | None = None,
              rescale: bool = True) -> VirtualCt:
        ell = c1.level
        self._elt(4 * ell)                    # d0, d1 (×2), d2
        self.key_switch(ell)
        self._elt(2 * ell, kind="elt_add")
        self.t.add_he("HMult")
        return self.rescale(VirtualCt(ell)) if rescale else VirtualCt(ell)

    def pmult(self, ct: VirtualCt, rescale: bool = True) -> VirtualCt:
        self._elt(2 * ct.level)
        self.t.add_he("PMult")
        self.t.add("pt_load_bytes", 1, ct.level * self.p.N * 4)
        return self.rescale(ct) if rescale else VirtualCt(ct.level)

    def hadd(self, ct: VirtualCt) -> VirtualCt:
        self._elt(2 * ct.level, kind="elt_add")
        self.t.add_he("HAdd")
        return ct

    def hrot(self, ct: VirtualCt) -> VirtualCt:
        self._auto(2 * ct.level)
        self.key_switch(ct.level)
        self._elt(2 * ct.level, kind="elt_add")
        self.t.add_he("HRot")
        return ct

    def hrot_hoisted(self, ct: VirtualCt, n_rot: int,
                     lazy_moddown: bool = False) -> VirtualCt:
        """n_rot rotations sharing one ModUp.

        ``lazy_moddown`` models the Halevi-Shoup accumulation the
        paper-class implementations use inside BSGS transforms: per-rotation
        inner products accumulate in the extended basis and a single ModDown
        closes the group — the per-rotation cost collapses to
        automorphism + inner product.
        """
        ell = ct.level
        self.mod_up(ell)
        d = self.digits_at(ell)
        K = self.p.K
        if lazy_moddown:
            self._evk(ell, d)
            for _ in range(n_rot):
                self._auto((ell + K) * d + 2 * ell)
                self._elt((ell + K) * d * 2)            # inner product only
                self._elt((ell + K) * 2, kind="elt_add")
            for _ in range(2):                          # one ModDown, 2 polys
                self._intt(K)
                self._bconv(K, ell)
                self._ntt(ell)
                self._elt(2 * ell)
            self.t.add_he("KS")
        else:
            for _ in range(n_rot):
                self._auto((ell + self.p.K) * d + 2 * ell)
                self.ks_inner(ell)            # inner product + ModDown
        self.t.add_he("HRotHoisted")
        return ct

    def conjugate(self, ct: VirtualCt) -> VirtualCt:
        return self.hrot(ct)

    # -- bootstrapping (mirrors repro_torch.core.bootstrap) -----------------------
    def linear_transform(self, ct: VirtualCt, n_slots: int,
                         levels: int = 1) -> VirtualCt:
        """Homomorphic DFT-like transform.

        levels=1 is the dense single matrix our test-scale implementation
        uses; paper-scale bootstrapping decomposes CtS/StC into ``levels``
        sparse radix-r factors (r = n^{1/levels}, ≈2r−1 diagonals each), the
        ARK/Lattigo structure — without it the diagonal plaintexts alone are
        hundreds of GB.
        """
        cur = ct
        for _ in range(levels):
            if levels == 1:
                n_diag = n_slots
            else:
                r = max(2, round(n_slots ** (1.0 / levels)))
                n_diag = 2 * r - 1
            # larger baby side: giants are full key-switches, babies are
            # lazy-ModDown inner products (4:1 is the usual BSGS skew)
            bs = 1
            while bs * bs < 4 * n_diag:
                bs *= 2
            bs = min(bs, n_diag)
            n_giants = -(-n_diag // bs)
            self.hrot_hoisted(cur, bs - 1, lazy_moddown=(levels > 1))
            self._elt(2 * cur.level * n_diag)          # diagonal pmults
            self.t.add("pt_load_bytes", 1,
                       n_diag * cur.level * self.p.N * 4)
            for _ in range(n_giants - 1):              # giant folds (min-KS)
                self.hrot(cur)
            cur = self.rescale(cur, times=1)
        return cur

    def eval_chebyshev(self, ct: VirtualCt, deg: int,
                       bsgs: bool = True) -> VirtualCt:
        """Chebyshev evaluation.  bsgs=True models the Paterson-Stockmeyer
        BSGS form (≈2√d + log₂d non-scalar mults — the Lattigo/[36] algorithm
        the paper adopts); bsgs=False mirrors our simpler all-T_i test-scale
        implementation (d−1 mults)."""
        depth = math.ceil(math.log2(max(deg, 2)))
        n_mults = (math.ceil(2 * math.sqrt(deg)) + depth if bsgs else deg - 1)
        cur = ct
        for i in range(n_mults):                   # products down the tree
            cur_lvl = max(cur.level - 1, 1)
            self.hmult(VirtualCt(cur.level), rescale=True)
            if i % max(n_mults // (depth + 1), 1) == 0:
                cur = VirtualCt(cur_lvl)
        # scalar-coefficient combination
        self._elt(2 * cur.level * deg)
        out_level = ct.level - (depth + 1)
        return self.rescale(VirtualCt(out_level + 1), times=1)

    def bootstrap(self, ct: VirtualCt, n_slots: int | None = None,
                  cheb_deg: int = 47, fft_levels: int | None = None) -> VirtualCt:
        n_slots = n_slots or self.p.slots
        # test-scale (n ≤ 2^10) uses the dense single-level transform like the
        # real implementation; paper scale uses the 3-level decomposition.
        if fft_levels is None:
            fft_levels = 1 if n_slots <= 1024 else 3
        L = self.p.L
        self.t.add_he("Bootstrap")
        # ModRaise: lift 1→L (exact, elementwise) + NTT of L limbs ×2 polys
        self._elt(2 * L)
        self._ntt(L, 2)
        cur = VirtualCt(L)
        cur = self.linear_transform(cur, n_slots, fft_levels)     # CtS
        cur = self.conjugate(cur)
        depth = math.ceil(math.log2(cheb_deg)) + 2
        u = VirtualCt(cur.level)
        for _ in range(2):                                   # EvalMod ×(re,im)
            self.eval_chebyshev(VirtualCt(u.level - 1), cheb_deg)
        cur = VirtualCt(u.level - depth)
        cur = self.linear_transform(cur, n_slots, fft_levels)     # StC
        return cur
