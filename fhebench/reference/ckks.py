"""Plain reference for the served CKKS programs: float64 slot arithmetic and
an independent decryptor.

Nothing here imports the program under test. What it needs of the
ciphertext format is written out again from its definition:

* residues are unsigned 32-bit words, one row per prime of the basis
  ``q[:level]``, in the natural order of the primes;
* the NTT domain is evaluation at odd powers of ψ in natural order,
  ``ntt(a)[k] = Σ_n a[n]·ψ^((2k+1)n) mod q``, with ψ the first value
  ``g^((q-1)/2N)`` (g = 2, 3, …) whose N-th power is −1;
* a ciphertext (a, b) decrypts to ``b − a·s``; slot j of a plaintext m is
  ``m(ζ^(5^j)) / Δ`` with ζ = exp(iπ/N); rotation by r moves slot j + r to
  slot j.

The secret is the tenant's key seed expanded by the sampler the program's
key generation uses first, ``default_rng(seed).integers(-1, 2, N)`` (a
frozen copy; the harness holds the program's secret to it at set-up).

Everything runs in torch int64 on whatever device the caller names, so
the check after a run's window takes milliseconds on the card, and the
tests run it on the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# --------------------------------------------------------------------------
# the secret and the primes' roots
# --------------------------------------------------------------------------


def ternary_secret(key_seed: int, N: int) -> np.ndarray:
    """The uniform ternary secret that key generation draws first from
    ``default_rng(key_seed)``."""
    return np.random.default_rng(key_seed).integers(-1, 2, N, dtype=np.int64)


@functools.lru_cache(maxsize=None)
def find_psi(q: int, N: int) -> int:
    """The first primitive 2N-th root of unity mod q of the form
    g^((q-1)/2N), g = 2, 3, …"""
    if (q - 1) % (2 * N):
        raise ValueError(f"{q} is not 1 mod 2N = {2 * N}")
    exp = (q - 1) // (2 * N)
    for g in range(2, 10_000):
        psi = pow(g, exp, q)
        if pow(psi, N, q) == q - 1:
            return psi
    raise ValueError(f"no 2N-th root of unity mod {q}")


def _powers(base: int, q: int, n: int) -> np.ndarray:
    """base^k mod q for k < n, by doubling (int64 products stay < 2^60)."""
    out = np.ones(n, dtype=np.int64)
    width = 1
    step = base % q
    while width < n:
        top = min(2 * width, n)
        out[width:top] = out[:top - width] * step % q
        step = step * step % q
        width = top
    return out


class Ntt:
    """Negacyclic NTT over one basis, as stacked (ℓ, N) int64 tables."""

    def __init__(self, basis: tuple[int, ...], N: int, device):
        self.N = N
        self.basis = tuple(basis)
        qs = [int(q) for q in basis]
        psi = [find_psi(q, N) for q in qs]
        psi_inv = [pow(p, -1, q) for p, q in zip(psi, qs)]
        t = lambda rows: torch.tensor(np.stack(rows), dtype=torch.int64,
                                      device=device)
        self.q = torch.tensor(qs, dtype=torch.int64, device=device).reshape(-1, 1)
        self.psi_pow = t([_powers(p, q, N) for p, q in zip(psi, qs)])
        self.psi_inv_pow = t([_powers(p, q, N) for p, q in zip(psi_inv, qs)])
        self.omega_pow = t([_powers(p * p % q, q, N) for p, q in zip(psi, qs)])
        self.omega_inv_pow = t([_powers(p * p % q, q, N)
                                for p, q in zip(psi_inv, qs)])
        self.n_inv = torch.tensor([pow(N, -1, q) for q in qs], dtype=torch.int64,
                                  device=device).reshape(-1, 1)
        bits = N.bit_length() - 1
        rev = [int(format(i, f"0{bits}b")[::-1], 2) for i in range(N)]
        self.rev = torch.tensor(rev, dtype=torch.int64, device=device)

    def _cyclic(self, x: torch.Tensor, pows: torch.Tensor) -> torch.Tensor:
        """y[k] = Σ_n x[n]·w^(kn) mod q; x (ℓ, N) in [0, q)."""
        q = self.q
        x = x.index_select(-1, self.rev)
        ell, N = x.shape
        m = 2
        while m <= N:
            half = m // 2
            w = pows[:, ::N // m][:, :half]                       # (ℓ, half)
            blk = x.reshape(ell, N // m, 2, half)
            u = blk[:, :, 0, :]
            v = blk[:, :, 1, :] * w[:, None, :] % q[:, :, None]
            x = torch.cat([(u + v) % q[:, :, None], (u - v) % q[:, :, None]],
                          dim=-1).reshape(ell, N)
            m *= 2
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._cyclic(x * self.psi_pow % self.q, self.omega_pow)

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        y = self._cyclic(x, self.omega_inv_pow) * self.n_inv % self.q
        return y * self.psi_inv_pow % self.q


# --------------------------------------------------------------------------
# decryption and decoding
# --------------------------------------------------------------------------


def residues(data: torch.Tensor) -> torch.Tensor:
    """(ℓ, N) 32-bit words as int64 values in [0, 2^32)."""
    return data.to(torch.int64) & 0xFFFFFFFF


class Decryptor:
    """Decrypts ciphertexts of one tenant and reads their slots."""

    def __init__(self, s_small: np.ndarray, q: tuple[int, ...], N: int, device):
        self.N = N
        self.q = tuple(int(x) for x in q)
        self.device = device
        self.s = torch.tensor(s_small, dtype=torch.int64, device=device)
        self._ntt: dict[int, Ntt] = {}
        self._s_ntt: dict[int, torch.Tensor] = {}

    def ntt(self, ell: int) -> Ntt:
        if ell not in self._ntt:
            self._ntt[ell] = Ntt(self.q[:ell], self.N, self.device)
        return self._ntt[ell]

    def s_ntt(self, ell: int) -> torch.Tensor:
        if ell not in self._s_ntt:
            t = self.ntt(ell)
            self._s_ntt[ell] = t.forward(self.s[None, :] % t.q)
        return self._s_ntt[ell]

    def coefficients(self, a: torch.Tensor, b: torch.Tensor,
                     ntt_domain: bool) -> torch.Tensor:
        """Residues (ℓ, N) of b − a·s in the coefficient domain."""
        ell = a.shape[-2]
        t = self.ntt(ell)
        a, b = residues(a.to(self.device)), residues(b.to(self.device))
        if not ntt_domain:
            a, b = t.forward(a % t.q), t.forward(b % t.q)
        m = (b - a * self.s_ntt(ell) % t.q) % t.q
        return t.inverse(m)

    def lift(self, res: torch.Tensor) -> tuple[np.ndarray, int]:
        """Centred integer coefficients (float64) from the first three limbs
        by Garner's mixed radix, and the number of other limbs whose
        residues disagree with them."""
        q0, q1, q2 = self.q[:3]
        r0, r1, r2 = res[0], res[1], res[2]
        t1 = (r1 - r0) % q1 * pow(q0, -1, q1) % q1
        t2 = ((r2 - r0) % q2 * pow(q0, -1, q2) % q2 - t1) % q2 \
            * pow(q1, -1, q2) % q2
        low = r0 + q0 * t1                                   # < q0·q1 < 2^61
        half = (q2 - 1) // 2
        neg = (t2 > half) | ((t2 == half) & (2 * low > q0 * q1))
        hi = t2 - q2 * neg.to(torch.int64)
        bad = 0
        Q = q0 * q1 * q2
        for i in range(3, res.shape[0]):
            qi = self.q[i]
            got = (r0 + (q0 % qi) * t1 % qi + (q0 * q1 % qi) * t2 % qi
                   - neg.to(torch.int64) * (Q % qi)) % qi
            bad += int(not torch.equal(got, res[i]))
        value = hi.double().cpu().numpy() * float(q0 * q1) \
            + low.double().cpu().numpy()
        return value, bad

    def slots(self, coeffs: np.ndarray, scale: float) -> np.ndarray:
        """z_j = m(ζ^(5^j)) / Δ for every slot j < N/2."""
        N = self.N
        zeta = np.exp(1j * np.pi * np.arange(N) / N)
        evals = np.fft.ifft((coeffs / scale) * zeta) * N   # m(ζ^(2k+1)), k < N
        k = (_rot_group(N) - 1) // 2
        return evals[k]


@functools.lru_cache(maxsize=None)
def _rot_group(N: int) -> np.ndarray:
    out = np.empty(N // 2, dtype=np.int64)
    v = 1
    for j in range(N // 2):
        out[j] = v
        v = v * 5 % (2 * N)
    return out


# --------------------------------------------------------------------------
# the programs in float64
# --------------------------------------------------------------------------


def evaluate(program: list[dict], inputs: dict, plaintexts: dict) -> dict:
    """Slot vectors of every register after ``program``: hmult multiplies
    slotwise, pmult multiplies by the named plaintext, hrot r moves slot
    j + r to slot j, hadd adds, rescale keeps the values."""
    env = {k: np.asarray(v, dtype=np.complex128) for k, v in inputs.items()}
    for op in program:
        kind, src = op["kind"], [env[s] for s in op["srcs"]]
        if kind == "hmult":
            out = src[0] * src[1]
        elif kind == "pmult":
            out = src[0] * plaintexts[op["arg"]]
        elif kind == "hrot":
            out = np.roll(src[0], -int(op["arg"]))
        elif kind == "hadd":
            out = src[0] + src[1]
        elif kind == "rescale":
            out = src[0]
        else:
            raise ValueError(f"no reference for op kind {kind!r}")
        env[op["dst"]] = out
    return env


def levels_and_scales(program: list[dict], q: tuple[int, ...],
                      rescale_primes: int, inputs: dict, plaintexts: dict) -> dict:
    """(level, scale) of every register: ``inputs`` maps a register to its
    (level, scale), ``plaintexts`` a name to its scale."""
    env = dict(inputs)
    for op in program:
        kind, src = op["kind"], [env[s] for s in op["srcs"]]
        level, scale = src[0]
        if kind == "hmult":
            scale = scale * src[1][1]
        elif kind == "pmult":
            scale = scale * plaintexts[op["arg"]]
        elif kind == "rescale":
            times = op.get("arg") or rescale_primes
            for _ in range(times):
                scale = scale / q[level - 1]
                level -= 1
        env[op["dst"]] = (level, scale)
    return env


def encode_scale(q: tuple[int, ...], level: int, rescale_primes: int) -> float:
    """Δ for a ciphertext at ``level``: the product of the primes one
    rescale drops from it, so a product rescaled comes back to Δ."""
    s = 1.0
    for qi in q[level - rescale_primes:level]:
        s *= qi
    return s


def check(dec: Decryptor, a: torch.Tensor, b: torch.Tensor, ntt_domain: bool,
          level: int, scale: float, want: np.ndarray) -> dict:
    """The numbers one output is judged by: the widest slot error, the
    limbs that disagree, and whether its level is the program's."""
    if a.shape[-2] != level or b.shape[-2] != level:
        return {"err": float("inf"), "bad_limbs": 0, "wrong_level": 1}
    coeffs, bad = dec.lift(dec.coefficients(a, b, ntt_domain))
    got = dec.slots(coeffs, scale)
    return {"err": float(np.max(np.abs(got - want))), "bad_limbs": bad,
            "wrong_level": 0}
