"""Togglable FHE invariant guards (``REPRO_GUARDS=off|cheap|full``).

Silent corruption is the failure mode an FHE service can never tolerate: a
level underflow, a drifted scale, or a flipped residue bit does not crash —
it decrypts to *wrong numbers* for a tenant who cannot inspect the
ciphertext.  This module centralizes the invariant checks the CKKS layer
runs at op boundaries and the typed errors they raise, behind the same
get/set/env/context-manager knob pattern as ``REPRO_KERNEL_MODE`` and
``REPRO_CKKS_ENGINE``:

* ``off``   — no guard checks (the pre-guard behavior; raw asserts only);
* ``cheap`` — (default) O(1) metadata checks: level underflow before
  rescale/HMult, scale drift beyond tolerance on HAdd/HSub, basis (level)
  mismatch between operands.  These read Python floats/tuples, never
  ciphertext data, so serving pays effectively nothing (gated ≤5 % on the
  ``bench_serve`` throughput path by ``BENCH_chaos.json``);
* ``full``  — additionally scan ciphertext residues for out-of-range limbs
  (``data >= q_i``), the detector for bit-flip corruption.  O(ℓ·N) device
  reads per checked operand — the paranoid mode chaos testing and
  high-assurance serving run under.

Every violation raises a typed :class:`GuardError` subclass instead of
corrupting downstream results; a serving engine maps these to poison-
request quarantine.
"""
from __future__ import annotations

import os

_MODES = ("off", "cheap", "full")
_mode = os.environ.get("REPRO_GUARDS", "cheap")
if _mode not in _MODES:
    raise ValueError(f"REPRO_GUARDS={_mode!r} — must be one of {_MODES}")

# relative scale tolerance: single-prime test chains accumulate ~2⁻¹³
# multiplicative drift per rescale (primes differ by ≲0.01 %)
SCALE_RTOL = 1e-3


class GuardError(Exception):
    """An FHE invariant was violated before it could corrupt a result."""


class LevelUnderflow(GuardError):
    """An op needed more RNS limbs than the ciphertext has left."""


class ScaleDrift(GuardError):
    """Operand scales differ beyond tolerance (would decrypt misaligned)."""


class BasisMismatch(GuardError):
    """Operands live at different levels / RNS bases."""


class ResidueRange(GuardError):
    """A limb residue is ≥ its prime — corrupted ciphertext data."""


def get_mode() -> str:
    return _mode


def set_mode(name: str) -> None:
    """Select the guard mode globally ("off" | "cheap" | "full")."""
    global _mode
    if name not in _MODES:
        raise ValueError(f"unknown guard mode {name!r} — one of {_MODES}")
    _mode = name


class use_mode:
    """Context manager pinning the guard mode (tests, benchmarks)."""

    def __init__(self, name: str):
        if name not in _MODES:
            raise ValueError(f"unknown guard mode {name!r} — one of {_MODES}")
        self.name = name

    def __enter__(self):
        self._saved = _mode
        set_mode(self.name)
        return self

    def __exit__(self, *exc):
        set_mode(self._saved)
        return False


def active() -> bool:
    return _mode != "off"


def full() -> bool:
    return _mode == "full"


# ----------------------------------------------------------------------------
# Cheap (metadata-only) checks
# ----------------------------------------------------------------------------

def check_level(basis: tuple[int, ...], need: int, op: str) -> None:
    """``op`` needs at least ``need`` limbs in the current basis."""
    if _mode == "off":
        return
    if len(basis) < need:
        raise LevelUnderflow(
            f"{op}: needs ≥{need} limbs, ciphertext has {len(basis)}")


def check_scale_match(s1: float, s2: float, op: str) -> None:
    if _mode == "off":
        return
    if abs(s1 - s2) / max(abs(s1), 1e-300) > SCALE_RTOL:
        raise ScaleDrift(f"{op}: operand scales {s1:g} vs {s2:g} drift "
                         f"beyond rtol {SCALE_RTOL:g}")


def check_basis_match(b1: tuple[int, ...], b2: tuple[int, ...],
                      op: str) -> None:
    if _mode == "off":
        return
    if b1 != b2:
        raise BasisMismatch(
            f"{op}: operand bases differ (levels {len(b1)} vs {len(b2)})")


# ----------------------------------------------------------------------------
# Full (data-scanning) checks
# ----------------------------------------------------------------------------

def check_residues(data, basis: tuple[int, ...], op: str) -> None:
    """Every limb residue must sit in [0, q_i) — full mode only.

    ``data`` is an (…, ℓ, N) int32 torch tensor on any device (or the parts
    of a multi-part value of the distributed engine, each scanned against
    its own limbs' moduli); the scan is
    one vectorized device compare + a host sync of a single boolean, so full
    mode costs one extra pass over each checked operand.  Residues are
    non-negative int32 (every prime is < 2³⁰), so a flipped bit 31 reads as
    a negative value and is caught too.
    """
    if _mode != "full":
        return
    import torch
    from .parts import Parts, parts_of
    slices = data.limb_slices() if isinstance(data, Parts) else [slice(None)]
    for part, limbs in zip(parts_of(data), slices):
        q = torch.tensor(basis[limbs], dtype=torch.int64,
                         device=part.device).reshape(-1, 1)
        d = part.to(torch.int64)
        if bool(((d < 0) | (d >= q)).any()):
            raise ResidueRange(f"{op}: limb residue out of [0, q) range "
                               f"(corrupted ciphertext data)")


def check_ciphertext(ct, op: str) -> None:
    """Full-mode corruption scan of both ciphertext components."""
    if _mode != "full":
        return
    check_residues(ct.a.data, ct.a.basis, f"{op}.a")
    check_residues(ct.b.data, ct.b.basis, f"{op}.b")
