"""Kernel-launch counters, the backend probe and the block-size policy of the
port's CUDA kernels.

Each kernel wrapper calls :func:`count_launch` exactly where it launches its
CUDA kernel — never on the plain CPU path — under the reference's family name
("eltwise", "bconv", "ntt", "auto_ks", "automorphism") and under its own
kernel name, so a run can show which kernel its main path went through, not
only which family: the single-permutation, eager and multi-permutation
kernels all count under "automorphism".  Launches are mirrored into an active
:class:`repro_torch.core.trace.OpTrace`.

There is no interpret or compiled mode: a CUDA tensor runs the kernel, a CPU
tensor the plain version.  :func:`backend` names what this process has.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.core import trace as _hetrace

_launches: collections.Counter = collections.Counter()
_kernel_launches: collections.Counter = collections.Counter()


def backend() -> str:
    """"cuda" when this process sees a CUDA card, else "cpu"."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def effective_block(B: int, requested: int | None, default: int = 4) -> int:
    """Largest divisor of ``B`` that is ≤ the requested block size.

    The request is clamped to [1, B] and rounded down to a divisor of B, so
    every CTA owns an equal block of rows.
    """
    want = max(1, min(B, requested if requested else default))
    return max(d for d in range(1, want + 1) if B % d == 0)


def count_launch(family: str, kernel: str, n: int = 1) -> None:
    """Record ``n`` launches of ``kernel``, a member of ``family``."""
    _launches[family] += n
    _kernel_launches[kernel] += n
    _hetrace.record_launch(family, n)


def launch_counts() -> dict:
    """Snapshot of per-family launch counts since the last reset."""
    return dict(_launches)


def kernel_launch_counts() -> dict:
    """Snapshot of per-kernel launch counts since the last reset."""
    return dict(_kernel_launches)


def reset_launches() -> None:
    """Zero every per-family and per-kernel counter."""
    _launches.clear()
    _kernel_launches.clear()
