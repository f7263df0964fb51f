"""Kernel-launch counters of the port's CUDA kernels.

Each kernel wrapper calls :func:`count_launch` exactly where it launches its
CUDA kernel — never on the plain CPU path — under the reference's family name
("eltwise", "bconv", "auto_ks", "automorphism"), so a run can show that its
main path really went through the kernels.  Launches are mirrored into an
active :class:`repro_torch.core.trace.OpTrace`.
"""
from __future__ import annotations

import collections

from repro_torch.core import trace as _hetrace

_launches: collections.Counter = collections.Counter()


def count_launch(family: str, n: int = 1) -> None:
    """Record ``n`` kernel launches of ``family``."""
    _launches[family] += n
    _hetrace.record_launch(family, n)


def launch_counts() -> dict:
    """Snapshot of per-family launch counts since the last reset."""
    return dict(_launches)


def reset_launches() -> None:
    """Zero every per-family counter."""
    _launches.clear()
