"""Kernel-launch counters, the backend probe and the block-size policy of the
port's CUDA kernels.

Each kernel wrapper calls :func:`count_launch` exactly where it launches its
CUDA kernel — never on the plain CPU path — under the reference's family name
("eltwise", "bconv", "ntt", "auto_ks", "automorphism") and under its own
kernel name, so a run can show which kernel its main path went through, not
only which family: the single-permutation, eager and multi-permutation
kernels all count under "automorphism".  Each wrapper also names the card it
launched on, so a run on a mesh over several cards shows the launches per
card (:func:`card_launch_counts`).  Launches are mirrored into an active
:class:`repro_torch.core.trace.OpTrace`.

Each wrapper also calls :func:`before_launch` just ahead of its launch, which
runs the optional launch hook (fault injection, tracing) *before* the kernel
writes its output, as the reference's ``count_launch`` does.  A hook that
raises leaves the launch uncounted and no output published, so a retry of the
op is always safe.

There is no interpret or compiled mode: a CUDA tensor runs the kernel, a CPU
tensor the plain version.  :func:`backend` names what this process has, and
:func:`mode_launch_counts` reports every launch under the one mode the port
has, "cuda".
"""
from __future__ import annotations

import collections

import torch

from repro_torch.core import trace as _hetrace

_launches: collections.Counter = collections.Counter()
_kernel_launches: collections.Counter = collections.Counter()
_card_launches: collections.Counter = collections.Counter()   # (card, kernel)

# Optional pre-launch hook, called as hook(family, n) by :func:`before_launch`
# ahead of every kernel launch.  The fault injector (repro_torch.runtime.faults)
# installs one that may raise; None (the default) costs one test.
_launch_hook = None

#: The one execution mode of the port's kernels (the reference has
#: "interpret" and "compiled"; a CPU tensor here runs the plain version and
#: launches nothing).
MODE = "cuda"


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


def set_launch_hook(fn) -> None:
    """Install (or clear, with None) the pre-launch hook."""
    global _launch_hook
    _launch_hook = fn


def get_launch_hook():
    """The installed pre-launch hook (None when clear); consumers that wrap
    it (fault injection, tracing) chain through it and restore it on exit."""
    return _launch_hook


def before_launch(family: str, n: int = 1) -> None:
    """Run the launch hook for ``n`` launches of ``family``; every wrapper
    calls this just before it launches, ahead of any output write."""
    if _launch_hook is not None:
        _launch_hook(family, n)


def count_launch(family: str, kernel: str, n: int = 1, device=None) -> None:
    """Record ``n`` launches of ``kernel``, a member of ``family``, after
    they were issued (a launch whose hook raised is never counted), on the
    card ``device`` when given."""
    _launches[family] += n
    _kernel_launches[kernel] += n
    if device is not None:
        _card_launches[(str(device), kernel)] += n
    _hetrace.record_launch(family, n)


def launch_counts() -> dict:
    """Snapshot of per-family launch counts since the last reset."""
    return dict(_launches)


def total_launches() -> int:
    return sum(_launches.values())


def mode_launch_counts() -> dict:
    """Per-mode per-family launch counts, ``{"cuda": {family: n}}``: the
    port has one mode, so there is no interpret or compiled figure."""
    return {MODE: dict(_launches)}


def launches_since(snapshot: dict) -> dict:
    """Per-family deltas against a :func:`launch_counts` snapshot (families
    with no change omitted)."""
    return {fam: n - snapshot.get(fam, 0) for fam, n in _launches.items()
            if n - snapshot.get(fam, 0)}


def kernel_launch_counts() -> dict:
    """Snapshot of per-kernel launch counts since the last reset."""
    return dict(_kernel_launches)


def card_launch_counts() -> dict:
    """Snapshot of the launches per card and kernel since the last reset:
    {card: {kernel: n}}."""
    out: dict = {}
    for (card, kernel), n in _card_launches.items():
        out.setdefault(card, {})[kernel] = n
    return out


def reset_launches() -> None:
    """Zero every per-family, per-kernel and per-card counter."""
    _launches.clear()
    _kernel_launches.clear()
    _card_launches.clear()


# ----------------------------------------------------------------------------
# Collective accounting (distributed engine, repro_torch.core.distributed)
# ----------------------------------------------------------------------------

# The model's tally: one entry per collective a dispatch of the distributed
# engine is predicted to issue (cost_model.predict_collectives), recorded at
# the dispatch as the reference records it.  The per-shard tally multiplies
# by the cores of the map (every core executes its slice of the collective).
# What the mesh actually executed is counted apart, by the mesh itself
# (core.distributed.Mesh.tally), so the two can be compared.
_collectives: collections.Counter = collections.Counter()
_collective_shards: collections.Counter = collections.Counter()


def count_collective(kind: str, n: int = 1, *, shards: int = 1) -> None:
    """Record ``n`` program-level collectives of ``kind`` ("all_to_all",
    "all_gather"), each executed by ``shards`` mesh cores."""
    _collectives[kind] += n
    _collective_shards[kind] += n * shards


def collective_counts() -> dict:
    """Program-grain per-kind collective counts since process start."""
    return dict(_collectives)


def collective_shard_counts() -> dict:
    """Per-shard (core-grain) collective counts since process start."""
    return dict(_collective_shards)


def collectives_since(snapshot: dict) -> dict:
    """Per-kind collective deltas against a :func:`collective_counts`
    snapshot (kinds with no change omitted)."""
    return {k: n - snapshot.get(k, 0) for k, n in _collectives.items()
            if n - snapshot.get(k, 0)}


def reset_collectives() -> None:
    """Zero both collective tallies."""
    _collectives.clear()
    _collective_shards.clear()
