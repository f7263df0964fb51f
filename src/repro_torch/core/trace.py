"""HE-op tracing: record the primitive-function composition of a workload.

The paper's evaluation drives a cycle-level simulator with HE-op sequences
(§VI-A).  Here every primitive-function invocation (NTT / BConv / automorphism
/ element-wise, with limb counts) is appended to the active :class:`OpTrace`;
workload drivers (bootstrapping, HELR) run under ``with OpTrace() as t:`` and
hand ``t`` to the cost model, while the ResNet/Sort traces are generated
analytically (:mod:`repro.workloads.traces`) in the same format.

A trace record is (func, n_limbs, n_coeff, count):
    func ∈ {"ntt", "intt", "bconv_mul", "auto", "elt_mul", "elt_add",
            "evk_load_bytes", "pt_load_bytes"}
"""
from __future__ import annotations

import collections
import contextvars
import dataclasses


@dataclasses.dataclass
class OpTrace:
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    he_ops: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    # kernel-grain mirror: per-family CUDA kernel launch counts, fed by
    # repro_torch.kernels.config.count_launch so an active trace sees EXACTLY the
    # launches kernels/config tallies on the same workload (the fused/batched
    # paths dispatch far fewer kernels than the primitive records suggest —
    # this is the ground truth the cost-model crosscheck reconciles against)
    launches: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    # record-call events per func (no limb/coeff weighting): the unit
    # cost_model.predict_launches maps to expected kernel dispatches
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def add(self, func: str, n_limbs: int, n_coeff: int, count: int = 1):
        self.counts[(func, n_limbs, n_coeff)] += count
        self.calls[func] += 1

    def add_he(self, op: str):
        self.he_ops[op] += 1

    def add_launch(self, family: str, n: int = 1):
        self.launches[family] += n

    # -- aggregates used by the cost model ------------------------------------
    def limb_transforms(self) -> float:
        """Total single-limb NTT equivalents."""
        return sum(ell * c for (f, ell, _), c in self.counts.items()
                   if f in ("ntt", "intt"))

    def bconv_macs(self) -> float:
        """Total modular MACs in BConv table products."""
        return sum(ell * n * c for (f, ell, n), c in self.counts.items()
                   if f == "bconv_mul")

    def total(self, func: str) -> float:
        return sum(ell * n * c for (f, ell, n), c in self.counts.items()
                   if f == func)

    def butterflies(self, logN_cache: dict | None = None) -> float:
        """Total butterfly ops: (N/2)·log2(N) per limb transform."""
        import math
        tot = 0.0
        for (f, ell, n), c in self.counts.items():
            if f in ("ntt", "intt"):
                tot += ell * c * (n / 2) * math.log2(n)
        return tot

    def merge(self, other: "OpTrace", times: int = 1):
        for k, v in other.counts.items():
            self.counts[k] += v * times
        for k, v in other.he_ops.items():
            self.he_ops[k] += v * times
        for k, v in other.launches.items():
            self.launches[k] += v * times
        for k, v in other.calls.items():
            self.calls[k] += v * times

    def summary(self) -> dict:
        return {
            "he_ops": dict(self.he_ops),
            "kernel_launches": dict(self.launches),
            "limb_ntts": self.limb_transforms(),
            "butterflies": self.butterflies(),
            "bconv_macs": self.bconv_macs(),
            "auto": self.total("auto"),
            "elt": self.total("elt_mul") + self.total("elt_add"),
            "evk_bytes": self.total("evk_load_bytes"),
            "pt_bytes": self.total("pt_load_bytes"),
        }


_active: contextvars.ContextVar[OpTrace | None] = contextvars.ContextVar(
    "he_trace", default=None)


# Set inside :func:`unrecorded`: primitive and HE-op records are dropped,
# kernel launches still mirrored.
_muted: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "he_trace_muted", default=False)


class trace_ops:
    """Context manager activating an OpTrace."""

    def __init__(self, t: OpTrace | None = None):
        self.trace = t or OpTrace()

    def __enter__(self) -> OpTrace:
        self._tok = _active.set(self.trace)
        return self.trace

    def __exit__(self, *exc):
        _active.reset(self._tok)
        return False


class unrecorded:
    """Context manager under which :func:`record` and :func:`record_he`
    record nothing, while :func:`record_launch` still mirrors every launch:
    for work the port does differently from the reference (one stacked
    transform where the reference transforms each member) and records
    itself in the reference's terms."""

    def __enter__(self):
        self._tok = _muted.set(True)
        return self

    def __exit__(self, *exc):
        _muted.reset(self._tok)
        return False


def record(func: str, n_limbs: int, n_coeff: int, count: int = 1):
    t = _active.get()
    if t is not None and not _muted.get():
        t.add(func, n_limbs, n_coeff, count)


def record_he(op: str):
    t = _active.get()
    if t is not None and not _muted.get():
        t.add_he(op)


def record_launch(family: str, n: int = 1):
    """Mirror one kernel launch into the active trace (called by
    :func:`repro_torch.kernels.config.count_launch` after the global
    counter moves, so ``OpTrace.launches`` stays equal to the per-region
    counter deltas)."""
    t = _active.get()
    if t is not None:
        t.add_launch(family, n)
