"""Fault-tolerant serving runtime: the deterministic fault-injection
framework the serving chaos runs drive, and structured tracing.

The reference's training-step loop (``StepDriver``) is not ported yet."""
from .faults import (FaultError, FaultInjector, FaultPlan, FaultSpec,
                     StagingFault, TransientFault, active_injector, inject)
from . import tracing
from .tracing import Histogram, Tracer

__all__ = [
    "FaultError", "FaultInjector", "FaultPlan", "FaultSpec", "Histogram",
    "StagingFault", "Tracer", "TransientFault", "active_injector", "inject",
    "tracing",
]
