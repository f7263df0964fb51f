"""Fault-tolerant runtime: the training step driver (checkpoint/restart,
NaN quarantine, straggler watchdog, preemption save), the deterministic
fault-injection framework the serving chaos runs drive, and structured
tracing."""
from .driver import DriverConfig, StepDriver
from .faults import (FaultError, FaultInjector, FaultPlan, FaultSpec,
                     StagingFault, TransientFault, active_injector, inject)
from . import tracing
from .tracing import Histogram, Tracer

__all__ = [
    "DriverConfig", "FaultError", "FaultInjector", "FaultPlan", "FaultSpec",
    "Histogram", "StagingFault", "StepDriver", "Tracer", "TransientFault",
    "active_injector", "inject", "tracing",
]
