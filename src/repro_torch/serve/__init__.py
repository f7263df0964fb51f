"""Multi-tenant FHE serving subsystem (the port of ``repro.serve``).

The serving layer above the CKKS kernels: an admission queue with
deadlines/priorities, a batcher stacking same-shaped HE ops from different
requests into single kernel dispatches, a per-tenant key store with LRU evk
residency, a plan cache for zero steady-state re-resolution, and metrics
tying throughput to the deterministic launch/upload counters.

    from repro_torch.serve import (FheServeEngine, FheRequest, HeOp,
                                   TenantKeyStore, standard_program)

Crash safety (see :mod:`repro_torch.serve.journal` /
:mod:`repro_torch.serve.recovery`): a journaled engine write-ahead-logs every
admission, step, and terminal status; :meth:`FheServeEngine.snapshot`
publishes atomic snapshots and :func:`recover` rebuilds a bit-identical
engine from snapshot + journal tail.  :class:`DispatchWatchdog` bounds every
dispatch against hung launches.

The token-decode :class:`~repro_torch.serve.engine.ServeEngine` of the LM
substrate keeps the reference's import path.
"""
from .engine import ServeEngine
from .fhe import FheServeEngine
from .ir import (BATCHED_KINDS, KEYED_KINDS, OP_KINDS, FheRequest, HeOp,
                 LogicalClock, RequestFailed, RequestRejected,
                 RequestTimeout, admission_check, rid_counter_state,
                 set_rid_counter, standard_program, standard_reference,
                 standard_request)
from .journal import Journal, JournalCorrupt, JournalError
from .keystore import TenantDegraded, TenantKeyStore, UnknownTenant
from .metrics import ServeMetrics
from .plans import Plan, PlanCache
from .recovery import RecoveryError, SnapshotStore, recover
from .resilience import (DEGRADED, HEALTHY, SHEDDING, DispatchHung,
                         DispatchWatchdog, OverloadController, RetryPolicy)
from .scheduler import AdmissionQueue, QueueFull

__all__ = [
    "AdmissionQueue", "BATCHED_KINDS", "DEGRADED", "DispatchHung",
    "DispatchWatchdog", "FheRequest", "FheServeEngine", "HEALTHY", "HeOp",
    "Journal", "JournalCorrupt", "JournalError", "KEYED_KINDS",
    "LogicalClock", "OP_KINDS", "OverloadController", "Plan", "PlanCache",
    "QueueFull", "RecoveryError", "RequestFailed", "RequestRejected",
    "RequestTimeout", "RetryPolicy", "SHEDDING", "ServeEngine", "ServeMetrics",
    "SnapshotStore", "TenantDegraded", "TenantKeyStore", "UnknownTenant",
    "admission_check", "recover", "rid_counter_state", "set_rid_counter",
    "standard_program", "standard_reference", "standard_request",
]
