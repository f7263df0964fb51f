"""Serving metrics: request accounting + deterministic dispatch counters.

Wall-clock latencies live next to *deterministic* counters — per-family
kernel-launch deltas (:mod:`repro_torch.kernels.config`) and constant/evk staging
events (:func:`repro_torch.core.const_cache.stage_events`) — because only
the deterministic ones can be gated: launches per request must fall as batch
size grows, and a warm steady state must upload nothing.  Launches are CUDA
kernel launches, so a wave on CPU data reports none.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import const_cache
from repro_torch.kernels import config as kconfig
from repro_torch.runtime.tracing import Histogram


@dataclasses.dataclass
class ServeMetrics:
    admitted: int = 0
    rejected: int = 0
    served: int = 0
    missed_deadlines: int = 0
    steps: int = 0
    groups_dispatched: int = 0
    ops_executed: int = 0
    ops_batched: int = 0                 # ops that shared a group of size ≥ 2
    wait_time: float = 0.0               # admission → first execution
    serve_time: float = 0.0              # admission → completion
    # streaming latency distributions (p50/p95/p99 in summary()).  wait/serve
    # observe engine-clock durations — deterministic under a LogicalClock, so
    # they round-trip through recovery state.  dispatch observes WALL seconds
    # per group dispatch and is process-local (excluded from state_dict, like
    # the launch/stage region snapshots).
    wait_hist: Histogram = dataclasses.field(default_factory=Histogram,
                                             repr=False)
    serve_hist: Histogram = dataclasses.field(default_factory=Histogram,
                                              repr=False)
    dispatch_hist: Histogram = dataclasses.field(default_factory=Histogram,
                                                 repr=False)

    # -- resilience (see repro_torch.serve.resilience / repro_torch.runtime.faults) ------
    failed: int = 0                      # terminal non-timeout failures
    timed_out: int = 0                   # deadline expired during execution
    deadline_missed_at_pop: int = 0      # dropped already-expired at pop
    shed: int = 0                        # dropped by overload shedding
    transient_faults: int = 0            # faults observed (pre-retry)
    retries: int = 0                     # re-dispatches after backoff
    quarantined: int = 0                 # poisoned requests evicted from waves
    group_splits: int = 0                # faulted groups replayed as singletons
    backoff_time: float = 0.0            # total seconds slept in backoff
    hung_dispatches: int = 0             # watchdog deadline trips
    hang_escalations: int = 0            # groups escalated to hung quarantine
    health: str = "healthy"              # overload controller state
    fault_pressure: float = 0.0          # overload controller EMA
    rejected_reasons: dict = dataclasses.field(default_factory=dict)
    # per-tenant fault history (staging retries, degradations, transient
    # faults, backoff) — reset by TenantKeyStore.heal() so a healed tenant
    # does not inherit stale fault pressure
    tenant_faults: dict = dataclasses.field(default_factory=dict)

    def observe_wait(self, dt: float) -> None:
        self.wait_time += dt
        self.wait_hist.observe(dt)

    def observe_serve(self, dt: float) -> None:
        self.serve_time += dt
        self.serve_hist.observe(dt)

    def observe_dispatch(self, dt: float) -> None:
        self.dispatch_hist.observe(dt)

    def histograms(self) -> dict:
        """Name → :class:`~repro_torch.runtime.tracing.Histogram` (the
        metrics-snapshot / Prometheus export surface)."""
        return {"wait": self.wait_hist, "serve": self.serve_hist,
                "dispatch": self.dispatch_hist}

    def reject(self, reason: str) -> None:
        self.rejected += 1
        key = reason.split(":")[-1] if ":" in reason else reason
        self.rejected_reasons[key] = self.rejected_reasons.get(key, 0) + 1

    def record_tenant(self, tenant: str, **deltas) -> None:
        """Accumulate per-tenant fault accounting (numeric deltas)."""
        hist = self.tenant_faults.setdefault(tenant, {})
        for key, d in deltas.items():
            hist[key] = hist.get(key, 0) + d

    def reset_tenant(self, tenant: str) -> None:
        """Drop one tenant's fault history (tenant healed)."""
        self.tenant_faults.pop(tenant, None)

    _launch_snap: dict = dataclasses.field(default_factory=dict, repr=False)
    _stage_snap: int = 0

    def begin_region(self) -> None:
        """Open a measurement region for launch/upload deltas."""
        self._launch_snap = kconfig.launch_counts()
        self._stage_snap = const_cache.stage_events()

    def region(self) -> dict:
        """Deltas since :meth:`begin_region`."""
        return {
            "kernel_launches": kconfig.launches_since(self._launch_snap),
            "const_uploads": const_cache.stage_events_since(self._stage_snap),
        }

    def summary(self, plan_stats: dict | None = None,
                key_uploads: int | None = None) -> dict:
        out = {
            "admitted": self.admitted,
            "rejected": self.rejected,
            "served": self.served,
            "missed_deadlines": self.missed_deadlines,
            "steps": self.steps,
            "groups_dispatched": self.groups_dispatched,
            "ops_executed": self.ops_executed,
            "ops_batched": self.ops_batched,
            "mean_wait": self.wait_time / max(1, self.served),
            "mean_serve_time": self.serve_time / max(1, self.served),
            "latency": {name: h.summary()
                        for name, h in self.histograms().items()},
            "failed": self.failed,
            "timed_out": self.timed_out,
            "deadline_missed_at_pop": self.deadline_missed_at_pop,
            "shed": self.shed,
            "transient_faults": self.transient_faults,
            "retries": self.retries,
            "quarantined": self.quarantined,
            "group_splits": self.group_splits,
            "backoff_time": self.backoff_time,
            "hung_dispatches": self.hung_dispatches,
            "hang_escalations": self.hang_escalations,
            "health": self.health,
            "fault_pressure": self.fault_pressure,
            "rejected_reasons": dict(self.rejected_reasons),
            "tenant_faults": {t: dict(h)
                              for t, h in self.tenant_faults.items()},
        }
        if plan_stats is not None:
            out["plan_cache"] = plan_stats
        if key_uploads is not None:
            out["key_uploads"] = key_uploads
        return out

    # -- crash-safe serving (repro_torch.serve.recovery) ----------------------------

    _STATE_FIELDS = (
        "admitted", "rejected", "served", "missed_deadlines", "steps",
        "groups_dispatched", "ops_executed", "ops_batched", "wait_time",
        "serve_time", "failed", "timed_out", "deadline_missed_at_pop",
        "shed", "transient_faults", "retries", "quarantined", "group_splits",
        "backoff_time", "hung_dispatches", "hang_escalations", "health",
        "fault_pressure",
    )

    def state_dict(self) -> dict:
        """All request-accounting counters (the launch/stage region
        snapshots — and the wall-clock dispatch histogram — are
        process-local and deliberately excluded)."""
        out = {f: getattr(self, f) for f in self._STATE_FIELDS}
        out["rejected_reasons"] = dict(self.rejected_reasons)
        out["tenant_faults"] = {t: dict(h)
                                for t, h in self.tenant_faults.items()}
        out["histograms"] = {"wait": self.wait_hist.state_dict(),
                             "serve": self.serve_hist.state_dict()}
        return out

    def load_state(self, state: dict) -> None:
        for f in self._STATE_FIELDS:
            setattr(self, f, state[f])
        self.rejected_reasons = dict(state["rejected_reasons"])
        self.tenant_faults = {t: dict(h)
                              for t, h in state["tenant_faults"].items()}
        # histograms arrived with the crash-safe-serving PR's successor;
        # older snapshots on disk simply lack the key — keep fresh ones
        hists = state.get("histograms")
        if hists is not None:
            self.wait_hist = Histogram.from_state(hists["wait"])
            self.serve_hist = Histogram.from_state(hists["serve"])
