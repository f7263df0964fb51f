"""FheServeEngine: the multi-tenant, ciphertext-batched FHE serving engine
(the port of ``repro.serve.fhe``; tensors stay on the device the requests'
ciphertexts and the tenants' keys live on).

Composition of the serve subsystem (ROADMAP north star: sustained HE
throughput above the kernel layer):

* :class:`~repro_torch.serve.scheduler.AdmissionQueue` — deadline/priority
  admission with bounded capacity;
* :class:`~repro_torch.serve.keystore.TenantKeyStore` — per-tenant evk residency
  (LRU, per-step upload budget, staging-fault degradation);
* :class:`~repro_torch.serve.batcher.Batcher` — same-shaped ops from DIFFERENT
  requests stacked into one kernel dispatch;
* :class:`~repro_torch.serve.plans.PlanCache` — per-(op, level, batch, tenant)
  executors, resolved once;
* :class:`~repro_torch.serve.metrics.ServeMetrics` — request + deterministic
  dispatch accounting.

One :meth:`step` = fill the active slot set from the queue (respecting the
keystore's upload budget), take every active request's current op, group,
dispatch each group once, advance program counters, retire finished
requests.  Requests running the same program stay in lockstep and batch
perfectly; heterogeneous traffic batches opportunistically per op family.

``batching=False`` gives the sequential baseline: identical scheduling and
identical per-op arithmetic, but every op dispatches alone — the comparand
for throughput and for the bit-exactness check (``chip_smoke.py`` phase
``serve``, ``tests/test_torch_serve.py``).

**Fault tolerance**:

* transient faults (:class:`~repro_torch.runtime.faults.FaultError`) retry with
  bounded exponential backoff (:class:`~repro_torch.serve.resilience.RetryPolicy`);
  safe because the batcher's scatter is transactional — a faulted dispatch
  never half-writes a register file;
* deterministic invariant trips (:class:`~repro_torch.core.guards.GuardError`)
  are never retried: the group splits to singletons, the poisoned request
  is quarantined with a typed failure, and the rest of the wave replays
  bit-exactly;
* deadlines are enforced at pop time (already-expired work is dropped
  before it costs a dispatch) and at step boundaries for active requests;
* sustained fault pressure degrades gracefully via
  :class:`~repro_torch.serve.resilience.OverloadController`: batch sizes shrink
  (smaller blast radius, cheaper replays) and, under severe pressure, the
  lowest-priority queued work is shed with a typed status instead of
  letting the queue rot.  Health is surfaced through ``ServeMetrics``.

A request never returns a wrong answer: it either completes with verified
state transitions or reaches a typed terminal status
(``rejected|timeout|failed|shed``) whose :meth:`~repro_torch.serve.ir.FheRequest.
result` raises.
"""
from __future__ import annotations

import os
import time

import numpy as np

from repro_torch.core import guards
from repro_torch.runtime import faults, tracing
from repro_torch.runtime.faults import FaultError

from .batcher import Batcher
from .ir import KEYED_KINDS, FheRequest, LogicalClock, admission_check
from .journal import Journal
from .keystore import TenantDegraded, TenantKeyStore
from .metrics import ServeMetrics
from .plans import PlanCache
from .resilience import DispatchHung, OverloadController, RetryPolicy
from .scheduler import AdmissionQueue, QueueFull


class FheServeEngine:
    def __init__(self, keystore: TenantKeyStore, max_batch: int = 16,
                 batching: bool = True, queue_capacity: int = 1024,
                 clock=None, retry: RetryPolicy | None = None,
                 overload: OverloadController | None = None,
                 enforce_deadlines: bool = True, sleeper=None,
                 journal=None, watchdog=None):
        self.keystore = keystore
        self.max_batch = max_batch
        self.queue = AdmissionQueue(capacity=queue_capacity)
        self.plans = PlanCache()
        self.metrics = ServeMetrics()
        keystore.attach_metrics(self.metrics)
        self.batcher = Batcher(keystore, self.plans, batching=batching)
        self.active: list[FheRequest] = []
        self.completed: list[FheRequest] = []   # status "ok" only
        self.failed: list[FheRequest] = []      # typed terminal failures
        self.enforce_deadlines = enforce_deadlines
        self.retry = retry if retry is not None else RetryPolicy()
        self.overload = overload if overload is not None \
            else OverloadController()
        self._retry_rng = np.random.default_rng(self.retry.seed)
        self._retry_draws = 0                   # jitter-stream position
        self._sleep = sleeper if sleeper is not None else time.sleep
        # a journaled engine must be deterministic, so it defaults to the
        # logical clock; wall-clock engines keep their old behavior
        if isinstance(journal, (str, os.PathLike)):
            journal = Journal(journal)
        self.journal = journal
        self.watchdog = watchdog
        self._replaying = False
        if clock is None and journal is not None:
            clock = LogicalClock()
        self._clock = clock if clock is not None else time.monotonic

    def _journal(self, record: dict) -> None:
        """Write-ahead append (no-op without a journal / during replay)."""
        if self.journal is not None and not self._replaying:
            self.journal.append(record)

    # -- submission -----------------------------------------------------------

    def submit(self, req: FheRequest) -> bool:
        """Admit a request; False = rejected with a typed reason recorded on
        the request (``status="rejected"``, ``error=<reason>``) and in
        ``metrics.rejected_reasons``."""
        with tracing.span("admit", tenant=req.tenant):
            ok = self._admit(req)
        if ok:
            tracing.request_event("admit", req.rid, tenant=req.tenant)
        return ok

    def _admit(self, req: FheRequest) -> bool:
        try:
            ks = self.keystore.keyset(req.tenant)
        except KeyError:
            return self._reject(req, "unknown_tenant")
        if self.keystore.is_degraded(req.tenant) and any(
                op.kind in KEYED_KINDS for op in req.program):
            # degraded = this tenant's evks failed to stage; only its
            # KEY-consuming programs are refused — key-free arithmetic
            # still serves, and other tenants are never affected
            return self._reject(req, "tenant_degraded")
        reason = admission_check(
            req, ks,
            lambda r: self.keystore.supports_rotation(req.tenant, r),
            lambda: self.keystore.supports_conjugate(req.tenant))
        if reason is not None:
            return self._reject(req, reason)
        try:
            self.queue.push(req)
        except QueueFull:
            return self._reject(req, "queue_full")
        req.admitted_at = self._clock()
        if self.journal is not None and not self._replaying:
            from .recovery import request_to_wire
            self._journal({"type": "admit",
                           "req": request_to_wire(req, env="none")})
        self.metrics.admitted += 1
        return True

    def _reject(self, req: FheRequest, reason: str) -> bool:
        req.done = True
        req.status = "rejected"
        req.error = reason
        self.metrics.reject(reason)
        return False

    # -- terminal transitions -------------------------------------------------

    def _finish(self, req: FheRequest, now: float) -> None:
        self._journal({"type": "terminal", "rid": req.rid, "status": "ok"})
        req.done = True
        req.status = "ok"
        req.finished_at = now
        self.metrics.served += 1
        self.metrics.observe_serve(now - req.admitted_at)
        if req.finished_at > req.deadline:
            self.metrics.missed_deadlines += 1
        self.completed.append(req)
        tracing.request_event("terminal", req.rid, status="ok")

    def _fail(self, req: FheRequest, status: str, reason: str,
              now: float) -> None:
        self._journal({"type": "terminal", "rid": req.rid, "status": status,
                       "error": reason})
        req.done = True
        req.status = status
        req.error = reason
        req.finished_at = now
        if status == "timeout":
            self.metrics.timed_out += 1
        elif status == "shed":
            self.metrics.shed += 1
        else:
            self.metrics.failed += 1
        self.failed.append(req)
        tracing.request_event("terminal", req.rid, status=status,
                              reason=reason)

    # -- engine loop ----------------------------------------------------------

    def _expire_active(self, now: float) -> None:
        """Deadline enforcement at the step boundary: expired active work is
        cut before it costs another dispatch."""
        still = []
        for req in self.active:
            if req.deadline < now:
                self.metrics.missed_deadlines += 1
                self._fail(req, "timeout", "expired_mid_execution", now)
            else:
                still.append(req)
        self.active = still

    def _shed(self, now: float) -> None:
        k = self.overload.shed_count(len(self.queue), self.max_batch)
        if k:
            for req in self.queue.shed_lowest(k):
                self._fail(req, "shed", "load_shed", now)

    def _fill_slots(self, now: float) -> None:
        deferred = []
        cap = self.overload.effective_batch(self.max_batch)
        while self.queue and len(self.active) + len(deferred) < cap:
            head = self.queue.peek()
            if self.enforce_deadlines and head.deadline < now:
                # already expired: drop at pop, never spend a dispatch on it
                req = self.queue.pop()
                self.metrics.deadline_missed_at_pop += 1
                self.metrics.missed_deadlines += 1
                self._fail(req, "timeout", "expired_before_start", now)
                continue
            if not self.keystore.can_admit(head.tenant):
                # step upload budget spent: leave cold-tenant work queued
                # unless nothing is active at all (liveness beats budget)
                if self.active or deferred:
                    break
            req = self.queue.pop()
            try:
                if not self.keystore.is_degraded(req.tenant) or any(
                        op.kind in KEYED_KINDS for op in req.program):
                    with tracing.span("stage", tenant=req.tenant):
                        self.keystore.acquire(req.tenant)
            except TenantDegraded:
                self._fail(req, "failed", "tenant_degraded", self._clock())
                continue
            req.status = "active"
            req.started_at = self._clock()
            req.env = dict(req.inputs)
            req.pc = 0
            tracing.request_event("start", req.rid)
            self.metrics.observe_wait(req.started_at - req.admitted_at)
            if not req.program:             # nothing to run: retire directly
                self._finish(req, req.started_at)
                continue
            deferred.append(req)
        self.active.extend(deferred)

    def _execute_group(self, group, depth: int = 0) -> list:
        """Dispatch one group with the resilience policy applied.

        Transient :class:`FaultError`\\ s retry with backoff (the batcher's
        transactional scatter makes redispatch safe).  Deterministic
        :class:`GuardError`\\ s are never retried — a group of ≥2 splits into
        singleton replays to isolate the poisoned request; the singleton
        culprit is quarantined.  A watchdog :class:`DispatchHung` is
        retryable too (the stalled worker was unblocked pre-scatter), but
        hang attempts are counted separately and escalate to a typed
        ``hung`` split/quarantine after ``watchdog.escalate_after`` repeats
        — a group that hangs every time is the workload, not the weather.
        Returns ``[(req, status, reason), ...]`` for every request that
        could not be served.
        """
        attempt = 0
        hangs = 0
        kind = group[0][1].kind
        while True:
            try:
                with tracing.span(f"dispatch.{kind}", batch=len(group),
                                  attempt=attempt):
                    t0 = time.perf_counter()
                    if self.watchdog is not None:
                        self.watchdog.run(lambda: self.batcher.execute(group))
                    else:
                        self.batcher.execute(group)
                    self.metrics.observe_dispatch(time.perf_counter() - t0)
                    tracing.annotate("ops", len(group))
                self.metrics.groups_dispatched += 1
                self.metrics.ops_executed += len(group)
                if len(group) >= 2:
                    self.metrics.ops_batched += len(group)
                return []
            except DispatchHung as e:
                self.metrics.transient_faults += 1
                self.metrics.hung_dispatches += 1
                self.overload.record_fault()
                self._record_group_tenant_fault(group)
                hangs += 1
                if hangs >= self.watchdog.escalate_after \
                        or attempt >= self.retry.max_retries:
                    self.metrics.hang_escalations += 1
                    return self._split_or_quarantine(group, depth, "hung", e)
                self._backoff_group(attempt, group)
                attempt += 1
            except FaultError as e:
                self.metrics.transient_faults += 1
                self.overload.record_fault()
                self._record_group_tenant_fault(group)
                if attempt >= self.retry.max_retries:
                    return self._split_or_quarantine(
                        group, depth, "transient_fault", e)
                self._backoff_group(attempt, group)
                attempt += 1
            except guards.GuardError as e:
                return self._split_or_quarantine(group, depth, "poisoned", e)
            except TenantDegraded:
                # keyed groups are single-tenant: the whole group fails fast
                return [(req, "failed", "tenant_degraded") for req, _ in group]

    def _backoff_group(self, attempt: int, group) -> None:
        delay = self.retry.backoff(attempt, self._retry_rng)
        self._retry_draws += 1
        self.metrics.backoff_time += delay
        self._sleep(delay)
        self.metrics.retries += 1
        tracing.event("retry", attempt=attempt, batch=len(group))
        for req, _ in group:
            req.attempts += 1

    def _record_group_tenant_fault(self, group) -> None:
        """Keyed groups are single-tenant: pin the transient fault on that
        tenant's history (key-free groups span tenants — no attribution)."""
        req, op = group[0]
        if op.kind in KEYED_KINDS:
            self.metrics.record_tenant(req.tenant, transient_faults=1)

    def _split_or_quarantine(self, group, depth: int, reason: str, exc) -> list:
        if len(group) == 1:
            req, _ = group[0]
            if reason in ("poisoned", "hung"):
                self.metrics.quarantined += 1
            return [(req, "failed", f"{reason}: {exc}")]
        # evict the culprit by replaying each request alone; the batched and
        # singleton paths are bit-exact, so survivors lose nothing
        self.metrics.group_splits += 1
        failures = []
        for item in group:
            failures.extend(self._execute_group([item], depth + 1))
        return failures

    def _inject_and_check_outputs(self, group) -> list:
        """Post-dispatch: apply any scripted bit-flip corruption, then (full
        guard mode) scan result residues so corruption is quarantined at the
        step it happened instead of surfacing as a wrong decrypt."""
        inj = faults.active_injector()
        failures = []
        for req, op in group:
            if inj is not None:
                bad = inj.maybe_corrupt(req.env[op.dst])
                if bad is not None:
                    req.env[op.dst] = bad
            if guards.full():
                try:
                    guards.check_ciphertext(req.env[op.dst],
                                            f"post:{op.kind}")
                except guards.GuardError as e:
                    self.metrics.quarantined += 1
                    failures.append((req, "failed", f"poisoned: {e}"))
        return failures

    def step(self) -> int:
        """One serving iteration; returns the number of ops attempted."""
        with tracing.span("step"):
            return self._step()

    def _step(self) -> int:
        # write-ahead: the record commits the *intent* to run this step, so
        # a crash anywhere inside it replays the whole step from the same
        # pre-step state and lands in the same post-step state
        self._journal({"type": "step"})
        self.keystore.begin_step()
        now = self._clock()
        if self.enforce_deadlines:
            self._expire_active(now)
        self._shed(now)
        self._fill_slots(now)
        if not self.active:
            self.overload.end_step()
            self._update_health()
            return 0
        self.metrics.steps += 1
        ready = [(r, r.next_op) for r in self.active]
        failures = []
        for group in self.batcher.form_groups(ready):
            fs = self._execute_group(group)
            failures.extend(fs)
            dead = {req.rid for req, _, _ in fs}
            survivors = [it for it in group if it[0].rid not in dead]
            if survivors:
                failures.extend(self._inject_and_check_outputs(survivors))
        failed_by_rid = {req.rid: (status, reason)
                         for req, status, reason in failures}
        still = []
        now = self._clock()
        for req in self.active:
            if req.rid in failed_by_rid:
                status, reason = failed_by_rid[req.rid]
                self._fail(req, status, reason, now)
                continue
            req.pc += 1
            if req.pc >= len(req.program):
                self._finish(req, now)
            else:
                still.append(req)
        self.active = still
        self.overload.end_step()
        self._update_health()
        return len(ready)

    def _update_health(self) -> None:
        self.metrics.health = self.overload.state()
        self.metrics.fault_pressure = self.overload.pressure

    def run_until_drained(self, max_steps: int = 100_000) -> list[FheRequest]:
        """Serve until queue and active set are empty; returns completions
        (successes only — typed failures accumulate in ``self.failed``)."""
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        return self.completed

    # -- crash-safe serving (repro_torch.serve.recovery) ----------------------------

    def snapshot(self, store) -> str:
        """Publish a committed snapshot of the full engine state into a
        :class:`~repro_torch.serve.recovery.SnapshotStore`.

        Ordering is the durability contract: rotate the journal FIRST (the
        new segment index goes into the snapshot as its replay start),
        publish atomically, then drop the fully-covered older segments — a
        crash between any two of these leaves a consistent
        (snapshot, tail) pair on disk."""
        from . import recovery
        tail_from = self.journal.rotate() if self.journal is not None else 0
        path = store.save(recovery.engine_state(
            self, tail_from_segment=tail_from))
        if self.journal is not None:
            self.journal.drop_segments_before(tail_from)
        return path

    @classmethod
    def restore(cls, snapshot_dir: str, journal_dir: str,
                keystore: TenantKeyStore, **kwargs):
        """Rebuild an engine from disk (newest committed snapshot + journal
        tail replay); returns ``(engine, report)``.  See
        :func:`repro_torch.serve.recovery.recover`."""
        from . import recovery
        return recovery.recover(snapshot_dir, journal_dir, keystore,
                                **kwargs)

    # -- reporting ------------------------------------------------------------

    def summary(self) -> dict:
        return self.metrics.summary(plan_stats=self.plans.stats(),
                                    key_uploads=self.keystore.uploads)
