"""Resilience policy for the FHE serving engine: retry/backoff + overload
control.

Two concerns live here, both deterministic and unit-testable in isolation:

* :class:`RetryPolicy` — bounded exponential backoff with seeded jitter for
  *transient* faults (kernel-launch aborts, staging failures injected or
  real).  Deterministic guard violations are never retried — a corrupted
  operand stays corrupted; those go to poison-request quarantine instead
  (see ``repro_torch.serve.fhe``).
* :class:`OverloadController` — graceful degradation under sustained fault
  pressure.  An EMA of faults-per-step drives a three-state health machine:

      healthy  → full batch size
      degraded → batch size halves (smaller blast radius per wave, cheaper
                 replays when a wave does fault)
      shedding → batch size quarters AND the engine drops the
                 lowest-priority queued work beyond a bounded backlog

  surfaced through ``ServeMetrics`` as the engine's health state so
  operators see load shedding rather than silent queue growth.
* :class:`DispatchWatchdog` — bounds every kernel dispatch with a wall-clock
  deadline.  The dispatch runs on a worker thread; if it has not retired by
  the deadline the watchdog aborts its :class:`~repro_torch.runtime.faults.
  DispatchToken` (unblocking an injected stall, which unwinds as
  :class:`~repro_torch.runtime.faults.HungLaunch` before any result scatter) and
  raises :class:`DispatchHung` — a retryable
  :class:`~repro_torch.runtime.faults.FaultError`, safe because the batcher's
  scatter is transactional.  The engine escalates *repeated* hangs on the
  same group to split-and-quarantine with a typed ``hung`` failure detail
  (see ``repro_torch.serve.fhe``).
"""
from __future__ import annotations

import contextvars
import dataclasses
import threading

import numpy as np

from repro_torch.runtime import faults, tracing
from repro_torch.runtime.faults import FaultError

HEALTHY = "healthy"
DEGRADED = "degraded"
SHEDDING = "shedding"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff + seeded jitter.

    Attempt *k* (0-based) sleeps ``min(max_delay, base_delay·2^k)`` scaled by
    a uniform jitter in ``[1-jitter, 1+jitter]`` — the standard thundering-
    herd spreader.  ``max_retries=0`` disables retries entirely (the chaos
    bench's unprotected baseline).
    """
    max_retries: int = 3
    base_delay: float = 0.001
    max_delay: float = 0.050
    jitter: float = 0.25
    seed: int = 0

    def __post_init__(self):
        assert self.max_retries >= 0 and self.base_delay >= 0.0
        assert 0.0 <= self.jitter < 1.0

    def backoff(self, attempt: int, rng: np.random.Generator) -> float:
        """Delay before retry ``attempt`` (0-based)."""
        d = min(self.max_delay, self.base_delay * (2.0 ** attempt))
        return d * (1.0 + self.jitter * float(rng.uniform(-1.0, 1.0)))

    def bounds(self, attempt: int) -> tuple[float, float]:
        """[lo, hi] envelope of :meth:`backoff` for bound assertions."""
        d = min(self.max_delay, self.base_delay * (2.0 ** attempt))
        return d * (1.0 - self.jitter), d * (1.0 + self.jitter)


@dataclasses.dataclass
class OverloadController:
    """Fault-pressure EMA → health state → effective batch / shed decisions.

    ``record_fault`` is called per observed transient fault; ``end_step``
    folds the step's count into the EMA and decays it.  Hysteresis comes
    from the EMA itself: pressure must *stay* low for a few steps before the
    state recovers.
    """
    degrade_threshold: float = 0.5   # EMA faults/step to leave HEALTHY
    shed_threshold: float = 2.0      # EMA faults/step to start shedding
    alpha: float = 0.3               # EMA smoothing
    backlog_factor: int = 4          # shed queue beyond batch·factor
    pressure: float = 0.0
    _step_faults: int = 0

    def record_fault(self, n: int = 1) -> None:
        self._step_faults += n

    def end_step(self) -> None:
        self.pressure = ((1.0 - self.alpha) * self.pressure
                         + self.alpha * self._step_faults)
        self._step_faults = 0

    def state(self) -> str:
        if self.pressure >= self.shed_threshold:
            return SHEDDING
        if self.pressure >= self.degrade_threshold:
            return DEGRADED
        return HEALTHY

    def effective_batch(self, max_batch: int) -> int:
        """Batch-size ceiling under the current health state."""
        s = self.state()
        if s == HEALTHY:
            return max_batch
        if s == DEGRADED:
            return max(1, max_batch // 2)
        return max(1, max_batch // 4)

    def shed_count(self, queued: int, max_batch: int) -> int:
        """How many lowest-priority queued requests to drop this step."""
        if self.state() != SHEDDING:
            return 0
        keep = self.effective_batch(max_batch) * self.backlog_factor
        return max(0, queued - keep)


class DispatchHung(FaultError):
    """A dispatch blew its watchdog deadline.  Retryable (the stalled
    worker was unblocked pre-scatter), but the engine counts hang attempts
    separately and escalates repeats to a typed ``hung`` quarantine."""


class DispatchWatchdog:
    """Bound each kernel dispatch with a deadline; convert stalls into
    retryable faults.

    ``run(fn)`` executes ``fn`` on a worker thread and joins with
    ``deadline`` seconds.  On timeout it aborts the dispatch's cancellation
    token — an injected ``hang``/``delay`` blocked on that token unwinds
    as :class:`~repro_torch.runtime.faults.HungLaunch` without scattering any
    result — waits up to ``grace`` seconds for the worker to acknowledge,
    and raises :class:`DispatchHung`.  A real (non-injected) hung kernel
    cannot be interrupted from the host; the worker thread is daemonic and
    abandoned, which is exactly what a production watchdog can promise:
    the *engine* stays live even when a launch does not.

    ``escalate_after``: how many hangs the SAME group may absorb before
    the engine stops retrying and splits/quarantines it with a typed
    ``hung`` status (repeated hangs on one group mean the workload, not
    the weather — retrying forever would stall the whole engine, the
    exact failure this watchdog exists to bound).
    """

    def __init__(self, deadline: float = 0.5, grace: float = 0.1,
                 escalate_after: int = 2):
        assert deadline > 0.0 and grace >= 0.0 and escalate_after >= 1
        self.deadline = deadline
        self.grace = grace
        self.escalate_after = escalate_after
        self.timeouts = 0                    # dispatches abandoned
        self.slow_dispatches = 0             # completed but past deadline
        self.abandoned_workers = 0           # workers that never acknowledged

    def run(self, fn) -> None:
        token = faults.begin_dispatch()
        done = threading.Event()
        err: list[BaseException] = []
        # snapshot the caller's contextvars so the worker sees the enclosing
        # tracing span (contextvars do NOT propagate to threads by default);
        # spans the worker opens live and die inside the copy — no leakage
        # back into the engine thread
        ctx = contextvars.copy_context()

        def worker():
            faults.bind_dispatch_token(token)
            try:
                ctx.run(fn)
            except BaseException as e:       # noqa: BLE001 — relayed below
                err.append(e)
            finally:
                done.set()

        t = threading.Thread(target=worker, daemon=True,
                             name="dispatch-watchdog-worker")
        import time
        t0 = time.monotonic()
        t.start()
        try:
            if not done.wait(self.deadline):
                token.abort()
                finished = done.wait(self.grace)
                if finished and not err:
                    # completed at the wire before the abort landed — its
                    # results are already scattered and valid; replaying a
                    # scattered group would double-apply aliasing ops, so
                    # this is a slow dispatch, not a hang
                    self.slow_dispatches += 1
                    tracing.event("watchdog.slow")
                    return
                self.timeouts += 1
                if not finished:
                    self.abandoned_workers += 1
                tracing.event("watchdog.timeout", abandoned=not finished)
                raise DispatchHung(
                    f"dispatch exceeded {self.deadline}s watchdog deadline")
            if time.monotonic() - t0 > self.deadline:
                self.slow_dispatches += 1
                tracing.event("watchdog.slow")
            if err:
                raise err[0]
        finally:
            faults.end_dispatch()
