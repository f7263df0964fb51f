"""Deterministic fault injection for the FHE serving runtime (the port of
``repro.runtime.faults``).

CiFHER's chiplet argument is a resilience argument: small known-good dies
tolerate yield loss, and a package keeps working when individual components
misbehave.  This module makes that failure model *executable* — seeded,
scriptable fault plans that fire at the three places a real multi-chiplet
accelerator faults:

* **kernel-launch boundaries** — a transient chiplet fault aborts a dispatch
  before it retires.  Hooked through
  :func:`repro_torch.kernels.config.set_launch_hook`, which every kernel
  wrapper runs just before it launches: the fault fires before the kernel
  writes its output and before the launch counter moves — a retry of the op
  is always safe.  Only CUDA launches reach it: on CPU tensors the wrappers
  run their plain versions and launch nothing, so launch-site plans fire on
  card data only.
* **constant/evk staging uploads** — a failed host→package transfer.  Hooked
  through :func:`repro_torch.core.const_cache.set_stage_hook`, which both the
  constant cache's own staging copies and the serve keystore's
  ``record_stage`` reporting pass through.
* **limb-level bit-flip corruption** — silent data corruption in ciphertext
  residues.  The injector flips bit 31 of one (limb, coefficient) cell:
  every NTT prime is < 2³⁰ and residues are int32, so the flipped word reads
  negative — out of [0, q), the class of
  corruption the ``REPRO_GUARDS=full`` residue scan is guaranteed to catch.
  In-range corruption needs redundancy (e.g. replicated evaluation) that is
  out of scope here; see README §Robustness.
* **hung and delayed launches** — a dispatch that stalls at the launch
  boundary instead of aborting.  ``hang`` never completes (it unwinds as
  :class:`HungLaunch` when a :class:`repro_torch.serve.resilience.
  DispatchWatchdog` aborts its :class:`DispatchToken`, or when its scripted
  ``duration`` elapses unwatched); ``delay`` completes after ``duration``
  unless aborted first.  Both stall BEFORE the launch counter moves and
  before any result scatter, so abandoning a stalled dispatch is as safe as
  retrying an aborted one.

Determinism: each :class:`FaultSpec` owns an independent
``np.random.default_rng([seed, spec_index])`` stream and consumes exactly one
draw per event it observes, so the same plan over the same workload fires at
exactly the same events — replayable chaos.  The port counts NTT launches
the reference's serve path does not make, so a seed fires at other ops than
in the JAX package; a plan replays exactly against the port itself.

Usage::

    plan = FaultPlan([FaultSpec(site="launch", rate=0.01)], seed=7)
    with faults.inject(plan) as inj:
        engine.run_until_drained()
    inj.fired["launch"]      # how many dispatches faulted
"""
from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np

from repro_torch.core import const_cache
from repro_torch.kernels import config as kconfig

SITES = ("launch", "stage", "bitflip", "hang", "delay")

# sites that observe kernel-launch events and honor the per-family filter
LAUNCH_SITES = ("launch", "hang", "delay")


class FaultError(Exception):
    """Base class for injected *transient* faults — retryable by design."""


class TransientFault(FaultError):
    """A kernel dispatch aborted at the launch boundary (chiplet fault)."""


class StagingFault(FaultError):
    """A host→device constant/evk staging transfer failed."""


class HungLaunch(FaultError):
    """A dispatch stalled at the launch boundary past its bound.  Raised by
    the hung worker when its :class:`DispatchToken` is aborted (watchdog
    timeout) or its scripted duration elapses — never with results
    half-scattered, so a retry is always safe."""


class DispatchToken:
    """Cancellation token for one bounded dispatch.

    The watchdog (:class:`repro_torch.serve.resilience.DispatchWatchdog`)
    creates one per dispatch via :func:`begin_dispatch`; injected
    ``hang``/``delay`` waits block on it instead of bare sleeps, so a
    watchdog timeout UNBLOCKS the stalled worker thread, which then
    unwinds through :class:`HungLaunch` *before* any result scatter —
    an abandoned dispatch can never write back stale results.

    :meth:`commit` closes the remaining race for *real* (non-injected)
    slow dispatches: the batcher publishes results only inside the commit
    gate, which shares a lock with :meth:`abort`.  Either the abort lands
    first (the worker discards its results and unwinds as
    :class:`HungLaunch`) or the publication completes first (the watchdog
    finds the worker finished within its grace window and reports a slow
    dispatch, not a hang) — results are never both published and retried."""

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self.aborted = False

    def abort(self) -> None:
        with self._lock:
            self.aborted = True
            self._event.set()

    def wait(self, timeout: float | None) -> bool:
        """Block up to ``timeout`` seconds; True if aborted meanwhile."""
        self._event.wait(timeout)
        return self.aborted

    def commit(self):
        """Context manager gating result publication against :meth:`abort`;
        raises :class:`HungLaunch` when the dispatch was already abandoned."""
        return _CommitGate(self)


class _CommitGate:
    def __init__(self, token: DispatchToken):
        self._token = token

    def __enter__(self):
        self._token._lock.acquire()
        if self._token.aborted:
            self._token._lock.release()
            raise HungLaunch(
                "dispatch aborted by watchdog before result publication")
        return self

    def __exit__(self, *exc) -> bool:
        self._token._lock.release()
        return False


_current_token: DispatchToken | None = None
_thread_tokens = threading.local()


def begin_dispatch() -> DispatchToken:
    """Install a fresh cancellation token for the dispatch about to run
    (main thread, before the worker starts)."""
    global _current_token
    _current_token = DispatchToken()
    return _current_token


def end_dispatch() -> None:
    global _current_token
    _current_token = None


def bind_dispatch_token(token: DispatchToken | None) -> None:
    """Pin a token to THIS thread (the watchdog worker calls this first).

    Thread-local binding means an abandoned worker from a previous attempt
    keeps seeing its own (aborted) token — never the fresh token of the
    retry that replaced it — so its late results always hit a closed
    commit gate."""
    _thread_tokens.token = token


def current_dispatch_token() -> DispatchToken | None:
    tok = getattr(_thread_tokens, "token", None)
    return tok if tok is not None else _current_token


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault source in a plan.

    ``site``      — "launch" (kernel dispatch aborts), "stage"
                    (constant/evk upload), "bitflip" (ciphertext residue
                    corruption; consulted by the serving engine per
                    produced result), "hang" (dispatch stalls at the
                    launch boundary until a watchdog aborts it or
                    ``duration`` elapses — then aborts, never completes),
                    or "delay" (dispatch stalls ``duration`` seconds,
                    then proceeds normally).
    ``rate``      — per-event firing probability (seeded, deterministic).
    ``family``    — for launch-boundary sites ("launch"/"hang"/"delay"):
                    restrict to one kernel family ("ntt", "bconv",
                    "eltwise", "automorphism", "auto_ks"); None hits every
                    family.
    ``at``        — scripted firings: 0-based event indices (per site) that
                    fire regardless of ``rate`` — exact-replay scenarios.
    ``max_fires`` — stop firing after this many hits (None = unbounded).
    ``duration``  — "hang": seconds a stall blocks when NO watchdog aborts
                    it first (the unwatched-engine worst case; keep small
                    in tests).  "delay": seconds the slow launch takes.
    """
    site: str
    rate: float = 0.0
    family: str | None = None
    at: tuple[int, ...] = ()
    max_fires: int | None = None
    duration: float = 0.25

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} — one of {SITES}")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"fault rate {self.rate} outside [0, 1]")
        if self.duration < 0.0:
            raise ValueError(f"fault duration {self.duration} < 0")


class FaultPlan:
    """A seeded, scriptable set of fault specs.

    ``from_dict`` accepts ``{"seed": 7, "specs": [{"site": "launch",
    "rate": 0.01}, ...]}``.
    """

    def __init__(self, specs: list[FaultSpec] | tuple[FaultSpec, ...] = (),
                 seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        return cls([FaultSpec(**s) for s in d.get("specs", ())],
                   seed=d.get("seed", 0))

    def to_dict(self) -> dict:
        return {"seed": self.seed,
                "specs": [dataclasses.asdict(s) for s in self.specs]}


class FaultInjector:
    """Evaluates a :class:`FaultPlan` against the runtime's fault sites.

    One injector instance = one deterministic chaos run: per-spec rng
    streams, per-site event counters (``events``), per-site fired counters
    (``fired``), and the exact fired event log (``fired_log``) for
    determinism checks.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rngs = [np.random.default_rng([plan.seed, i])
                      for i in range(len(plan.specs))]
        self._spec_fired = [0] * len(plan.specs)
        self._spec_draws = [0] * len(plan.specs)     # rng stream positions
        self.events: collections.Counter = collections.Counter()
        self.fired: collections.Counter = collections.Counter()
        self.fired_log: list[tuple[str, int]] = []   # (site, event index)

    # -- state round-trip (crash-safe chaos: serve.recovery) -------------

    def state_dict(self) -> dict:
        """Replayable position of this injector: event counters, per-spec
        fired counts, and per-spec RNG *draw* counts (streams are
        counter-based, so a position is just how many draws happened)."""
        return {
            "plan": self.plan.to_dict(),
            "events": dict(self.events),
            "fired": dict(self.fired),
            "spec_fired": list(self._spec_fired),
            "spec_draws": list(self._spec_draws),
            "fired_log": [list(x) for x in self.fired_log],
        }

    def load_state(self, state: dict) -> None:
        """Fast-forward to a saved position (plan must match): rebuild each
        spec stream and burn its recorded draw count, so the next event
        consumes exactly the draw the uninterrupted run would have."""
        import json
        # canonicalize through JSON: a saved plan crossed a JSON round-trip,
        # so its tuples (spec lists, ``at`` indices) come back as lists
        canon = lambda d: json.loads(json.dumps(d))
        if canon(state["plan"]) != canon(self.plan.to_dict()):
            raise ValueError("injector state was saved under a different "
                             "fault plan")
        self.events = collections.Counter(state["events"])
        self.fired = collections.Counter(state["fired"])
        self._spec_fired = list(state["spec_fired"])
        self._spec_draws = list(state["spec_draws"])
        self.fired_log = [tuple(x) for x in state["fired_log"]]
        self._rngs = [np.random.default_rng([self.plan.seed, i])
                      for i in range(len(self.plan.specs))]
        for rng, n in zip(self._rngs, self._spec_draws):
            if n:
                rng.random(n)

    # -- core decision ---------------------------------------------------------

    def _consult(self, site: str, family: str | None = None):
        """One event at ``site``; returns the first matching spec that
        fires (truthy) or None."""
        idx = self.events[site]
        self.events[site] += 1
        hit = None
        for i, spec in enumerate(self.plan.specs):
            if spec.site != site:
                continue
            if site in LAUNCH_SITES and spec.family is not None \
                    and spec.family != family:
                continue
            if spec.max_fires is not None \
                    and self._spec_fired[i] >= spec.max_fires:
                continue
            # consume exactly one draw per observed event so the stream is
            # reproducible regardless of which specs fire
            if spec.rate > 0.0:
                draw = self._rngs[i].random()
                self._spec_draws[i] += 1
            else:
                draw = 1.0
            if idx in spec.at or draw < spec.rate:
                self._spec_fired[i] += 1
                hit = hit if hit is not None else spec
        if hit is not None:
            self.fired[site] += 1
            self.fired_log.append((site, idx))
            if _fire_hook is not None:
                _fire_hook(site, idx)
        return hit

    # -- site hooks ------------------------------------------------------------

    def _stall(self, spec: FaultSpec, family: str, complete: bool) -> None:
        """Serve one injected stall at the launch boundary.

        Blocks on the current :class:`DispatchToken` (when a watchdog
        bounds this dispatch) or a plain timed wait.  A ``delay``
        (``complete=True``) proceeds normally after its duration UNLESS
        the watchdog aborted meanwhile; a ``hang`` never completes — it
        raises :class:`HungLaunch` on abort or duration expiry, always
        BEFORE any result scatter."""
        token = current_dispatch_token()
        if token is not None:
            aborted = token.wait(None if not complete else spec.duration)
            if aborted:
                raise HungLaunch(
                    f"injected {spec.site} at {family} launch aborted by "
                    "watchdog")
            if complete:
                return
            raise HungLaunch(f"injected hang at {family} launch released")
        else:
            import time
            time.sleep(spec.duration)
            if complete:
                return
            raise HungLaunch(
                f"injected hang at {family} launch expired after "
                f"{spec.duration}s (no watchdog installed)")

    def on_launch(self, family: str, n: int) -> None:
        spec = self._consult("delay", family)
        if spec is not None:
            self._stall(spec, family, complete=True)
        spec = self._consult("hang", family)
        if spec is not None:
            self._stall(spec, family, complete=False)
        if self._consult("launch", family):
            raise TransientFault(
                f"injected transient fault at {family} launch "
                f"(event {self.events['launch'] - 1})")

    def on_stage(self, n: int) -> None:
        if self._consult("stage"):
            raise StagingFault(
                f"injected staging fault (event {self.events['stage'] - 1})")

    def maybe_corrupt(self, ct):
        """Consult the "bitflip" site for one produced ciphertext.

        Returns a corrupted copy (bit 31 set on one residue of ``a``, which
        reads negative in the int32 residues) when the site fires, else None;
        the copy lives on the ciphertext's own device.  Position selection
        draws from the plan seed, so corruption locations replay exactly.
        """
        if not self._consult("bitflip"):
            return None
        import torch

        from repro_torch.core import poly as pl
        from repro_torch.core.keys import Ciphertext
        rng = np.random.default_rng([self.plan.seed, 0xB17,
                                     self.fired["bitflip"]])
        data = pl.to_numpy(ct.a.data).copy()          # host u32 copy
        flat = data.reshape(-1)
        pos = int(rng.integers(0, flat.size))
        flat[pos] |= np.uint32(0x8000_0000)           # residue ≥ 2³¹ > q
        a = pl.RnsPoly(torch.as_tensor(data.view(np.int32), device=ct.a.device),
                       ct.a.basis, ct.a.domain)
        return Ciphertext(a, ct.b, ct.scale)


# ----------------------------------------------------------------------------
# Activation (module-level, context-managed)
# ----------------------------------------------------------------------------

_active: FaultInjector | None = None

# Optional fire notification: called as hook(site, event_index) whenever a
# fault spec fires, right after the injector logs it — NEVER on the result
# path, so it cannot perturb retry/replay behavior.  The tracing subsystem
# (runtime.tracing) attaches fault firings to the enclosing span here.
_fire_hook = None


def set_fire_hook(fn) -> None:
    """Install (or clear, with None) the fault-fired notification hook."""
    global _fire_hook
    _fire_hook = fn


def get_fire_hook():
    """The currently-installed fire hook (None when clear)."""
    return _fire_hook


def active_injector() -> FaultInjector | None:
    """The currently-installed injector (None outside an ``inject`` region)."""
    return _active


class inject:
    """Context manager installing a fault plan into the runtime's hooks.

    Kernel-launch and staging faults fire from inside the hooked counters;
    bit-flip corruption is consulted by the serving engine per produced
    result through :func:`active_injector`.  Nesting is rejected — one chaos
    run at a time keeps the determinism story simple.
    """

    def __init__(self, plan: FaultPlan):
        self.injector = FaultInjector(plan)

    def __enter__(self) -> FaultInjector:
        global _active
        if _active is not None:
            raise RuntimeError("a fault-injection region is already active")
        _active = self.injector
        # chain through any previously-installed hook (the tracer's) instead
        # of clobbering it.  Injector first: a faulted launch raises before
        # reaching the chained hook, so the tracer only ever sees dispatches
        # that actually retired — fault firings reach it via the fire hook.
        self._prev_launch = kconfig.get_launch_hook()
        self._prev_stage = const_cache.get_stage_hook()
        on_launch, prev_launch = self.injector.on_launch, self._prev_launch
        on_stage, prev_stage = self.injector.on_stage, self._prev_stage

        if prev_launch is None:
            self._launch_hook = on_launch
        else:
            def _launch(family, n):
                on_launch(family, n)
                prev_launch(family, n)
            self._launch_hook = _launch
        if prev_stage is None:
            self._stage_hook = on_stage
        else:
            def _stage(n):
                on_stage(n)
                prev_stage(n)
            self._stage_hook = _stage
        kconfig.set_launch_hook(self._launch_hook)
        const_cache.set_stage_hook(self._stage_hook)
        return self.injector

    def __exit__(self, *exc):
        global _active
        _active = None
        # restore the pre-region hooks — but only if ours are still the ones
        # installed (a consumer that replaced them mid-region wins)
        if kconfig.get_launch_hook() is self._launch_hook:
            kconfig.set_launch_hook(self._prev_launch)
        if const_cache.get_stage_hook() is self._stage_hook:
            const_cache.set_stage_hook(self._prev_stage)
        return False
