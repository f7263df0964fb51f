"""Structured tracing & profiling for the FHE serving runtime (the port of
``repro.runtime.tracing``).

CiFHER's evaluation attributes time to primitive functions (NTT / BConv /
automorphism, §VI) and interconnect traffic; this module makes that
attribution a *runtime* capability instead of an offline estimate: nestable
spans carried via ``contextvars``, with kernel launches, const/evk staging
uploads, fault firings, retries, and watchdog events attached to the
enclosing span through the existing hook points
(:func:`repro_torch.kernels.config.set_launch_hook`, which every kernel
wrapper runs just before it launches on card data,
:func:`repro_torch.core.const_cache.set_stage_hook`,
:func:`repro_torch.runtime.faults.set_fire_hook`).

Zero overhead when off is a hard contract:

* no tracer active → :func:`span` returns one shared no-op context manager,
  :func:`event`/:func:`annotate` are a single ``is None`` test, and **no
  hook is installed anywhere** — the kernel hot path is bit-identical to a
  build that never imported this module;
* ``REPRO_TRACE=off`` (and unset) therefore mean exactly the same thing;
  ``REPRO_TRACE=on`` starts a process-wide tracer at import.

Tracer activation chains through any previously-installed hook and restores
it on :func:`stop`; the fault injector's ``inject`` region does the same
(injector first, so a faulted launch raises before it reaches the tracer —
spans only ever count dispatches that retired; firings arrive separately
through the fire hook).

Exports per captured run:

* :meth:`Tracer.to_perfetto` — Chrome/Perfetto trace-event JSON
  (``{"traceEvents": [...]}``): engine spans on one process track, one
  timeline track per request (queued/active phases from the
  admit → start → terminal lifecycle events);
* :meth:`Tracer.span_summary` — a DETERMINISTIC span tree (counts +
  per-family launch / upload / fault attribution per span path, no
  wall-clock) that CI gates exactly across seeded runs;
* :func:`metrics_snapshot` / :func:`render_prometheus` — counters +
  p50/p95/p99 histograms as JSON or Prometheus exposition text.

The reference's ``cost_crosscheck`` (launches against the cost model's
prediction) waits for the port of ``core/cost_model.py``.
"""
from __future__ import annotations

import collections
import contextvars
import json
import math
import os
import threading
import time

from repro_torch.core import const_cache
from repro_torch.kernels import config as kconfig

# ----------------------------------------------------------------------------
# Streaming histogram (log-bucketed; shared with ServeMetrics)
# ----------------------------------------------------------------------------


class Histogram:
    """Streaming log-bucketed histogram with bounded relative quantile error.

    Buckets are geometric with ``bins_per_decade`` bins per decade over
    [lo, hi); values outside land in under/overflow buckets whose quantiles
    report the exact observed min/max.  A quantile is the geometric mean of
    its bucket's edges (clamped to [min, max]), so the relative error is
    bounded by ``10^(1/(2·bins_per_decade))`` ≈ 10 % at the default 12 —
    plenty for latency percentiles, constant memory, mergeable, and a
    deterministic integer state for crash-recovery round-trips.
    """

    __slots__ = ("lo", "hi", "bins_per_decade", "_log_lo", "nbins",
                 "counts", "count", "total", "min", "max")

    def __init__(self, lo: float = 1e-6, hi: float = 1e4,
                 bins_per_decade: int = 12):
        assert lo > 0.0 and hi > lo and bins_per_decade >= 1
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins_per_decade = int(bins_per_decade)
        self._log_lo = math.log10(self.lo)
        self.nbins = int(math.ceil(
            (math.log10(self.hi) - self._log_lo) * self.bins_per_decade))
        self.counts = [0] * (self.nbins + 2)      # [underflow] bins [overflow]
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def _bucket(self, x: float) -> int:
        if x < self.lo:
            return 0
        if x >= self.hi:
            return self.nbins + 1
        b = int((math.log10(x) - self._log_lo) * self.bins_per_decade)
        return min(b, self.nbins - 1) + 1

    def observe(self, x: float) -> None:
        x = float(x)
        self.counts[self._bucket(x)] += 1
        self.count += 1
        self.total += x
        self.min = x if self.min is None else min(self.min, x)
        self.max = x if self.max is None else max(self.max, x)

    def quantile(self, q: float) -> float:
        """Value at quantile ``q`` ∈ [0, 1] (0.0 when empty)."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        cum = 0
        for b, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                if b == 0:
                    return float(self.min)
                if b == self.nbins + 1:
                    return float(self.max)
                lo = 10.0 ** (self._log_lo + (b - 1) / self.bins_per_decade)
                hi = 10.0 ** (self._log_lo + b / self.bins_per_decade)
                return min(max(math.sqrt(lo * hi), self.min), self.max)
        return float(self.max)      # pragma: no cover — cum always reaches

    def merge(self, other: "Histogram") -> None:
        assert (self.lo, self.hi, self.bins_per_decade) == \
            (other.lo, other.hi, other.bins_per_decade)
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        for attr, pick in (("min", min), ("max", max)):
            a, b = getattr(self, attr), getattr(other, attr)
            setattr(self, attr, b if a is None else a if b is None
                    else pick(a, b))

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean": self.total / self.count if self.count else 0.0,
            "min": self.min if self.min is not None else 0.0,
            "max": self.max if self.max is not None else 0.0,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
        }

    # -- crash-safe state (serve.recovery round-trips this) --------------------

    def state_dict(self) -> dict:
        return {"lo": self.lo, "hi": self.hi,
                "bins_per_decade": self.bins_per_decade,
                "counts": list(self.counts), "count": self.count,
                "total": self.total, "min": self.min, "max": self.max}

    def load_state(self, state: dict) -> None:
        if (state["lo"], state["hi"], state["bins_per_decade"]) != \
                (self.lo, self.hi, self.bins_per_decade):
            raise ValueError("histogram state saved under different buckets")
        self.counts = list(state["counts"])
        self.count = int(state["count"])
        self.total = float(state["total"])
        self.min = state["min"]
        self.max = state["max"]

    @classmethod
    def from_state(cls, state: dict) -> "Histogram":
        h = cls(state["lo"], state["hi"], state["bins_per_decade"])
        h.load_state(state)
        return h


# ----------------------------------------------------------------------------
# Spans
# ----------------------------------------------------------------------------


class Span:
    """One completed (or open) region of the timeline.

    ``path`` is the name chain from the root (``("step", "dispatch.hmult")``)
    — the deterministic aggregation key of :meth:`Tracer.span_summary`;
    ``t0``/``t1`` are seconds relative to the tracer's start (Perfetto only).
    """

    __slots__ = ("name", "path", "attrs", "t0", "t1", "tid",
                 "launches", "uploads", "faults", "marks")

    def __init__(self, name: str, path: tuple, attrs: dict, t0: float,
                 tid: int):
        self.name = name
        self.path = path
        self.attrs = attrs
        self.t0 = t0
        self.t1 = t0
        self.tid = tid
        self.launches = collections.Counter()
        self.uploads = 0
        self.faults = collections.Counter()
        self.marks = collections.Counter()      # annotate() tallies


class _NullSpan:
    """The shared do-nothing span returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

_current: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "repro_trace_span", default=None)


class _SpanCtx:
    __slots__ = ("_name", "_attrs", "_tracer", "_span", "_token")

    def __init__(self, name: str, attrs: dict, tracer: "Tracer"):
        self._name = name
        self._attrs = attrs
        self._tracer = tracer

    def __enter__(self) -> Span:
        t = self._tracer
        parent = _current.get()
        path = (parent.path if parent is not None else ()) + (self._name,)
        s = Span(self._name, path, self._attrs, t.now(),
                 threading.get_ident())
        self._span = s
        self._token = _current.set(s)
        return s

    def __exit__(self, *exc):
        s = self._span
        s.t1 = self._tracer.now()
        _current.reset(self._token)
        self._tracer.spans.append(s)
        return False


# ----------------------------------------------------------------------------
# Tracer
# ----------------------------------------------------------------------------


class Tracer:
    """One capture: spans, instant events, request lifecycle, hook tallies."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self.spans: list[Span] = []             # completion order
        self.events: list[tuple] = []           # (name, ts, path, tid, attrs)
        self.request_events: list[tuple] = []   # (kind, rid, ts, attrs)
        self.launches = collections.Counter()   # tracer-wide (incl. no span)
        self.uploads = 0
        self.fault_fires = collections.Counter()

    def now(self) -> float:
        return self._clock() - self._t0

    # -- hook sinks (called with the tracer active) ---------------------------

    def _on_launch(self, family: str, n: int) -> None:
        self.launches[family] += n
        s = _current.get()
        if s is not None:
            s.launches[family] += n

    def _on_stage(self, n: int) -> None:
        self.uploads += n
        s = _current.get()
        if s is not None:
            s.uploads += n

    def _on_fire(self, site: str, index: int) -> None:
        self.fault_fires[site] += 1
        s = _current.get()
        self.events.append((f"fault.{site}", self.now(),
                            s.path if s is not None else (),
                            threading.get_ident(), {"index": index}))
        if s is not None:
            s.faults[site] += 1

    # -- deterministic span tree ----------------------------------------------

    def span_summary(self) -> dict:
        """Aggregate spans by path: counts + launch/upload/fault/mark
        attribution, NO wall-clock anywhere — byte-stable across seeded
        runs, so CI can require exact equality."""
        agg: dict = {}
        for s in self.spans:
            key = "/".join(s.path)
            d = agg.setdefault(key, {
                "count": 0, "launches": collections.Counter(), "uploads": 0,
                "faults": collections.Counter(),
                "marks": collections.Counter()})
            d["count"] += 1
            d["launches"] += s.launches
            d["uploads"] += s.uploads
            d["faults"] += s.faults
            d["marks"] += s.marks
        spans = {k: {"count": v["count"],
                     "launches": dict(sorted(v["launches"].items())),
                     "uploads": v["uploads"],
                     "faults": dict(sorted(v["faults"].items())),
                     "marks": dict(sorted(v["marks"].items()))}
                 for k, v in sorted(agg.items())}
        ev_counts = collections.Counter(name for name, *_ in self.events)
        terminals = collections.Counter(
            attrs.get("status", "?") for kind, _, _, attrs
            in self.request_events if kind == "terminal")
        return {
            "spans": spans,
            "events": dict(sorted(ev_counts.items())),
            "launches": dict(sorted(self.launches.items())),
            "uploads": self.uploads,
            "fault_fires": dict(sorted(self.fault_fires.items())),
            "requests": {
                "admitted": sum(1 for k, *_ in self.request_events
                                if k == "admit"),
                "started": sum(1 for k, *_ in self.request_events
                               if k == "start"),
                "terminal": dict(sorted(terminals.items())),
            },
        }

    # -- Chrome/Perfetto export -----------------------------------------------

    def to_perfetto(self) -> dict:
        """Trace-event JSON (https://ui.perfetto.dev loads it directly):
        engine spans as ``"X"`` slices on pid 1 (one tid per thread),
        instant events as ``"i"``, and one per-request timeline track on
        pid 2 (tid = rid) with queued/active phases."""
        us = lambda t: round(t * 1e6, 3)
        # compact thread ids: main-ish threads first by appearance
        tids: dict[int, int] = {}

        def tid_of(raw: int) -> int:
            return tids.setdefault(raw, len(tids) + 1)

        evs: list[dict] = [
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "fhe-serve engine"}},
            {"ph": "M", "pid": 2, "tid": 0, "name": "process_name",
             "args": {"name": "requests"}},
        ]
        for s in self.spans:
            args = {k: v for k, v in s.attrs.items()}
            if s.launches:
                args["launches"] = dict(sorted(s.launches.items()))
            if s.uploads:
                args["uploads"] = s.uploads
            if s.faults:
                args["faults"] = dict(sorted(s.faults.items()))
            if s.marks:
                args.update(sorted(s.marks.items()))
            evs.append({"ph": "X", "pid": 1, "tid": tid_of(s.tid),
                        "name": s.name, "cat": "span", "ts": us(s.t0),
                        "dur": max(us(s.t1) - us(s.t0), 0.0), "args": args})
        for name, ts, path, tid, attrs in self.events:
            evs.append({"ph": "i", "s": "t", "pid": 1, "tid": tid_of(tid),
                        "name": name, "cat": "event", "ts": us(ts),
                        "args": {**attrs, "span": "/".join(path)}})
        # per-request tracks from the admit → start → terminal lifecycle
        lifecycles: dict = {}
        for kind, rid, ts, attrs in self.request_events:
            lifecycles.setdefault(rid, {})[kind] = (ts, attrs)
        t_end = self.now()
        for rid in sorted(lifecycles):
            lc = lifecycles[rid]
            admit = lc.get("admit", (None, {}))[0]
            start = lc.get("start", (None, {}))[0]
            term, term_attrs = lc.get("terminal", (None, {}))
            status = term_attrs.get("status", "running")
            if admit is not None:
                q_end = start if start is not None else (
                    term if term is not None else t_end)
                evs.append({"ph": "X", "pid": 2, "tid": rid,
                            "name": "queued", "cat": "request",
                            "ts": us(admit),
                            "dur": max(us(q_end) - us(admit), 0.0),
                            "args": {"rid": rid}})
            if start is not None:
                a_end = term if term is not None else t_end
                evs.append({"ph": "X", "pid": 2, "tid": rid,
                            "name": f"active:{status}", "cat": "request",
                            "ts": us(start),
                            "dur": max(us(a_end) - us(start), 0.0),
                            "args": {"rid": rid, "status": status}})
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def write_perfetto(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f)
            f.write("\n")


# ----------------------------------------------------------------------------
# Activation (module-level; zero-overhead entry points)
# ----------------------------------------------------------------------------

_active: Tracer | None = None
_installed_launch = None
_installed_stage = None
_prev_launch = None
_prev_stage = None


def active_tracer() -> Tracer | None:
    return _active


def enabled() -> bool:
    return _active is not None


def _install_hooks(tracer: Tracer) -> None:
    global _installed_launch, _installed_stage, _prev_launch, _prev_stage
    from repro_torch.runtime import faults      # lazy: avoids import cycles
    _prev_launch = kconfig.get_launch_hook()
    _prev_stage = const_cache.get_stage_hook()
    prev_launch, prev_stage = _prev_launch, _prev_stage
    on_launch, on_stage = tracer._on_launch, tracer._on_stage

    if prev_launch is None:
        _installed_launch = on_launch
    else:
        def _launch(family, n):
            prev_launch(family, n)
            on_launch(family, n)
        _installed_launch = _launch
    if prev_stage is None:
        _installed_stage = on_stage
    else:
        def _stage(n):
            prev_stage(n)
            on_stage(n)
        _installed_stage = _stage
    kconfig.set_launch_hook(_installed_launch)
    const_cache.set_stage_hook(_installed_stage)
    faults.set_fire_hook(tracer._on_fire)


def _uninstall_hooks(tracer: Tracer) -> None:
    global _installed_launch, _installed_stage, _prev_launch, _prev_stage
    from repro_torch.runtime import faults
    # restore the saved hook only when ours is still the installed one —
    # an inject() region that wrapped us restores through its own exit
    if kconfig.get_launch_hook() is _installed_launch:
        kconfig.set_launch_hook(_prev_launch)
    if const_cache.get_stage_hook() is _installed_stage:
        const_cache.set_stage_hook(_prev_stage)
    if faults.get_fire_hook() == tracer._on_fire:
        faults.set_fire_hook(None)
    _installed_launch = _installed_stage = None
    _prev_launch = _prev_stage = None


def start(tracer: Tracer | None = None) -> Tracer:
    """Activate tracing process-wide (installs the chained hooks)."""
    global _active
    if _active is not None:
        raise RuntimeError("a tracer is already active")
    _active = tracer if tracer is not None else Tracer()
    _install_hooks(_active)
    return _active


def stop() -> Tracer:
    """Deactivate tracing; returns the captured tracer.  Hot paths are
    hook-free again the moment this returns."""
    global _active
    if _active is None:
        raise RuntimeError("no tracer active")
    t = _active
    _active = None
    _uninstall_hooks(t)
    return t


class capture:
    """``with tracing.capture() as tr:`` — start/stop as a context manager."""

    def __init__(self, tracer: Tracer | None = None):
        self._tracer = tracer

    def __enter__(self) -> Tracer:
        self.tracer = start(self._tracer)
        return self.tracer

    def __exit__(self, *exc):
        stop()
        return False


def span(name: str, **attrs):
    """Open a nestable span (no-op shared object when tracing is off)."""
    t = _active
    if t is None:
        return _NULL_SPAN
    return _SpanCtx(name, attrs, t)


def annotate(key: str, n: int = 1) -> None:
    """Add ``n`` to the current span's ``key`` tally (deterministic ints
    only — these land in the gated span summary)."""
    if _active is None:
        return
    s = _current.get()
    if s is not None:
        s.marks[key] += n


def event(name: str, **attrs) -> None:
    """Record an instant event attached to the enclosing span."""
    t = _active
    if t is None:
        return
    s = _current.get()
    t.events.append((name, t.now(), s.path if s is not None else (),
                     threading.get_ident(), attrs))


def request_event(kind: str, rid: int, **attrs) -> None:
    """Record a request lifecycle edge ("admit" | "start" | "terminal")."""
    t = _active
    if t is None:
        return
    t.request_events.append((kind, rid, t.now(), attrs))


# ----------------------------------------------------------------------------
# Metrics snapshot (Prometheus-style)
# ----------------------------------------------------------------------------


def metrics_snapshot(metrics=None) -> dict:
    """Point-in-time counters + histograms as plain JSON-able data.

    ``metrics`` is an optional :class:`repro_torch.serve.metrics.ServeMetrics`;
    without it the snapshot still carries the process-wide kernel-launch /
    staging counters (and the active tracer's tallies, when one is on).
    """
    snap: dict = {
        "kernel_launches": kconfig.launch_counts(),
        "kernel_launches_by_mode": kconfig.mode_launch_counts(),
        "stage_events": const_cache.stage_events(),
    }
    t = _active
    if t is not None:
        snap["trace"] = {"spans": len(t.spans),
                         "launches": dict(t.launches),
                         "uploads": t.uploads,
                         "fault_fires": dict(t.fault_fires)}
    if metrics is not None:
        snap["serve"] = metrics.summary()
        snap["histograms"] = {name: h.summary()
                              for name, h in metrics.histograms().items()}
    return snap


def render_prometheus(snap: dict, prefix: str = "repro") -> str:
    """Flatten a :func:`metrics_snapshot` dict into Prometheus exposition
    text (counters with labels, quantile gauges per histogram)."""
    lines: list[str] = []

    def emit(name, value, labels=None, kind=None):
        if kind:
            lines.append(f"# TYPE {prefix}_{name} {kind}")
        lab = ""
        if labels:
            body = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
            lab = "{" + body + "}"
        lines.append(f"{prefix}_{name}{lab} {value}")

    lines.append(f"# TYPE {prefix}_kernel_launches_total counter")
    for fam, n in sorted(snap.get("kernel_launches", {}).items()):
        emit("kernel_launches_total", n, {"family": fam})
    emit("stage_events_total", snap.get("stage_events", 0), None, "counter")
    serve = snap.get("serve", {})
    for key, v in sorted(serve.items()):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        emit(f"serve_{key}", v, None, "gauge")
    for name, h in sorted(snap.get("histograms", {}).items()):
        base = f"serve_{name}_seconds"
        lines.append(f"# TYPE {prefix}_{base} summary")
        for q in ("p50", "p95", "p99"):
            emit(base, h[q], {"quantile": {"p50": "0.5", "p95": "0.95",
                                           "p99": "0.99"}[q]})
        emit(f"{base}_count", h["count"])
        emit(f"{base}_sum", h["mean"] * h["count"])
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------------------------
# REPRO_TRACE env knob
# ----------------------------------------------------------------------------

_ENV_MODES = ("off", "on")
_env = os.environ.get("REPRO_TRACE", "off")
if _env not in _ENV_MODES:
    raise ValueError(
        f"REPRO_TRACE={_env!r} — must be one of {_ENV_MODES}")
if _env == "on":
    start()
