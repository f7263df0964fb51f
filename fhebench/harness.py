"""One run of one cell: set-up, a closed-loop window on the program's FHE
serving engine, the readings, and the check against the plain reference.

``run.py`` is the command; this module is what it and the tests call.
Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in ``configs/``, its mix in ``traffic/``, each metric's
reader in ``metrics/``.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
import types
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# The limits of the comparison that decides ``correct`` (PERF.md gives the
# readings each was set from).  Besides, one output of every client is
# checked.
LIMITS = {"decode_err_max": 1e-5, "limbs_inconsistent": 0, "wrong_level": 0,
          "requests_failed": 0}


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json"):
    bench = load_json(bench_path)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in {bench_path}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def reader(metric: str):
    """The ``read(obs)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"fhebench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def host_threads(config: dict, torch) -> None:
    """The deployment's thread count for torch's own CPU work."""
    torch.set_num_threads(config["deployment"]["torch_cpu_threads"])


def port_modules():
    from repro_torch import serve
    from repro_torch.core import encoding, keys, poly
    from repro_torch.core.params import CkksParams
    from repro_torch.kernels import config as kconfig
    from repro_torch.runtime import tracing
    return types.SimpleNamespace(serve=serve, encoding=encoding, keys=keys,
                                 poly=poly, CkksParams=CkksParams,
                                 kconfig=kconfig, tracing=tracing)


# --------------------------------------------------------------------------
# device clock: when the device finished a step
# --------------------------------------------------------------------------


class CudaMarks:
    """CUDA events after steps, read as host-clock seconds."""

    def __init__(self, torch):
        self.torch = torch
        torch.cuda.synchronize()
        self.base = torch.cuda.Event(enable_timing=True)
        self.base.record()
        self.base.synchronize()
        self.t_base = time.perf_counter()

    def mark(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def done(ev) -> bool:
        return ev.query()

    def wait(self, ev) -> float:
        ev.synchronize()
        return self.t_base + self.base.elapsed_time(ev) / 1e3


class HostMarks:
    """The CPU path (tests): work is done when the step returns."""

    def mark(self):
        return time.perf_counter()

    @staticmethod
    def done(ev) -> bool:
        return True

    @staticmethod
    def wait(ev) -> float:
        return ev


# --------------------------------------------------------------------------
# the closed loop
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Client:
    tenant: int
    cursor: int


class Loop:
    """Clients that each keep one request outstanding on the engine and
    resubmit when the device has finished the step that wrote its output."""

    def __init__(self, engine, tenants, traffic, port, marks):
        self.engine = engine
        self.tenants = tenants
        self.port = port
        self.marks = marks
        self.program = tuple(port.serve.HeOp(op["kind"], op["dst"],
                                             tuple(op["srcs"]), op.get("arg"))
                             for op in traffic["program"])
        self.outputs = tuple(traffic["outputs"])
        per = traffic["clients_per_tenant"]
        pool = traffic["pool_per_tenant"]
        self.clients = [Client(t, c % pool) for t in range(len(tenants))
                        for c in range(per)]
        self.meta: dict = {}                       # rid → (client, entry, t_sub)
        self.pending = collections.deque()         # (mark, done, failed)
        self.failed = 0
        self.submitted = 0

    def submit(self, ci: int) -> None:
        cl = self.clients[ci]
        ten = self.tenants[cl.tenant]
        entry = cl.cursor
        cl.cursor = (cl.cursor + 1) % len(ten.inputs)
        req = self.port.serve.FheRequest(
            tenant=ten.name, program=self.program, inputs=ten.inputs[entry],
            outputs=self.outputs, plaintexts=ten.plaintexts)
        t = time.perf_counter()
        self.submitted += 1
        if not self.engine.submit(req):
            self.failed += 1
            raise RuntimeError(f"request rejected: {req.error}")
        self.meta[req.rid] = (ci, entry, t)

    def run(self, again, on_done, record=None, tick=None) -> float:
        """Serve, then drain: ``on_done(req, client, entry, t_sub, t_fin)``
        for each completion, after which the client resubmits while
        ``again(client)``. Returns the host time at which the last step's
        work finished."""
        span = record or (lambda name: _Null())
        eng = self.engine
        with span("harness.submit"):
            for ci in range(len(self.clients)):
                self.submit(ci)
        t_last = time.perf_counter()
        while True:
            if tick is not None:
                tick()
            while self.pending and (self.marks.done(self.pending[0][0])
                                    or not (eng.active or eng.queue)):
                t_last = self._harvest(again, on_done, span)
            if eng.active or eng.queue:
                with span("harness.step"):
                    eng.step()
                if eng.completed or eng.failed:
                    self.pending.append((self.marks.mark(), list(eng.completed),
                                         list(eng.failed)))
                    eng.completed.clear()
                    eng.failed.clear()
            elif not self.pending:
                break
        return t_last

    def _harvest(self, again, on_done, span) -> float:
        """The oldest finished step's requests: record them, resubmit their
        clients. Their registers are freed when this returns."""
        mark, done, failed = self.pending.popleft()
        with span("harness.wait"):
            t_fin = self.marks.wait(mark)
        for req in done + failed:
            ci, entry, t_sub = self.meta.pop(req.rid)
            if req.status == "ok":
                on_done(req, ci, entry, t_sub, t_fin)
            else:
                self.failed += 1
            if again(ci):
                with span("harness.submit"):
                    self.submit(ci)
        return t_fin


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def count_work(engine, wparams, sink):
    """Wrap the batcher's dispatch so that every group's least work goes to
    ``sink`` (the harness's own probe around the serving layer's calls)."""
    from fhebench.work.model import op_work
    orig = engine.batcher.execute

    def execute(group):
        req, op = group[0]
        ell = len(req.env[op.srcs[0]].basis)
        pts = 0
        if op.kind == "pmult":
            pts = len({id(r.plaintexts[o.arg][0].data) for r, o in group})
        w = op_work(wparams, op.kind, ell, len(group),
                    op.arg if op.kind == "rescale" else None, pts)
        orig(group)
        sink(w)
    engine.batcher.execute = execute


# --------------------------------------------------------------------------
# the traced segment
# --------------------------------------------------------------------------


MARKER = "spin_kernel"


def profile_summary(trace_path: Path, host_spans: list, marks: tuple) -> dict:
    """Busy and idle time, device seconds by kernel, and idle gaps labelled
    by the innermost host span around them, from a Chrome trace of the
    card's kernels.  The stretch runs from the first marker kernel to the
    last; the first also ties the host clock (``marks``: the host times just
    before each marker was launched) to the trace's."""
    events = load_json(trace_path)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel" and "dur" in e),
                     key=lambda e: e["ts"])
    markers = [e for e in kernels if MARKER in e["name"]]
    kernels = [e for e in kernels if MARKER not in e["name"]]
    if len(markers) != 2:
        raise RuntimeError(f"the trace holds {len(markers)} of the 2 markers")
    lo, hi = markers[0]["ts"], markers[-1]["ts"]
    offset_us = lo - marks[0] * 1e6
    merged = []
    for e in kernels:
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)
    by_name, count = collections.Counter(), collections.Counter()
    for e in kernels:
        by_name[e["name"]] += e["dur"] / 1e6
        count[e["name"]] += 1
    host = sorted((t0 * 1e6 + offset_us, t1 * 1e6 + offset_us, name)
                  for t0, t1, name in host_spans)
    starts = [h[0] for h in host]
    gaps = collections.Counter()
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        label = "host, no span"
        # the innermost span around the gap: the latest one to start
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[k][1] >= mid:
                label = host[k][2]
                break
        gaps[label] += (g1 - g0) / 1e6
    return {"span_s": (hi - lo) / 1e6, "busy_s": busy_us / 1e6,
            "kernel_s": dict(by_name), "kernel_count": dict(count),
            "idle_gaps": dict(gaps)}


class HostSpans:
    """The harness's own spans on the host clock, kept while a trace runs."""

    def __init__(self):
        self.spans: list = []
        self.on = False

    def __call__(self, name: str):
        return _Span(self, name) if self.on else _Null()


class _Span:
    def __init__(self, owner: HostSpans, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.owner.spans.append((self.t0, time.perf_counter(), self.name))
        return False


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------


def prepare_environment() -> None:
    """Fixed cache folders inside the checkout; the program's defaults."""
    cache = ROOT / "build" / "fhebench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(cache / "autotune.json")
    for var in ("REPRO_GUARDS", "REPRO_TRACE"):
        os.environ.pop(var, None)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def run(cell: dict, config: dict, traffic: dict, metrics: list[dict], *,
        seed: int, seconds: float, trace: bool, device: str,
        t_proc0: float, fault=None) -> tuple[dict, dict]:
    """One run; returns (result line, checks). ``fault``, for the tests,
    is called with the port's modules before set-up and may break them."""
    import torch

    from fhebench import generator as gen
    from fhebench.reference import ckks as ref
    from fhebench.work import model as wm

    parts = {"start_s": time.perf_counter() - t_proc0}
    prepare_environment()
    port = port_modules()
    if fault is not None:
        fault(port)
    dev = torch.device(device)
    build_s = 0.0
    if dev.type == "cuda":
        from repro_torch.kernels import native
        t = time.perf_counter()
        native.build()
        build_s = time.perf_counter() - t
    parts["build_s"] = build_s
    params = port.CkksParams(N=config["N"], q=tuple(config["q"]),
                             p=tuple(config["p"]), dnum=config["dnum"],
                             rescale_primes=config["rescale_primes"])
    wparams = wm.Params.of(config)
    tenants = gen.make_tenants(traffic, params, config, seed, device, port,
                               parts)
    secrets = [ref.ternary_secret(t.key_seed, params.N) for t in tenants]
    for t, s in zip(tenants, secrets):
        if not np.array_equal(t.keyset.sk.s_small.astype(np.int64), s):
            raise SystemExit("the program's key generation no longer draws the "
                             "secret the reference expects from its seed")
    store = port.serve.TenantKeyStore(max_resident=len(tenants))
    for t in tenants:
        store.register(t.name, t.keyset)
    n_clients = len(tenants) * traffic["clients_per_tenant"]
    engine = port.serve.FheServeEngine(store, max_batch=n_clients,
                                       queue_capacity=max(1024, 2 * n_clients))
    marks_cls = (lambda: CudaMarks(torch)) if dev.type == "cuda" else HostMarks
    work = {"window": wm.Work(), "segment": wm.Work(), "on": None}

    def sink(w):
        work["window"].add(w)
        if work["on"] is not None:
            work["on"].add(w)
    count_work(engine, wparams, sink)

    # warm-up: the cell's own waves, every shape of the window
    t = time.perf_counter()
    warm = Loop(engine, tenants, traffic, port, marks_cls())
    served = collections.Counter()

    def warm_done(req, ci, entry, t_sub, t_fin):
        served[ci] += 1
    warm.run(lambda ci: served[ci] < traffic["warmup_waves"], warm_done)
    if warm.failed:
        raise RuntimeError(f"{warm.failed} warm-up requests failed")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    parts["warmup_s"] = time.perf_counter() - t
    work["window"] = wm.Work()
    segment = {}
    tick, record, finish = None, None, None
    if trace and dev.type == "cuda":
        tick, record, finish = _segment_tracer(torch, port, work, seconds, segment)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    # the deployment keeps what set-up built, which lives as long as the
    # server, out of the collector's way
    freeze = config["deployment"]["gc_freeze_after_setup"]
    if freeze:
        gc.collect()
        gc.freeze()

    # the window
    loop = Loop(engine, tenants, traffic, port, marks_cls())
    latencies = []
    # one output of every client (in a closed loop each client holds one
    # position of the batch), drawn from the seed among its completions
    sample_rng = gen.rng(seed, gen.STREAM_SAMPLE)
    picks = [None] * len(loop.clients)
    seen = [0] * len(loop.clients)
    m0 = (engine.metrics.ops_executed, engine.metrics.groups_dispatched,
          port.kconfig.total_launches())
    setup_s = time.perf_counter() - t_proc0
    t_start = time.perf_counter()
    t_end = t_start + seconds

    def on_done(req, ci, entry, t_sub, t_fin):
        if t_fin > t_end:
            return
        latencies.append((t_fin - t_sub) * 1e3)
        seen[ci] += 1
        if sample_rng.integers(0, seen[ci]) == 0:
            # copies: an output is a view of its whole batch's tensor
            picks[ci] = (loop.clients[ci].tenant, entry,
                         {o: (req.env[o].a.data.clone(), req.env[o].b.data.clone(),
                              req.env[o].a.domain == "ntt") for o in loop.outputs})

    pauses = _GcPauses()
    gc.callbacks.append(pauses)
    try:
        t_last = loop.run(lambda ci: time.perf_counter() < t_end, on_done,
                          record=record, tick=tick)
    finally:
        gc.callbacks.remove(pauses)
        if freeze:
            gc.unfreeze()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    attempts, overhead_s = finish() if finish is not None else ([], 0.0)
    m1 = (engine.metrics.ops_executed, engine.metrics.groups_dispatched,
          port.kconfig.total_launches())
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    samples = [x for x in picks if x is not None]
    completed_total = loop.submitted - loop.failed
    attempted = loop.submitted
    failed = loop.failed
    # the program's state is freed before the reference runs
    del engine, store, loop
    for t in tenants:
        t.keyset = t.inputs = t.plaintexts = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = check_outputs(ref, traffic, config, tenants, secrets, samples,
                           device, failed, n_clients)
    check_s = time.perf_counter() - t
    obs = {"setup_s": setup_s, "seconds": seconds,
           "latencies_ms": latencies, "loop_s": t_last - t_start - overhead_s,
           "ops": m1[0] - m0[0], "groups": m1[1] - m0[1],
           "launches": m1[2] - m0[2], "requests": completed_total,
           "params": wparams, "work": work["window"], "segment": segment or None}
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        obs["peak"] = wm.peaks(kind)
    wanted = [m for m in metrics if cell["name"] in m.get("workloads", [cell["name"]])]
    values = {}
    for m in wanted:
        v = reader(m["name"])(obs)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    if segment:
        device_info["busy_s"] = segment["busy_s"]
        device_info["window_s"] = segment["span_s"]
    correct = checks_pass(checks)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": values, "device": device_info, "setup_parts": parts,
              "check_s": check_s,
              "latency_ms": _quantiles(latencies),
              "completed_in_window": len(latencies),
              "gc_pauses": pauses.summary()}
    if trace:
        result["trace_attempts"] = attempts
    if segment:
        top = sorted(segment["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(segment["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [list(x) for x in top],
                               "idle_gaps": [list(x) for x in gaps]}
    result["checks"] = checks
    return result, checks


def _profiler_warmup(torch) -> None:
    """Start and stop the profiler once in set-up, so that the tracer's
    first-use start-up (seconds) is not paid inside the window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


# the program's own kernels, as the profiler names them
PORT_KERNELS = ("efu_kernel", "bconv_kernel", "ntt_fwd_kernel", "ntt_inv_kernel",
                "ntt_col_phase_kernel", "ntt_row_phase_kernel", "auto_ks_kernel",
                "perm_rows_kernel", "perm_cluster_kernel")


def _segment_tracer(torch, port, work, seconds, segment):
    """The traced run profiles steady stretches of 4.5 s inside the window:
    the card's kernels by the profiler (device activity only), the host by
    the program's tracing spans and the harness's own, tied together by a
    marker kernel at each end.  A stretch counts only if its trace is whole:
    both markers, their distance equal to the one CUDA events measure, and
    at least as many of the program's kernels as its launch counters counted (on
    this machine a profile has been seen to keep only its last tens of
    milliseconds).  Otherwise the next stretch is tried."""
    from torch.profiler import ProfilerActivity, profile
    _profiler_warmup(torch)
    spans = HostSpans()
    length = min(4.5, 0.15 * seconds)
    state = {"prof": None, "attempts": [], "overhead_s": 0.0}
    trace_path = ROOT / "build" / "fhebench" / "trace.json"

    def marker():
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        host = time.perf_counter()
        ev.record()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return host, ev

    def start():
        t = time.perf_counter()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        state.update(prof=prof, tracer=port.tracing.start(),
                     launches=port.kconfig.total_launches())
        state["m0"] = marker()
        spans.spans.clear()
        spans.on = True
        work["segment"].__init__()
        work["on"] = work["segment"]
        state["end"] = time.perf_counter() + length
        state["overhead_s"] += time.perf_counter() - t

    def stop():
        t = time.perf_counter()
        work["on"] = None
        spans.on = False
        m1 = marker()
        launches = port.kconfig.total_launches() - state["launches"]
        tracer_spans = port.tracing.stop().spans
        prof, state["prof"] = state["prof"], None
        prof.__exit__(None, None, None)
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
        t0 = state["tracer"]._t0
        host = spans.spans + [(t0 + s.t0, t0 + s.t1, s.name) for s in tracer_spans]
        m0 = state["m0"]
        span_s = m0[1].elapsed_time(m1[1]) / 1e3
        try:
            seg = profile_summary(trace_path, host, (m0[0], m1[0]))
            port_kernels = sum(n for k, n in seg.pop("kernel_count").items()
                               if any(p in k for p in PORT_KERNELS))
            ok = abs(seg["span_s"] - span_s) <= 0.01 * span_s and \
                port_kernels >= launches
            state["attempts"].append([port_kernels, launches, seg["span_s"], span_s])
        except RuntimeError as e:
            ok = False
            state["attempts"].append([repr(e)[:200], launches, None, span_s])
        trace_path.unlink()
        if ok:
            seg["work"] = work["segment"]
            segment.update(seg)
        state["next"] = time.perf_counter() + 1.0
        state["overhead_s"] += time.perf_counter() - t

    def tick():
        """Called at every turn of the loop; the first call opens the window."""
        now = time.perf_counter()
        if "next" not in state:
            state["next"] = now + min(2.0, 0.1 * seconds)
            state["close"] = now + seconds
        if state["prof"] is not None:
            if now >= state["end"]:
                stop()
        elif not segment and now >= state["next"] and \
                now + length + 0.5 < state["close"]:
            start()

    def finish() -> tuple[list, float]:
        """Close an open stretch; the attempts made and the seconds the
        profiler's starts, stops and readings took out of the window."""
        if state["prof"] is not None:
            stop()
        return state["attempts"], state["overhead_s"]
    return tick, spans, finish


class _GcPauses:
    """Python's garbage-collector passes during the window, by generation."""

    def __init__(self):
        self.t0 = None
        self.n = collections.Counter()
        self.s = collections.Counter()

    def __call__(self, phase, info):
        if phase == "start":
            self.t0 = time.perf_counter()
        elif self.t0 is not None:
            g = info["generation"]
            self.n[g] += 1
            self.s[g] += time.perf_counter() - self.t0

    def summary(self) -> dict:
        return {f"gen{g}": [self.n[g], self.s[g]] for g in sorted(self.n)}


def _quantiles(xs: list) -> dict:
    """Minimum, deciles and maximum of the window's latencies."""
    if not xs:
        return {}
    q = np.percentile(xs, [0, 10, 50, 90, 95, 99, 100])
    return dict(zip(("min", "p10", "p50", "p90", "p95", "p99", "max"),
                    (float(v) for v in q)))


def check_outputs(ref, traffic, config, tenants, secrets, samples, device,
                  failed, clients) -> dict:
    """Decrypt the sampled outputs with the reference and compare them with
    the program evaluated in float64; every one of the ``clients`` has to
    have given one."""
    import torch
    q, N = tuple(config["q"]), config["N"]
    ell = config["ell_in"]
    rp = config["rescale_primes"]
    scale = ref.encode_scale(q, ell, rp)
    decs = [ref.Decryptor(s, q, N, torch.device(device)) for s in secrets]
    meta = ref.levels_and_scales(
        traffic["program"], q, rp, {r: (ell, scale) for r in traffic["inputs"]},
        {p: scale for p in traffic["plaintexts"]})
    err, bad, wrong = 0.0, 0, 0
    cache = {}
    for tenant, entry, outs in samples:
        key = (tenant, entry)
        if key not in cache:
            t = tenants[tenant]
            cache[key] = ref.evaluate(traffic["program"], t.messages[entry],
                                      t.pt_messages)
        for reg, (a, b, ntt_domain) in outs.items():
            level, s = meta[reg]
            r = ref.check(decs[tenant], a, b, ntt_domain, level, s,
                          cache[key][reg])
            err = max(err, r["err"])
            bad += r["bad_limbs"]
            wrong += r["wrong_level"]
    return {"decode_err_max": {"value": err, "limit": LIMITS["decode_err_max"]},
            "limbs_inconsistent": {"value": bad,
                                   "limit": LIMITS["limbs_inconsistent"]},
            "wrong_level": {"value": wrong, "limit": LIMITS["wrong_level"]},
            "requests_failed": {"value": failed,
                                "limit": LIMITS["requests_failed"]},
            "outputs_checked": {"value": len(samples), "limit": clients}}


def checks_pass(checks: dict) -> bool:
    ok = checks["outputs_checked"]["value"] >= checks["outputs_checked"]["limit"]
    for name, c in checks.items():
        if name != "outputs_checked":
            ok = ok and c["value"] <= c["limit"]
    return bool(ok) and not math.isnan(checks["decode_err_max"]["value"])
