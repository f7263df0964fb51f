"""The port's serving stack (``repro_torch.serve``, ``repro_torch.runtime``)
and its batched CKKS ops, against the JAX package.

Exact equality throughout, no tolerance.  Configuration: ``make_params(N=2⁹,
L=4, K=2, dnum=2)``, tenants "alice" and "bob" with
``keygen(rotations=(1,), seed=i)``; the port runs on the CPU, where every
kernel wrapper takes its plain version.

* Against recorded digests (no JAX): the port's ``hadd_many`` (add and
  sub), ``pmult_many``, ``hmult_many``, ``square_many`` and ``rescale_many``
  on both CKKS engines, against the JAX package's outputs on the same seeds
  (``batched_ops``, recorded by ``tests/make_torch_serve_ref.py
  --batched-ops``); the mixed wave of
  ``tests/torch_serve_wave.py`` served batched and sequentially on both
  engines — outputs, start order, key-store uploads and evictions, plan-cache
  accounting and a mid-wave snapshot — against the SHA-256 digests that
  ``tests/make_torch_serve_ref.py`` recorded from ``repro.serve`` into
  ``tests/torch_serve_ref.json``; the op trace of each serving against
  ``tests/torch_trace_ref.json``, ``pmult_many``'s one transform per
  plaintext pinned as the one difference.
* The port alone: staging and bit-flip faults under ``REPRO_GUARDS=full``,
  snapshot + journal recovery, tracing, the launcher, the hooks, and that no
  module of the port imports ``jax`` or ``repro``.
"""
import ast
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import torch_serve_wave as W
from make_torch_trace_ref import plus_plaintext_transforms, trace_record
from repro_torch.core import ckks, const_cache, guards, keys as K
from repro_torch.core import params as prm, trace as TR
from repro_torch.kernels import config
from repro_torch.runtime import faults, tracing
from repro_torch import serve as S

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tests", "torch_serve_ref.json")) as _f:
    REF = json.load(_f)
CFG = REF["config"]
with open(os.path.join(ROOT, "tests", "torch_trace_ref.json")) as _f:
    TRACE_REF = json.load(_f)["traces"]
ENGINES = ("fused", "eager")
RUNS = tuple(W.RUNS)


def params():
    return prm.make_params(N=CFG["N"], L=CFG["L"], K=CFG["K"], dnum=CFG["dnum"])


@pytest.fixture(scope="module")
def keysets():
    return W.keysets_for(K, params(), CFG, device=CPU)


# ------------------------------------------------ batched ops vs digests

@pytest.fixture(scope="module")
def port_ops(keysets):
    """The port's batched ops on both engines over ``W.batch_inputs``."""
    p, keys = params(), keysets["alice"]
    inputs = W.batch_inputs(W.port_api(CPU), keys, p)
    out = {"inputs": inputs}
    for engine in ENGINES:
        with ckks.use_engine(engine):
            out[engine] = W.batched_ops(ckks, *inputs, keys, p)
    return out


@pytest.mark.parametrize("op", W.BATCHED_OPS)
@pytest.mark.parametrize("engine", ENGINES)
def test_batched_op_matches_reference(port_ops, engine, op):
    """Each output's digest, scale, basis and domain equal the JAX package's
    (``batched_ops`` of tests/torch_serve_ref.json)."""
    got = port_ops[engine][op]
    assert all(c.a.data.dtype == torch.int32 for c in got)
    assert [W.ct_record(W.port_api(CPU), c) for c in got] == \
        REF["batched_ops"][engine][op]


@pytest.mark.parametrize("engine", ENGINES)
def test_hmult_many_equals_per_ciphertext_hmult(keysets, port_ops, engine):
    c1s, c2s, _, _ = port_ops["inputs"]
    keys = keysets["alice"]
    with ckks.use_engine(engine):
        for got, c1, c2 in zip(port_ops[engine]["hmult"], c1s, c2s, strict=True):
            want = ckks.hmult(c1, c2, keys)
            assert torch.equal(got.a.data, want.a.data)
            assert torch.equal(got.b.data, want.b.data)
            assert got.scale == want.scale


# ------------------------------------------------- served waves vs digests

@pytest.fixture(scope="module")
def waves(keysets):
    """{(engine, run): record} of the port's served waves on the CPU, each
    with the op trace of its serving under "trace"."""
    api, p = W.port_api(CPU), params()
    out = {}
    for engine in ENGINES:
        with ckks.use_engine(engine):
            for run in RUNS:
                t = TR.OpTrace()
                with tempfile.TemporaryDirectory() as tmp:
                    out[engine, run], _, _ = W.serve(
                        api, p, keysets, run, CFG, snapshot_dir=tmp,
                        during=lambda: TR.trace_ops(t))
                out[engine, run]["trace"] = t
    return out


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("engine", ENGINES)
def test_served_outputs_match_reference(waves, engine, run):
    assert waves[engine, run]["outputs"] == REF["engines"][engine][run]["outputs"]


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("engine", ENGINES)
def test_serve_accounting_matches_reference(waves, engine, run):
    """Start order (the admission queue's), key-store uploads and
    evictions, plan-cache hits and misses, dispatch counts."""
    got, want = waves[engine, run], REF["engines"][engine][run]
    for k in ("start_order", "keystore", "plans", "metrics"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("engine", ENGINES)
def test_snapshot_matches_reference(waves, engine, run):
    """The whole snapshot state, its ciphertext payloads included."""
    assert waves[engine, run]["snapshot"] == REF["engines"][engine][run]["snapshot"]


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("engine", ENGINES)
def test_served_wave_trace_matches_reference(waves, engine, run):
    """The serving's op trace (counts, calls, HE ops) equals the JAX
    package's (tests/torch_trace_ref.json) but for one pinned difference:
    ``pmult_many`` transforms its plaintexts in one launch, where the
    reference transforms each twice — the three program-B plaintexts at
    ℓ = L − 1, in one call batched and one call each sequentially."""
    want = TRACE_REF[f"serve_{run}"][engine]
    n_b = CFG["requests"] // 2
    calls = [[CFG["L"] - 1, CFG["N"], n_b]] if run == "batched" else \
        [[CFG["L"] - 1, CFG["N"], 1]] * n_b
    assert want["pmult_many"] == calls
    t = waves[engine, run]["trace"]
    got = plus_plaintext_transforms(trace_record(t), calls)
    assert got == {k: want[k] for k in ("counts", "calls", "he_ops")}
    assert not t.launches


@pytest.mark.parametrize("engine", ENGINES)
def test_batched_equals_sequential(waves, engine):
    b, s = waves[engine, "batched"], waves[engine, "sequential"]
    assert b["outputs"] == s["outputs"]
    assert b["metrics"]["ops_batched"] > 0 == s["metrics"]["ops_batched"]
    assert s["keystore"]["evictions"] > 0 == b["keystore"]["evictions"]


def test_served_wave_decodes_to_plaintext_math(keysets):
    from repro_torch.core import encoding as enc
    p = params()
    _, reqs, _ = W.serve(W.port_api(CPU), p, keysets, "batched", CFG)
    for req, z in reqs:
        out = req.result()["out"]
        got = enc.decode(K.decrypt(out, keysets[req.tenant].sk), out.scale,
                         out.basis, p.N, CFG["slots"])
        assert np.max(np.abs(got.real - W.expected(z))) < 1e-2


# ------------------------------------------------------------------ faults

def _outputs_by_rid(record):
    return {o["rid"]: o for o in record["outputs"]}


def _serve_under(plan, keysets, run="batched"):
    """Serve the wave with ``plan`` injected around the serving only (the
    requests are encrypted outside it)."""
    region = faults.inject(plan)
    record, _, eng = W.serve(W.port_api(CPU), params(), keysets, run, CFG,
                             during=lambda: region)
    return record, eng, region.injector


def test_staging_fault_retries_and_serves_every_request(keysets):
    record, eng, inj = _serve_under(
        faults.FaultPlan([faults.FaultSpec(site="stage", at=(0,))]), keysets)
    assert inj.fired["stage"] == 1 and eng.keystore.staging_retries == 1
    assert record["outputs"] == REF["engines"]["fused"]["batched"]["outputs"]


def test_staging_fault_twice_degrades_one_tenant_only(keysets):
    record, eng, _ = _serve_under(
        faults.FaultPlan([faults.FaultSpec(site="stage", at=(0, 1))]), keysets)
    want = _outputs_by_rid(REF["engines"]["fused"]["batched"])
    (bad,) = eng.keystore.degraded              # the first tenant staged
    assert eng.keystore.degrade_events == 1 and eng.keystore.staging_retries == 1
    for r in eng.completed + eng.failed:
        out = _outputs_by_rid(record)[r.rid]
        if r.tenant == bad:
            assert (out["status"], r.error) == ("failed", "tenant_degraded")
        else:
            assert out == want[r.rid]
    assert len(eng.completed) == len(eng.failed) == CFG["requests"] // 2


def test_bitflip_under_full_guards_quarantines_one_request(keysets):
    with guards.use_mode("full"):
        record, eng, inj = _serve_under(
            faults.FaultPlan([faults.FaultSpec(site="bitflip", at=(3,))], seed=5),
            keysets)
    want = _outputs_by_rid(REF["engines"]["fused"]["batched"])
    failed = [o for o in record["outputs"] if o["status"] != "ok"]
    assert inj.fired["bitflip"] == 1 and len(failed) == 1
    assert eng.metrics.quarantined == 1
    assert eng.failed[0].error.startswith("poisoned")
    for rid, out in _outputs_by_rid(record).items():
        if out["status"] == "ok":
            assert out == want[rid]


def test_launch_faults_do_not_fire_on_cpu_data(keysets):
    """The plain versions launch nothing, so a launch-site plan sees no
    event on the CPU (on the card it fires; chip_smoke.py serve_cross)."""
    record, _, inj = _serve_under(
        faults.FaultPlan([faults.FaultSpec(site="launch", rate=1.0)]), keysets)
    assert inj.events["launch"] == 0 and inj.fired["launch"] == 0
    assert record["outputs"] == REF["engines"]["fused"]["batched"]["outputs"]


def test_snapshot_and_journal_recover_the_same_bytes(keysets, tmp_path):
    api, p = W.port_api(CPU), params()
    store = S.TenantKeyStore(max_resident=2)
    for t, ks in keysets.items():
        store.register(t, ks)
    S.set_rid_counter(0)
    reqs = W.wave(api, p, keysets, CFG["requests"], CFG["base_seed"])
    eng = S.FheServeEngine(store, max_batch=6, journal=str(tmp_path / "wal"))
    for req, _ in reqs:
        assert eng.submit(req)
    eng.step()
    eng.snapshot(S.SnapshotStore(str(tmp_path / "snap")))
    eng.step()                                   # journaled, then "crash"
    eng.journal.close()
    fresh = S.TenantKeyStore(max_resident=2)
    for t, ks in keysets.items():
        fresh.register(t, ks)
    rec, report = S.recover(str(tmp_path / "snap"), str(tmp_path / "wal"), fresh,
                            device=CPU, max_batch=6)
    assert report["steps"] == 1 and report["admitted"] == 0
    rec.run_until_drained()
    rec.journal.close()
    want = _outputs_by_rid(REF["engines"]["fused"]["batched"])
    done = {r.rid: r for r in rec.completed}
    assert sorted(done) == sorted(want)
    for rid, r in done.items():
        out = r.result()["out"]
        assert out.a.device == CPU
        assert W.ct_digest(api, out) == want[rid]["sha256"]


def test_wire_round_trip_keeps_u32_bytes(keysets):
    from repro_torch.serve import recovery
    api, p = W.port_api(CPU), params()
    req, _ = W.make_request(api, p, keysets["alice"], "alice", 3,
                            W.programs(S)[1])
    d = recovery.request_to_wire(req)
    back = recovery.request_from_wire(json.loads(json.dumps(d)), device=CPU)
    assert json.dumps(recovery.request_to_wire(back)) == json.dumps(d)
    x = req.inputs["x"]
    assert d["inputs"]["x"]["a"]["data"] == recovery.poly_to_wire(x.a)["data"]
    assert torch.equal(back.inputs["x"].a.data, x.a.data)


# ------------------------------------------------- tracing, launcher, hooks

def test_tracing_span_summary_is_deterministic(keysets):
    summaries = []
    for _ in range(2):
        with tracing.capture() as tr:
            W.serve(W.port_api(CPU), params(), keysets, "batched", CFG)
        summaries.append(json.dumps(tr.span_summary(), sort_keys=True))
    assert summaries[0] == summaries[1]
    spans = json.loads(summaries[0])["spans"]
    assert spans["step/dispatch.hmult"]["count"] == 1
    assert tr.to_perfetto()["traceEvents"]
    assert config.get_launch_hook() is None and const_cache.get_stage_hook() is None


def test_launcher_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve as launcher
    launcher.main(["--device", "cpu", "--requests", "4", "--N", "512", "--L", "4"])
    assert "decrypt check" in capsys.readouterr().out
    launcher.main(["--mode", "lm", "--device", "cpu", "--requests", "2",
                   "--slots", "2", "--max-new", "3"])
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out


def test_launch_hook_runs_before_the_counter_moves():
    seen = []
    config.set_launch_hook(lambda fam, n: seen.append((fam, n,
                                                       config.launch_counts())))
    try:
        before = config.launch_counts()
        config.before_launch("eltwise")
        config.count_launch("eltwise", "efu")
        assert seen == [("eltwise", 1, before)]
        assert config.launches_since(before) == {"eltwise": 1}
        assert set(config.mode_launch_counts()) == {config.MODE}
    finally:
        config.set_launch_hook(None)


def test_stage_hook_fault_leaves_nothing_counted():
    n = const_cache.stage_events()
    inj = faults.FaultPlan([faults.FaultSpec(site="stage", at=(0,))])
    with faults.inject(inj):
        with pytest.raises(faults.StagingFault):
            const_cache.device_table(("test_torch_serve", n), lambda: np.arange(4),
                                     CPU)
        const_cache.record_stage(2)
    assert const_cache.stage_events_since(n) == 2


def test_no_module_of_the_port_imports_jax_or_the_reference():
    files = [os.path.join(d, f)
             for d, _, fs in os.walk(os.path.join(ROOT, "src", "repro_torch"))
             for f in fs if f.endswith(".py")]
    files += [os.path.join(ROOT, "chip_smoke.py"),
              os.path.join(ROOT, "tests", "torch_serve_wave.py")]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [(path, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 30 and not bad, bad
