"""The port's serving stack (``repro_torch.serve``, ``repro_torch.runtime``)
and its batched CKKS ops, against the JAX package.

Exact equality throughout, no tolerance.  Configuration: ``make_params(N=2⁹,
L=4, K=2, dnum=2)``, tenants "alice" and "bob" with
``keygen(rotations=(1,), seed=i)``; the port runs on the CPU, where every
kernel wrapper takes its plain version.

* Live against JAX (skipped without ``jax``): one module-scoped fixture runs
  the JAX package's ``hadd_many`` (add and sub), ``pmult_many``,
  ``hmult_many``, ``square_many`` and ``rescale_many`` on both CKKS engines;
  the port repeats each on the same seeds.
* Against recorded digests (no JAX): the mixed wave of
  ``tests/torch_serve_wave.py`` served batched and sequentially on both
  engines — outputs, start order, key-store uploads and evictions, plan-cache
  accounting and a mid-wave snapshot — against the SHA-256 digests that
  ``tests/make_torch_serve_ref.py`` recorded from ``repro.serve`` into
  ``tests/torch_serve_ref.json``.
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
from repro_torch.core import ckks, const_cache, guards, keys as K
from repro_torch.core import params as prm, poly as pl
from repro_torch.kernels import config
from repro_torch.runtime import faults, tracing
from repro_torch import serve as S

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tests", "torch_serve_ref.json")) as _f:
    REF = json.load(_f)
CFG = REF["config"]
ENGINES = ("fused", "eager")
RUNS = tuple(W.RUNS)
LIVE_OPS = ("hadd", "hsub", "pmult", "hmult", "square", "rescale")


def params():
    return prm.make_params(N=CFG["N"], L=CFG["L"], K=CFG["K"], dnum=CFG["dnum"])


@pytest.fixture(scope="module")
def keysets():
    return W.keysets_for(K, params(), CFG, device=CPU)


# ------------------------------------------------------ batched ops, live JAX

def _batch_inputs(enc, encrypt, coeff_poly, keys, p):
    """Three ciphertext pairs and three plaintexts from fixed seeds."""
    scale = float(p.q[-1])
    rng = np.random.default_rng(7)
    zs = [rng.normal(size=8) for _ in range(9)]
    ct = lambda z, i: encrypt(enc.encode(z, scale, p.q, p.N), scale, keys.sk,
                              p.q, p.N, np.random.default_rng(50 + i))
    c1s = [ct(zs[i], i) for i in range(3)]
    c2s = [ct(zs[3 + i], 3 + i) for i in range(3)]
    pts = [coeff_poly(enc.encode(zs[6 + i], scale, p.q, p.N), p.q) for i in range(3)]
    return c1s, c2s, pts, [scale] * 3


def _batched_ops(C, c1s, c2s, pts, scales, keys, p):
    """{op: [ciphertext]} of every batched op on one engine."""
    prods = C.hmult_many(c1s, c2s, keys)
    return {"hadd": C.hadd_many(c1s, c2s), "hsub": C.hadd_many(c1s, c2s, sub=True),
            "pmult": C.pmult_many(c1s, pts, scales), "hmult": prods,
            "square": C.square_many(c1s, keys),
            "rescale": C.rescale_many(prods, p)}


def _np(ct):
    return {"a": np.asarray(ct.a.data, dtype=np.uint32),
            "b": np.asarray(ct.b.data, dtype=np.uint32), "scale": ct.scale,
            "basis": tuple(ct.basis), "domain": ct.a.domain}


@pytest.fixture(scope="module")
def port_ops(keysets):
    from repro_torch.core import encoding as enc
    p, keys = params(), keysets["alice"]
    inputs = _batch_inputs(
        enc, lambda m, s, sk, b, N, rng: K.encrypt(m, s, sk, b, N, rng=rng, device=CPU),
        lambda m, b: pl.RnsPoly(pl.to_tensor(m, CPU), b, pl.COEFF), keys, p)
    out = {"inputs": inputs}
    for engine in ENGINES:
        with ckks.use_engine(engine):
            out[engine] = _batched_ops(ckks, *inputs, keys, p)
    return out


@pytest.fixture(scope="module")
def live_ref(keysets, port_ops):
    """The JAX package's batched ops on both engines, as numpy, on the
    port's keys and ciphertexts carried across as u32 arrays (the port's
    keygen and encrypt give the JAX package's bytes: test_torch_ckks.py, and
    the served waves below) — JAX's own keygen and encryption would add a
    third to this fixture's time.  Almost all of the rest is XLA compiling
    each eager op once per shape; the fixture compiles them with XLA's
    optimizations off (integer results are the same) and restores the flag."""
    jax = pytest.importorskip("jax")
    saved = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return _live_ref(keysets, port_ops)
    finally:
        jax.config.update("jax_disable_most_optimizations", saved)


def _live_ref(keysets, port_ops):
    import jax.numpy as jnp

    from repro.core import ckks as jckks, keys as jK, params as jprm, poly as jpl
    p = jprm.make_params(N=CFG["N"], L=CFG["L"], K=CFG["K"], dnum=CFG["dnum"])
    poly = lambda x: jpl.RnsPoly(jnp.asarray(pl.to_numpy(x.data)), x.basis, x.domain)
    ek = lambda e: jK.EvalKey(seed=e.seed, b=[poly(b) for b in e.b], basis=e.basis)
    ks = keysets["alice"]
    keys = jK.KeySet(params=p, sk=jK.SecretKey(ks.sk.s_small.copy()),
                     relin=ek(ks.relin),
                     galois={g: ek(e) for g, e in ks.galois.items()})
    c1s, c2s, pts, scales = port_ops["inputs"]
    ct = lambda c: jK.Ciphertext(poly(c.a), poly(c.b), c.scale)
    inputs = ([ct(c) for c in c1s], [ct(c) for c in c2s], [poly(x) for x in pts],
              scales)
    out = {}
    for engine in ENGINES:
        with jckks.use_engine(engine):
            ops = _batched_ops(jckks, *inputs, keys, p)
        out[engine] = {op: [_np(c) for c in cts] for op, cts in ops.items()}
    return out


@pytest.mark.parametrize("op", LIVE_OPS)
@pytest.mark.parametrize("engine", ENGINES)
def test_batched_op_matches_reference(live_ref, port_ops, engine, op):
    for got, want in zip(port_ops[engine][op], live_ref[engine][op], strict=True):
        assert got.a.data.dtype == torch.int32
        assert (got.scale, got.basis, got.a.domain) == \
            (want["scale"], want["basis"], want["domain"])
        np.testing.assert_array_equal(pl.to_numpy(got.a.data), want["a"])
        np.testing.assert_array_equal(pl.to_numpy(got.b.data), want["b"])


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
    """{(engine, run): record} of the port's served waves on the CPU."""
    api, p = W.port_api(CPU), params()
    out = {}
    for engine in ENGINES:
        with ckks.use_engine(engine):
            for run in RUNS:
                with tempfile.TemporaryDirectory() as tmp:
                    out[engine, run], _, _ = W.serve(api, p, keysets, run, CFG,
                                                     snapshot_dir=tmp)
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
    with pytest.raises(SystemExit, match="not ported"):
        launcher.main(["--mode", "lm"])


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
