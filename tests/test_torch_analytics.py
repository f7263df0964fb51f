"""The port's analytics against the JAX package: the cluster maps, the CiFHER
cost and area models, the virtual executor and the paper's workload traces,
and the launch crosscheck.

These modules are plain Python over integers and floats, so every case
compares the port with the live JAX package (whose analytics import ``jax``
but run no XLA computation) with exact ``==`` on every float, no tolerance.
The reference's own tests of them (``tests/test_workloads.py``,
``tests/test_tracing.py::test_cost_crosscheck_families``) are ported here,
the virtual executor held against the port's real traces at ``test_small``
on the CPU.  The Table III rows ``chip_smoke.py`` checks on the card come
from ``tests/torch_trace_ref.json`` (``tests/make_torch_trace_ref.py``), held
here to the live package.  Last, a subprocess imports every module of the
port and finds no ``jax`` and no ``repro`` module loaded.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from make_torch_trace_ref import trace_record
from repro_torch.core import area_model as A, ckks, cost_model as C
from repro_torch.core import encoding as enc, keys as K, params as prm
from repro_torch.core import trace as TR
from repro_torch.core.mapping import ClusterMap, all_cluster_maps, default_block
from repro_torch.runtime import tracing
from repro_torch.workloads import traces as W, virtual as PV
from repro_torch.workloads.virtual import VirtualCkks, VirtualCt

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "tests", "torch_trace_ref.json")) as _f:
    REF = json.load(_f)

MESHES = ((4, 4), (8, 8), (4, 8))
MAPS = [cm for mesh in MESHES for cm in all_cluster_maps(*mesh)]
MAP_IDS = [cm.name for cm in MAPS]
LIMB_DUP = ("auto", "on", "off")
CORES = (4, 8, 16, 32, 64)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's analytics modules."""
    pytest.importorskip("jax")
    from repro.core import area_model, cost_model, mapping
    from repro.core import params, trace
    from repro.runtime import tracing as jtracing
    from repro.workloads import traces, virtual
    return types.SimpleNamespace(A=area_model, C=cost_model, M=mapping,
                                 prm=params, TR=trace, tracing=jtracing,
                                 W=traces, V=virtual)


@pytest.fixture(scope="module")
def workloads(jx):
    """{name: (port trace, JAX trace)} of every paper workload."""
    return {name: (tf(), jx.W.WORKLOADS[name]()) for name, tf in W.WORKLOADS.items()}


def jmap(jx, cm):
    return jx.M.ClusterMap(cm.dx, cm.dy, cm.bh, cm.bw)


def map_view(cm) -> dict:
    """Everything a ClusterMap computes, for one map."""
    blocks = range(cm.n_limb_clusters)
    return {"name": cm.name, "n_cores": cm.n_cores, "block_size": cm.block_size,
            "n_limb_clusters": cm.n_limb_clusters,
            "coef_cluster_size": cm.coef_cluster_size,
            "limb_hops": cm.limb_cluster_hops(), "coef_hops": cm.coef_cluster_hops(),
            "max_hops": cm.max_cluster_hops(),
            "core_xy": [cm.core_xy(c) for c in range(cm.n_cores)],
            "block_of": [cm.block_of(*cm.core_xy(c)) for c in range(cm.n_cores)],
            "intra": [cm.intra_block_pos(*cm.core_xy(c)) for c in range(cm.n_cores)],
            "limb_members": [cm.limb_cluster_members(b) for b in blocks],
            "coef_members": [cm.coef_cluster_members(p)
                             for p in range(cm.block_size)]}


# ----------------------------------------------------------------- mapping

@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_all_cluster_maps_match_reference(jx, mesh):
    got = [(cm.dx, cm.dy, cm.bh, cm.bw) for cm in all_cluster_maps(*mesh)]
    want = [(cm.dx, cm.dy, cm.bh, cm.bw) for cm in jx.M.all_cluster_maps(*mesh)]
    assert got == want
    for cap in (1, 2, 4, 16):
        assert [cm.name for cm in all_cluster_maps(*mesh, cap)] == \
            [cm.name for cm in jx.M.all_cluster_maps(*mesh, cap)]
    d = default_block(*mesh)
    assert (d.bh, d.bw, d.name) == (jx.M.default_block(*mesh).bh,
                                    jx.M.default_block(*mesh).bw,
                                    jx.M.default_block(*mesh).name)


@pytest.mark.parametrize("cm", MAPS, ids=MAP_IDS)
def test_cluster_map_matches_reference(jx, cm):
    ref = jmap(jx, cm)
    assert map_view(cm) == map_view(ref)
    assert ClusterMap.parse(cm.name) == cm
    parsed = jx.M.ClusterMap.parse(cm.name)
    assert (parsed.dx, parsed.dy, parsed.bh, parsed.bw) == (cm.dx, cm.dy, cm.bh, cm.bw)
    mesh = cm.make_mesh("cpu")                # the distributed engine's mesh
    assert mesh.shape == {"limb": cm.n_limb_clusters, "coef": cm.block_size}


def test_cluster_map_rejects_what_the_reference_rejects(jx):
    for bad in ("4x4", "4x4-BK-3", "axb-DW"):
        with pytest.raises(ValueError):
            ClusterMap.parse(bad)
        with pytest.raises(ValueError):
            jx.M.ClusterMap.parse(bad)
    with pytest.raises(AssertionError):
        ClusterMap(4, 4, 3, 2)


# -------------------------------------------------------------- cost model

@pytest.mark.parametrize("limb_dup", LIMB_DUP)
@pytest.mark.parametrize("cm", MAPS, ids=MAP_IDS)
@pytest.mark.parametrize("name", list(W.WORKLOADS))
def test_estimate_and_nop_traffic_match_reference(jx, workloads, name, cm, limb_dup):
    mine, ref = workloads[name]
    rcm = jmap(jx, cm)
    lanes = 1024 // cm.n_cores
    got = C.estimate(mine, C.PackageConfig(cm=cm, lanes_per_core=lanes), limb_dup)
    want = jx.C.estimate(ref, jx.C.PackageConfig(cm=rcm, lanes_per_core=lanes),
                         limb_dup)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.edp, got.edap(123.25)) == (want.edp, want.edap(123.25))
    assert C.nop_traffic(mine, cm, limb_dup) == jx.C.nop_traffic(ref, rcm, limb_dup)
    assert C._fragmentation_util(mine, cm) == jx.C._fragmentation_util(ref, rcm)
    assert C._geometry_eta(cm) == jx.C._geometry_eta(rcm)


@pytest.mark.parametrize("n", CORES)
def test_default_package_and_predictions_match_reference(jx, workloads, n):
    got, want = C.default_package(n), jx.C.default_package(n)
    fields = lambda pkg: {k: v for k, v in dataclasses.asdict(pkg).items() if k != "cm"}
    assert fields(got) == fields(want) and got.cm.name == want.cm.name
    assert (got.n_cores, got.total_lanes) == (want.n_cores, want.total_lanes)
    for name, (mine, ref) in workloads.items():
        assert C.predict_launches(mine) == jx.C.predict_launches(ref), name
        assert dataclasses.asdict(C.estimate(mine, got)) == \
            dataclasses.asdict(jx.C.estimate(ref, want)), name


GRID_N_IN = (1, 2, 3, 4, 8, 12, 13, 16, 48)
GRID_N_OUT = (1, 2, 4, 6, 12, 16, 24, 46, 48, 60)
GRID_N = (None, 1 << 10, 1 << 16)


@pytest.mark.parametrize("cm", MAPS, ids=MAP_IDS)
def test_bconv_method_matches_reference(jx, cm):
    rcm = jmap(jx, cm)
    for n_in in GRID_N_IN:
        for n_out in GRID_N_OUT:
            for N in GRID_N:
                for dup in LIMB_DUP:
                    assert C.bconv_method(cm, n_in, n_out, N=N, limb_dup=dup) == \
                        jx.C.bconv_method(rcm, n_in, n_out, N=N, limb_dup=dup), \
                        (n_in, n_out, N, dup)


@pytest.mark.parametrize("cm", MAPS, ids=MAP_IDS)
def test_predict_collectives_matches_reference(jx, cm):
    rcm = jmap(jx, cm)
    for op in ("ntt", "intt", "auto"):
        assert C.predict_collectives(op, cm) == jx.C.predict_collectives(op, rcm)
    for n_in in GRID_N_IN:
        for n_out in GRID_N_OUT:
            for N in GRID_N:
                for dup in LIMB_DUP:
                    kw = dict(n_in=n_in, n_out=n_out, N=N, limb_dup=dup)
                    assert C.predict_collectives("bconv", cm, **kw) == \
                        jx.C.predict_collectives("bconv", rcm, **kw), kw
    with pytest.raises(ValueError):
        C.predict_collectives("gather", cm)


# -------------------------------------------------------------- area model

AREA_CASES = [(n, {}) for n in CORES] + [
    (16, {"lanes_per_core": 16}), (16, {"lanes_per_core": 256}),
    (64, {"bisection_bw": 4 * C.TB}), (4, {"bisection_bw": 0.5 * C.TB})]


@pytest.mark.parametrize("n,change", AREA_CASES,
                         ids=[f"{n}-{'-'.join(c) or 'default'}" for n, c in AREA_CASES])
def test_core_and_package_area_match_reference(jx, n, change):
    got = dataclasses.replace(C.default_package(n), **change)
    want = dataclasses.replace(jx.C.default_package(n), **change)
    assert dataclasses.asdict(A.core_area(got)) == dataclasses.asdict(jx.A.core_area(want))
    assert A.core_area(got).total == jx.A.core_area(want).total
    assert A.package_area(got) == jx.A.package_area(want)
    assert A.bisection_edges(got.cm) == jx.A.bisection_edges(want.cm)


# ------------------------------------------------------- virtual executor

def _virtual_ops(V, p, ct_level):
    """{op: fn(VirtualCkks) → VirtualCt or None} over every VirtualCkks op."""
    Ct = V.VirtualCt
    return {
        "mod_up": lambda v: v.mod_up(ct_level),
        "ks_inner": lambda v: v.ks_inner(ct_level),
        "key_switch": lambda v: v.key_switch(ct_level),
        "rescale": lambda v: v.rescale(Ct(ct_level)),
        "rescale_once": lambda v: v.rescale(Ct(ct_level), times=1),
        "hmult_rescale": lambda v: v.hmult(Ct(ct_level)),
        "hmult": lambda v: v.hmult(Ct(ct_level), rescale=False),
        "pmult_rescale": lambda v: v.pmult(Ct(ct_level)),
        "pmult": lambda v: v.pmult(Ct(ct_level), rescale=False),
        "hadd": lambda v: v.hadd(Ct(ct_level)),
        "hrot": lambda v: v.hrot(Ct(ct_level)),
        "hrot_hoisted": lambda v: v.hrot_hoisted(Ct(ct_level), 3),
        "hrot_hoisted_lazy": lambda v: v.hrot_hoisted(Ct(ct_level), 3,
                                                      lazy_moddown=True),
        "conjugate": lambda v: v.conjugate(Ct(ct_level)),
        "linear_transform_dense": lambda v: v.linear_transform(Ct(ct_level), 64),
        "linear_transform_3": lambda v: v.linear_transform(Ct(ct_level), p.slots, 3),
        "eval_chebyshev": lambda v: v.eval_chebyshev(Ct(ct_level), 47),
        "eval_chebyshev_all": lambda v: v.eval_chebyshev(Ct(ct_level), 15,
                                                         bsgs=False),
        "bootstrap": lambda v: v.bootstrap(Ct(1)),
        "bootstrap_dense": lambda v: v.bootstrap(Ct(1), n_slots=256),
    }


VIRTUAL_OPS = tuple(_virtual_ops(PV, prm.paper_full(), 1))
VIRTUAL_PARAMS = {"paper_full": (prm.paper_full, 40), "test_boot": (prm.test_boot, 12)}
VIRTUAL_FLAGS = {"default": {}, "no_min_ks_no_prng": {"use_min_ks": False,
                                                      "prng_evk": False}}


@pytest.mark.parametrize("flags", list(VIRTUAL_FLAGS))
@pytest.mark.parametrize("pset", list(VIRTUAL_PARAMS))
@pytest.mark.parametrize("op", VIRTUAL_OPS)
def test_virtual_op_matches_reference(jx, op, pset, flags):
    make, level = VIRTUAL_PARAMS[pset]
    p = make()
    jp = getattr(jx.prm, pset)()
    v = VirtualCkks(p, **VIRTUAL_FLAGS[flags])
    rv = jx.V.VirtualCkks(jp, **VIRTUAL_FLAGS[flags])
    got = _virtual_ops(PV, p, level)[op](v)
    want = _virtual_ops(jx.V, jp, level)[op](rv)
    assert trace_record(v.t) == trace_record(rv.t)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.level == want.level
    assert v.digits_at(level) == rv.digits_at(level)


@pytest.mark.parametrize("name", list(W.WORKLOADS))
def test_workload_traces_match_reference(jx, workloads, name):
    mine, ref = workloads[name]
    assert trace_record(mine) == trace_record(ref)
    assert mine.summary() == ref.summary()
    assert W.REPORT_DIVISOR[name] == jx.W.REPORT_DIVISOR[name]


def test_workload_constants_match_reference(jx):
    assert list(W.WORKLOADS) == list(jx.W.WORKLOADS)
    assert (W.HELR_ITERS, W.N_RESCALES_BETWEEN_BOOTS) == \
        (jx.W.HELR_ITERS, jx.W.N_RESCALES_BETWEEN_BOOTS)
    assert trace_record(W.trace_boot_amortized()) == \
        trace_record(jx.W.trace_boot_amortized())
    small, jsmall = prm.test_boot(), jx.prm.test_boot()
    for name in ("Boot", "HELR256"):
        assert trace_record(W.WORKLOADS[name](small)) == \
            trace_record(jx.W.WORKLOADS[name](jsmall))


# ----------------------------------------------------------- Table III rows

def test_table3_rows_equal_the_recorded_rows():
    """What chip_smoke.py prints beside the card's results."""
    assert W.table3_rows() == REF["table3"]
    assert len(REF["table3"]) == 3 * len(W.WORKLOADS)


def test_recorded_table3_equals_the_live_reference(jx):
    """The JSON's analytic part cannot go stale: the reference's
    ``benchmarks/bench_workloads.py:rows`` with each package's area."""
    sys.path.insert(0, ROOT)
    from benchmarks.bench_workloads import rows
    from make_torch_trace_ref import table3_rows
    assert table3_rows(rows, jx.A, jx.C) == REF["table3"]


# ------------------------------------------------------- launch crosscheck

def _jtrace(jx, t):
    """A JAX-package OpTrace with the port's trace's counters."""
    out = jx.TR.OpTrace()
    out.merge(t)
    return out


def test_cost_crosscheck_families():
    """tests/test_tracing.py::test_cost_crosscheck_families, on the port."""
    N = 1 << 9
    t = TR.OpTrace()
    t.add("ntt", 4, N)                    # predicted ntt: 2 (one ntt+intt)
    t.add("intt", 4, N)
    t.add("bconv_mul", 4, N)
    t.add("elt_mul", 4, N)
    t.add_launch("bconv", 1)              # observed: bconv exact...
    t.add_launch("eltwise", 2)            # ...eltwise over by 1
    xc = tracing.cost_crosscheck(t)
    fam = xc["families"]
    assert fam["ntt"] == {"predicted": 2, "observed": 0,
                          "deviation_pct": -100.0}
    assert fam["bconv"]["deviation_pct"] == 0.0
    assert fam["eltwise"] == {"predicted": 1, "observed": 2,
                              "deviation_pct": 100.0}
    assert fam["auto"] == {"predicted": 0, "observed": 0,
                           "deviation_pct": 0.0}
    assert xc["model_seconds"]["t_total"] > 0.0


@pytest.mark.parametrize("n_cores", (4, 16, 64))
def test_cost_crosscheck_matches_reference(jx, workloads, n_cores):
    """Same dict as the reference's, for launches observed over and under
    the prediction, an unpredicted family (inf) and the auto merge."""
    mine = TR.OpTrace()
    mine.merge(workloads["HELR256"][0])
    for fam, n in (("ntt", 7), ("automorphism", 2), ("auto_ks", 3),
                   ("eltwise", 10 ** 6)):
        mine.add_launch(fam, n)
    ref = _jtrace(jx, mine)
    assert tracing.cost_crosscheck(mine, n_cores=n_cores) == \
        jx.tracing.cost_crosscheck(ref, n_cores=n_cores)
    observed = {"bconv": 3, "ntt": 1}
    assert tracing.cost_crosscheck(mine, observed, n_cores) == \
        jx.tracing.cost_crosscheck(ref, observed, n_cores)
    empty = TR.OpTrace()
    empty.add_launch("automorphism")
    got = tracing.cost_crosscheck(empty)
    assert got == jx.tracing.cost_crosscheck(_jtrace(jx, empty))
    assert got["families"]["auto"]["deviation_pct"] == float("inf")


# --------------------- tests/test_workloads.py, on the port's CPU path

@pytest.fixture(scope="module")
def small():
    p = prm.test_small()
    ks = K.keygen(p, rotations=(1, 2), seed=0, device=CPU)
    scale = float(p.q[-1])
    ct = lambda seed: K.encrypt(
        enc.encode(np.random.default_rng(seed).normal(size=8), scale, p.q, p.N),
        scale, ks.sk, p.q, p.N, device=CPU)
    return p, ks, ct(0), ct(1)


def _limbs(t, funcs=("ntt", "intt")):
    return sum(e * c for (f, e, _), c in t.counts.items() if f in funcs)


@pytest.mark.parametrize("engine", ("fused", "eager"))
def test_virtual_matches_real_hmult(small, engine):
    p, ks, ct, _ = small
    with ckks.use_engine(engine), TR.trace_ops() as real:
        ckks.rescale(ckks.hmult(ct, ct, ks), p, times=1)
    v = VirtualCkks(p)
    v.hmult(VirtualCt(p.L), rescale=True)
    for key in ("ntt", "intt"):
        assert _limbs(real, (key,)) == _limbs(v.t, (key,)), key
    assert real.bconv_macs() == v.t.bconv_macs()


@pytest.mark.parametrize("engine", ("fused", "eager"))
def test_virtual_matches_real_rotation(small, engine):
    p, ks, ct, _ = small
    with ckks.use_engine(engine), TR.trace_ops() as real:
        ckks.hrot(ct, 1, ks)
    v = VirtualCkks(p)
    v.hrot(VirtualCt(p.L))
    assert _limbs(real) == _limbs(v.t)
    assert real.bconv_macs() == v.t.bconv_macs()


@pytest.mark.parametrize("engine", ("fused", "eager"))
def test_virtual_matches_real_hoisted_pair(small, engine):
    """What chip_smoke.py's analytics phase checks at paper_full."""
    p, ks, ct, _ = small
    with ckks.use_engine(engine), TR.trace_ops() as real:
        ckks.hrot_hoisted(ct, [1, 2], ks)
    v = VirtualCkks(p)
    v.hrot_hoisted(VirtualCt(p.L), 2)
    assert _limbs(real) == _limbs(v.t)
    assert real.bconv_macs() == v.t.bconv_macs()


@pytest.mark.parametrize("engine", ("fused", "eager"))
def test_virtual_matches_real_double_prime_rescale(engine):
    """hmult → the paper's double-prime rescale at test_medium."""
    p = prm.test_medium()
    ks = K.keygen(p, seed=0, device=CPU)
    scale = p.scale()
    ct = K.encrypt(enc.encode(np.full(8, 0.5), scale, p.q, p.N), scale, ks.sk,
                   p.q, p.N, device=CPU)
    with ckks.use_engine(engine), TR.trace_ops() as real:
        ckks.rescale(ckks.hmult(ct, ct, ks), p)
    v = VirtualCkks(p)
    v.hmult(VirtualCt(p.L), rescale=True)
    assert p.rescale_primes == 2
    assert _limbs(real) == _limbs(v.t) and real.bconv_macs() == v.t.bconv_macs()


def test_paper_scale_traces_build():
    for name, tf in W.WORKLOADS.items():
        s = tf().summary()
        assert s["limb_ntts"] > 0 and s["bconv_macs"] > 0, name
        assert s["he_ops"].get("KS", 0) > 0, name
    # the paper's premise: (i)NTT+BConv dominate the op mix
    s = W.trace_boot().summary()
    heavy = s["butterflies"] + s["bconv_macs"]
    assert heavy / (heavy + s["elt"] + s["auto"]) > 0.5


def test_cost_model_table2_area():
    paper = {4: 47.08, 16: 13.15, 64: 4.28}
    for n, want in paper.items():
        got = A.package_area(C.default_package(n))["core_mm2"]
        assert abs(got - want) / want < 0.15, (n, got, want)


def test_cost_model_fragmentation_orders_mappings():
    """§IV-B/§VI-D: block clustering beats pure coefficient scattering on
    NoP time at 64 cores; at 16 cores coefficient scattering stays
    competitive."""
    tr = W.trace_boot()

    def t_nop(dx, dy, bh, bw):
        pkg = C.PackageConfig(cm=ClusterMap(dx, dy, bh, bw),
                              lanes_per_core=1024 // (dx * dy))
        return C.estimate(tr, pkg).t_nop

    assert t_nop(8, 8, 4, 4) < t_nop(8, 8, 8, 8)
    assert t_nop(4, 4, 4, 4) < 1.5 * t_nop(4, 4, 2, 2)


def test_cost_model_eq3_limbdup():
    tr = W.trace_boot()
    cm = ClusterMap(4, 4, 2, 2)
    on = C.nop_traffic(tr, cm, limb_dup="on")
    auto = C.nop_traffic(tr, cm, limb_dup="auto")
    off = C.nop_traffic(tr, cm, limb_dup="off")
    assert auto["bconv"] <= max(on["bconv"], off["bconv"]) + 1e-9


def test_cost_model_scaling_saturates():
    """Fig. 9: 4→16 speeds up; 16→64 saturates (NoP-bound)."""
    tr = W.trace_boot()

    def t_at(shape):
        cm = ClusterMap(*shape, max(shape[0] // 2, 1), max(shape[1] // 2, 1))
        return C.estimate(tr, C.PackageConfig(cm=cm, lanes_per_core=128)).t_total

    t4, t16, t64 = t_at((2, 2)), t_at((4, 4)), t_at((8, 8))
    assert t16 < t4
    assert t64 > 0.5 * t16


def test_evk_bytes_prng_halving():
    p = prm.paper_full()
    v1 = VirtualCkks(p, prng_evk=True)
    v1.key_switch(48)
    v2 = VirtualCkks(p, prng_evk=False)
    v2.key_switch(48)
    assert v2.t.total("evk_load_bytes") == 2 * v1.t.total("evk_load_bytes")


# ---------------------------------------------------------- no JAX in port

def test_importing_the_whole_port_loads_no_jax():
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
assert len(names) > 40 and not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
