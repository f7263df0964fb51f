"""The port's distributed engine against the JAX package, in one process.

``repro_torch.core.distributed`` runs the paper's (limb, coef) cluster-map
engine on a mesh of logical shards on one device; here on the CPU, where every
kernel wrapper takes its plain version.  Held:

* the layouts and the Eq. 3 rule, live against the JAX package's pure-numpy
  functions;
* every primitive (four-step NTT both ways, BConv up and down, the
  slot-parallel AutoU) on every map of 1, 2, 4, 8 and 16 logical shards at
  ``make_params(N=256, L=8, K=2, dnum=4)``: bytes equal to the permuted
  single-device results, and both collective tallies (what the mesh executed,
  what ``count_collective`` recorded) equal to
  ``cost_model.predict_collectives``;
* hmult → rescale → ``hrot_hoisted([1, 2])`` under ``dist_scope`` on every
  map: digests equal to the JAX package's single-device eager engine's,
  recorded by ``tests/make_torch_dist_ref.py`` in ``tests/torch_dist_ref.json``
  (the inputs carried across: the port's keygen and encryption give the
  recorded bytes);
* at N = 1024 the pipeline's collectives equal ``BENCH_distributed.json``'s;
* Fig. 7 from the executed bytes; a corrupted exchange changes the answer.

Tolerance: exact equality of bytes and counts.  No subprocess.
"""
import json
import os

import numpy as np
import pytest
import torch

from make_torch_dist_ref import inputs_record
from repro_torch.core import _dist_selftest as S
from repro_torch.core import bconv as bc, ckks, cost_model as cost, distributed as D
from repro_torch.core import trace as TR
from repro_torch.core import params as prm, poly as pl, rns
from repro_torch.core.mapping import ClusterMap
from repro_torch.kernels import config
from repro_torch.kernels.automorphism import ops as auto_ops
from repro_torch.kernels.bconv import ops as bconv_ops
from repro_torch.kernels.ntt import ops as ntt_ops
from repro_torch.launch.mesh import make_fhe_mesh

CPU = "cpu"
HERE = os.path.dirname(__file__)
with open(os.path.join(HERE, "torch_dist_ref.json")) as _f:
    REF = json.load(_f)
with open(os.path.join(HERE, "..", "BENCH_distributed.json")) as _f:
    BENCH = json.load(_f)

SHARDS = (1, 2, 4, 8, 16)
MAPS = [cm for n in SHARDS for cm in S._maps_for(n)]


@pytest.fixture(scope="module")
def ref_jax():
    """The JAX package's pure-numpy layout functions (imports jax)."""
    pytest.importorskip("jax")
    from repro.core import distributed as RD
    return RD


def inputs(N):
    p = prm.make_params(N=N, L=8, K=2, dnum=4)
    ks, ct1, ct2 = S._make_inputs(p, device=CPU)
    return p, ks, ct1, ct2


@pytest.fixture(scope="module")
def n256():
    return inputs(256)


@pytest.fixture(scope="module")
def n1024():
    return inputs(1024)


def np_inputs(ks, ct1, ct2):
    """The port's inputs as numpy arrays, the shape ``inputs_record`` reads."""
    class Poly:
        def __init__(self, t):
            self.data = pl.to_numpy(t.data)

    class Ct:
        def __init__(self, c):
            self.a, self.b = Poly(c.a), Poly(c.b)

    class Key:
        def __init__(self, ek):
            self.seed, self.b = ek.seed, [Poly(b) for b in ek.b]

    class Keys:
        sk = ks.sk
        relin = Key(ks.relin)
        galois = {g: Key(ek) for g, ek in ks.galois.items()}
    return Keys, Ct(ct1), Ct(ct2)


# ----------------------------------------------------------------------------
# layouts and rules, live against the JAX package
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("N", [256, 1024])
def test_layouts_equal_the_reference(ref_jax, N):
    """ntt_layout_perm, coef_layout_perm and dist_layout for every block
    size the ring allows, and DistContext.submodules, equal the JAX
    package's; an impossible block size raises in both."""
    cs = 1
    while True:
        cm = ClusterMap(1, cs, 1, cs)
        ours, theirs = D.DistContext(cm, None), ref_jax.DistContext(cm, None)
        if cs * cs > N:
            with pytest.raises(ValueError):
                ours.submodules(N)
            with pytest.raises(ValueError):
                theirs.submodules(N)
            break
        R = ours.submodules(N)
        assert R == theirs.submodules(N)
        assert np.array_equal(D.ntt_layout_perm(N, R), ref_jax.ntt_layout_perm(N, R))
        assert np.array_equal(D.coef_layout_perm(N, R, cs),
                              ref_jax.coef_layout_perm(N, R, cs))
        for domain in (pl.COEFF, pl.NTT):
            for a, b in zip(D.dist_layout(N, R, cs, domain),
                            ref_jax.dist_layout(N, R, cs, domain)):
                assert np.array_equal(a, b)
        cs *= 2


def test_limb_sharding_and_eq3_equal_the_reference(ref_jax):
    for cm in MAPS + [ClusterMap(8, 8, 2, 1), ClusterMap(8, 8, 4, 4)]:
        ours, theirs = D.DistContext(cm, None), ref_jax.DistContext(cm, None)
        for ell in range(1, 20):
            assert ours.limb_sharded(ell) == theirs.limb_sharded(ell)
            for k in (1, 2, 4, 12, 48):
                assert (D.limbdup_beneficial(ell, k, cm)
                        == ref_jax.limbdup_beneficial(ell, k, cm))


def test_dist_scope_layout_roundtrip():
    """shard_poly/unshard_poly invert each other in both domains, and the
    two storage layouts are genuine permutations of the natural order."""
    N = 256
    basis = tuple(rns.gen_ntt_primes(4, N))
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, q, N, dtype=np.int64).astype(np.uint32)
                  for q in basis])
    with D.dist_scope(ClusterMap(1, 1, 1, 1), device=CPU) as ctx:
        R = ctx.submodules(N)
        for domain in (pl.COEFF, pl.NTT):
            perm, inv = D.dist_layout(N, R, ctx.cs, domain)
            assert np.array_equal(np.sort(perm), np.arange(N))
            assert np.array_equal(perm[inv], np.arange(N))
            p = pl.RnsPoly(pl.to_tensor(x, CPU), basis, domain)
            back = D.unshard_poly(D.shard_poly(p, ctx), ctx)
            assert np.array_equal(pl.to_numpy(back.data), x)
    assert D.dist_active() is None


# ----------------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------------

def _a2a_loops(x, A, s, c):
    n = x.shape[A]
    return torch.stack([torch.cat([x.select(A, src).chunk(n, dim=s - 1)[dst]
                                   for src in range(n)], dim=c - 1)
                        for dst in range(n)], dim=A)


@pytest.mark.parametrize("axis", D.AXES)
def test_mesh_collectives_move_blocks(axis):
    """all_to_all and all_gather against block-by-block loops, each a new
    buffer, tallied with the bytes moved between distinct blocks."""
    mesh = D.Mesh(2, 4, CPU)
    A = D.AXES.index(axis)
    n = mesh.shape[axis]
    x = torch.arange(2 * 4 * 8 * 8 * 16, dtype=torch.int32).reshape(2, 4, 8, 8, 16)
    nbytes = x.numel() * 4
    for s, c in ((-1, -2), (-2, -1), (-1, -3), (-3, -2)):
        snap = mesh.snapshot()
        got = mesh.all_to_all(x, axis, s, c)
        assert torch.equal(got, _a2a_loops(x, A, x.dim() + s, x.dim() + c))
        assert got.data_ptr() != x.data_ptr()
        assert mesh.since(snap) == ({"all_to_all": 1},
                                    {"all_to_all": nbytes * (n - 1) // n})
    for d in (-1, -2, -3):
        snap = mesh.snapshot()
        got = mesh.all_gather(x, axis, d)
        g = torch.cat([x.select(A, k) for k in range(n)], dim=x.dim() + d - 1)
        assert torch.equal(got, torch.stack([g] * n, dim=A))
        assert mesh.since(snap) == ({"all_gather": 1},
                                    {"all_gather": nbytes * (n - 1)})


def test_mesh_places_and_collects_blocks():
    """Block (i, j) of a placed tensor is its i-th limb slice by its j-th
    coefficient slice; a replicated operand gives every cluster all limbs;
    collect inverts place."""
    mesh = D.Mesh(2, 4, CPU)
    x = torch.arange(3 * 4 * 32, dtype=torch.int32).reshape(3, 4, 32)
    b = mesh.place(x, True)
    assert b.shape == (2, 4, 3, 2, 8)
    assert torch.equal(b[1, 2], x[:, 2:4, 16:24])
    r = mesh.place(x, False)
    assert r.shape == (2, 4, 3, 4, 8) and torch.equal(r[1, 3], x[:, :, 24:])
    assert torch.equal(mesh.collect(b, True, (3,)), x)
    assert torch.equal(mesh.collect(r.contiguous(), False, (3,)), x)
    with pytest.raises(ValueError):
        mesh.all_to_all(b, "rows", -1, -2)
    with pytest.raises(ValueError):
        D.Mesh(2, 2, "meta").place(x, True)


def test_make_fhe_mesh_and_cluster_map_mesh():
    """make_fhe_mesh derives (limb, coef) from the core count and rejects a
    non-divisor with the reference's message; ClusterMap.make_mesh gives
    (limb clusters, block size)."""
    m = make_fhe_mesh(limb_clusters=4, n_cores=16, device=CPU)
    assert m.shape == {"limb": 4, "coef": 4} and m.device == torch.device(CPU)
    assert make_fhe_mesh(limb_clusters=1, n_cores=8, device=CPU).shape == \
        {"limb": 1, "coef": 8}
    assert make_fhe_mesh(device=CPU).shape == {"limb": 4, "coef": 4}
    for lc, n in ((3, 8), (0, 8), (5, 16)):
        with pytest.raises(ValueError, match="does not divide"):
            make_fhe_mesh(limb_clusters=lc, n_cores=n, device=CPU)
    for cm in MAPS:
        mesh = cm.make_mesh(CPU)
        assert (mesh.lc, mesh.cs) == (cm.n_limb_clusters, cm.block_size)


def test_collective_counters():
    before = config.collective_counts()
    shard_before = config.collective_shard_counts().get("all_to_all", 0)
    config.count_collective("all_to_all", 2, shards=8)
    assert config.collectives_since(before) == {"all_to_all": 2}
    assert config.collective_shard_counts()["all_to_all"] - shard_before == 16


# ----------------------------------------------------------------------------
# primitives and the pipeline on every map
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("cm", MAPS, ids=[cm.name for cm in MAPS])
def test_primitives_exact_and_tallies_match(n256, cm):
    """NTT, iNTT, BConv up and down, AutoU: bytes equal to the permuted
    single-device results; executed collectives and count_collective both
    equal the prediction; no kernel launched on CPU data."""
    p = n256[0]
    config.reset_launches()
    with D.dist_scope(cm, device=CPU) as ctx:
        prims = S._prim_checks(ctx, p, np.random.default_rng(11), CPU)
    assert config.launch_counts() == {}
    for op, res in prims.items():
        assert res["exact"] and res["counts_match"], (cm.name, op, res)
        assert res["executed"] == res["predicted"], (cm.name, op, res)
    for tag, src, dst in (("bconv_up", p.p, p.q), ("bconv_down", p.q, p.p)):
        assert prims[tag]["method"] == cost.bconv_method(cm, len(src), len(dst), N=p.N)


def test_every_bconv_method_runs():
    p = prm.make_params(N=256, L=8, K=2, dnum=4)
    methods = {cost.bconv_method(cm, len(s), len(d), N=p.N)
               for cm in MAPS for s, d in ((p.p, p.q), (p.q, p.p),
                                           (p.q[:2], p.q[2:7] + p.p))}
    assert methods == {"local", "ark", "limbdup"}


def _stacked_limbdup(mesh, x, src, dst, limb_in):
    """Limb duplication as one conversion per limb cluster, stacked (what the
    engine ran before its grouped launch)."""
    t = mesh.place(x, limb_in)
    if limb_in and mesh.lc > 1:
        t = mesh.all_gather(t, "limb", -2)
    k = len(dst) // mesh.lc
    out = torch.stack([bconv_ops.bconv(t[i], src, dst[i * k:(i + 1) * k])
                       for i in range(mesh.lc)])
    return mesh.collect(out, True, x.shape[:-2])


@pytest.mark.parametrize("cm", MAPS, ids=[cm.name for cm in MAPS])
def test_limbdup_grouped_launch_and_one_dispatch_per_bconv(n256, cm):
    """Limb duplication's grouped launch gives the bytes of the per-cluster
    stack (16 → 16 primes gathered, 3 → 16 replicated), and every sharded
    BConv (local, ARK, limb duplication) dispatches BConvU once per
    ``bconv_mul`` record."""
    p = n256[0]
    rng = np.random.default_rng(3)
    wide = tuple(rns.gen_ntt_primes(32, p.N, exclude=p.q + p.p))
    src, dst = wide[:16], wide[16:]
    mesh = D.Mesh(cm.n_limb_clusters, cm.block_size, CPU)
    for basis, limb_in in ((src, True), (src[:3], False)):
        x = torch.from_numpy(np.stack(
            [rng.integers(0, q, (2, p.N)) for q in basis], axis=1)).to(torch.int32)
        bconv_ops.reset_dispatch_counts()
        got = D._bconv_limbdup(mesh, x, basis, dst, limb_in)
        assert bconv_ops.dispatch_counts() == {"bconv": 1}
        assert torch.equal(got, _stacked_limbdup(mesh, x, basis, dst, limb_in))
        assert torch.equal(got, bconv_ops.bconv_plain(x, basis, dst))
    with D.dist_scope(cm, device=CPU) as ctx:
        for s, d in ((p.p, p.q), (p.q, p.p), (p.q[:2], p.q[2:7] + p.p)):
            x = torch.from_numpy(np.stack(
                [rng.integers(0, q, p.N) for q in s])).to(torch.int32)
            bconv_ops.reset_dispatch_counts()
            with TR.trace_ops() as tr:
                bc.bconv_raw(x, s, d)
            assert bconv_ops.dispatch_counts() == {"bconv": tr.calls["bconv_mul"]} \
                == {"bconv": 1}, (cm.name, len(s), len(d))


def test_bk_pipeline_dispatches_one_bconv_per_record(n256):
    """hmult → rescale → hrot_hoisted([1, 2]) under 4x4-BK-2x2: BConvU
    dispatches equal the op trace's ``bconv_mul`` records."""
    p, ks, ct1, ct2 = n256
    bconv_ops.reset_dispatch_counts()
    with TR.trace_ops() as tr:
        S._pipeline_run(ClusterMap.parse("4x4-BK-2x2"), p, ks, ct1, ct2, CPU)
    assert bconv_ops.dispatch_counts()["bconv"] == tr.calls["bconv_mul"] > 0


def test_inputs_carried_across(n256, n1024):
    """The port's keygen and encryption give the JAX package's input bytes."""
    for N, (p, ks, ct1, ct2) in ((256, n256), (1024, n1024)):
        assert inputs_record(*np_inputs(ks, ct1, ct2)) == REF["N"][str(N)]["inputs"]


@pytest.mark.parametrize("engine", ["eager", "fused"])
def test_single_device_pipeline_equals_jax(n256, engine):
    """The port's single-device pipeline equals the JAX package's digests on
    each engine (eager: the sharded pipeline's yardstick)."""
    got = S.reference_pipeline(*n256, engine=engine)
    assert got == REF["N"]["256"]["engines"][engine]


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_pipeline_equals_jax_eager(n256, n):
    """hmult → rescale → hrot_hoisted([1, 2]) under dist_scope on every map
    of n shards: digests equal to the JAX package's single-device eager
    engine's; both collective tallies agree; the scope is left."""
    p, ks, ct1, ct2 = n256
    want = REF["N"]["256"]["engines"]["eager"]
    for cm in S._maps_for(n):
        out = S._pipeline_run(cm, p, ks, ct1, ct2, CPU)
        assert out["digests"] == want, cm.name
        assert out["executed"] == out["collectives"], cm.name
    assert D.dist_active() is None


def test_pipeline_counts_pinned_at_1024(n1024):
    """At N = 1024 the pipeline's executed collectives equal the counts
    BENCH_distributed.json pinned from the JAX package's sharded run, and
    its digests the JAX package's eager engine's."""
    p, ks, ct1, ct2 = n1024
    pinned = {row["map"]: row["collectives"] for row in BENCH["scaling"]}
    assert set(pinned) == {"1x1-limb-scatter", "2x1-limb-scatter", "2x2-BK-1x2",
                           "4x2-BK-1x2"}
    want = REF["N"]["1024"]["engines"]["eager"]
    for name, counts in pinned.items():
        out = S._pipeline_run(ClusterMap.parse(name), p, ks, ct1, ct2, CPU)
        assert out["executed"] == counts == out["collectives"], name
        assert out["digests"] == want, name


def test_sharded_keys_survive_dropped_caches(n256):
    """A sharded key set keeps its layout: after drop_device_caches the
    a-halves regenerate permuted and the pipeline keeps its bytes."""
    p, ks, ct1, ct2 = n256
    cm = ClusterMap.parse("4x4-BK-2x2")
    with D.dist_scope(cm, device=CPU) as ctx:
        dk = D.shard_keyset(ks, ctx)
        dk.drop_device_caches()
        dm = ckks.rescale(ckks.hmult(D.shard_ciphertext(ct1, ctx),
                                     D.shard_ciphertext(ct2, ctx), dk), p)
        rots = [D.unshard_ciphertext(r, ctx)
                for r in ckks.hrot_hoisted(dm, [1, 2], dk)]
        um = D.unshard_ciphertext(dm, ctx)
    from repro_torch.core import keys as keysm
    got = S.pipeline_digests(um, rots, keysm.decrypt(um, ks.sk))
    assert got == REF["N"]["256"]["engines"]["eager"]
    assert dk._stack_cache is not ks._stack_cache


# ----------------------------------------------------------------------------
# standalone programs: correctness and Fig. 7 traffic
# ----------------------------------------------------------------------------

def test_standalone_programs_exact():
    out = S.run_correctness(8, 8, 4, 256, device=CPU)
    assert out["ok"] and out["map"] == "4x2-BK-1x2"


def test_traffic_limbdup_vs_ark_and_fourstep():
    """Fig. 7 from the executed bytes at the ModUp shape (ℓ = 12 → 48) on
    lc 4 × cs 2: limb duplication moves no all_to_all and cuts 15–25 % of
    ARK's bytes (20 % by the count: 12·3 against 60·3/4); the one-exchange
    four-step moves ≤ 0.55× the two-exchange baseline."""
    out = S.run_traffic(8, 12, 48, 1024, device=CPU)
    assert out["map"] == "4x2-BK-1x2" and out["eq3_beneficial"] is True
    assert "all_to_all" not in out["bconv_limbdup"]
    cut = 100 * (1 - out["bconv_limbdup"]["total"] / out["bconv_ark"]["total"])
    assert 15 <= cut <= 25, cut
    assert out["ntt_fourstep"]["total"] <= 0.55 * out["ntt_baseline"]["total"]


def _swap_first_chunks(fn, n_of):
    """A collective that exchanges the first two chunks of its result along
    the concatenation dim (what a misrouted exchange would deliver)."""
    def corrupted(self, x, axis, *dims):
        out = fn(self, x, axis, *dims).clone()
        d = out.dim() + dims[-1]
        n = n_of(self, axis)
        k = out.shape[d] // n
        a, b = out.narrow(d, 0, k).clone(), out.narrow(d, k, k).clone()
        out.narrow(d, 0, k).copy_(b)
        out.narrow(d, k, k).copy_(a)
        return out
    return corrupted


def test_the_exchange_carries_the_answer(n256, monkeypatch):
    """With all_to_all corrupted the sharded NTT's bytes change; with
    all_gather corrupted limb duplication's do."""
    p = n256[0]
    cm = ClusterMap.parse("2x2-DW")             # lc 2 × cs 2
    rng = np.random.default_rng(5)
    draw = lambda basis: pl.to_tensor(np.stack(
        [rng.integers(0, q, p.N, dtype=np.int64) for q in basis]).astype(np.uint32), CPU)
    x, xs = draw(p.q), draw(p.p)
    src, dst = p.p, p.q                          # ModUp-like: limb duplication

    def run():
        with D.dist_scope(cm, device=CPU) as ctx:
            assert cost.bconv_method(cm, len(src), len(dst), N=p.N) == "limbdup"
            return (pl.RnsPoly(x, p.q, pl.COEFF).to_ntt().data,
                    D.sharded_bconv(ctx, xs, src, dst))
    good_ntt, good_bc = run()
    n_of = lambda mesh, axis: mesh.shape[axis]
    monkeypatch.setattr(D.Mesh, "all_to_all",
                        _swap_first_chunks(D.Mesh.all_to_all, n_of))
    bad_ntt, same_bc = run()
    assert not torch.equal(bad_ntt, good_ntt)
    assert torch.equal(same_bc, good_bc)         # limb duplication: no all_to_all
    monkeypatch.undo()
    monkeypatch.setattr(D.Mesh, "all_gather",
                        _swap_first_chunks(D.Mesh.all_gather, n_of))
    _, bad_bc = run()
    assert not torch.equal(bad_bc, good_bc)


# ----------------------------------------------------------------------------
# the plain versions of the distributed kernels
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_ntt_phases_compose_to_the_transform(cs):
    """The four plain phases with the exchange between them give the
    natural-order NTT permuted into the layouts, and back; the wrappers
    launch nothing on CPU data."""
    N, lc = 1024, 2
    basis = tuple(rns.gen_ntt_primes(4, N))
    cm = ClusterMap(lc, cs, 1, cs)
    R = D.DistContext(cm, None).submodules(N)
    rng = np.random.default_rng(cs)
    x = np.stack([rng.integers(0, q, (3, N), dtype=np.int64) for q in basis],
                 axis=1).astype(np.uint32)
    xt = pl.to_tensor(x, CPU)
    want = pl.to_numpy(ntt_ops.ntt_fwd(xt, basis))
    cperm, nperm = (D.dist_layout(N, R, cs, d)[0] for d in (pl.COEFF, pl.NTT))
    mesh = cm.make_mesh(CPU)
    config.reset_launches()
    got = D.run_dist_ntt_fourstep(mesh, pl.to_tensor(x[..., cperm], CPU), basis, R)
    assert np.array_equal(pl.to_numpy(got), want[..., nperm])
    back = D.run_dist_ntt_fourstep(mesh, got, basis, R, forward=False)
    assert np.array_equal(pl.to_numpy(back), x[..., cperm])
    assert config.launch_counts() == {}
    assert mesh.executed() == ({"all_to_all": 2} if cs > 1 else {})


@pytest.mark.parametrize("phase", ntt_ops.PHASES)
@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_phase_plan_fits_the_launcher(cs, phase):
    """The phase kernels' host plan at the engine's R for N = 2⁸ … 2¹⁶: the
    tile is a power of two that divides the block slice's tiled side and
    fits its word budget, the shared memory fits a CTA's 227 KB, one CTA per
    tile and batch row, and a launch that leaves SMs idle has been cut as
    far as it goes; shapes the launcher refuses are refused."""
    col = phase.endswith("col")
    for log_n in range(8, 17):
        N = 1 << log_n
        R = D.DistContext(ClusterMap(1, cs, 1, cs), None).submodules(N)
        C = N // R
        span, other = (C // cs, R) if col else (R // cs, C)
        for lc, B, ell in ((4, 2, 12), (1, 2, 48), (4, 8, 12), (1, 1, 1)):
            plan = ntt_ops.phase_plan(phase, lc, cs, B, ell, R, C, sms=132)
            tile = plan.tile
            assert tile & (tile - 1) == 0 and span % tile == 0, (N, plan)
            assert tile * other <= ntt_ops.TILE_WORDS
            assert plan.ctas == lc * cs * ell * (span // tile) * B
            words = tile * other
            assert plan.smem == 4 * (3 * words + 2 * R if col else words + 2 * (C - 1))
            assert plan.smem <= 227 * 1024
            if plan.ctas < 132:         # cut as far as the plan cuts
                assert tile == min(span, 4), (N, plan)
    # paper_full under 4x4-BK-2x2: the widest tiles
    assert ntt_ops.phase_plan(phase, 4, 4, 2, 12, 256, 256) == (
        (16, 1536, 51200) if col else (16, 1536, 18424))
    for bad in (dict(R=96, C=256), dict(R=8192, C=256), dict(R=256, C=8192),
                dict(R=8, C=8), dict(B=0), dict(ell=70000), dict(lc=4097)):
        args = dict(lc=4, B=2, ell=12, R=256, C=256) | bad
        with pytest.raises(ValueError):
            ntt_ops.phase_plan(phase, args["lc"], 16, args["B"], args["ell"],
                               args["R"], args["C"])
    with pytest.raises(ValueError):
        ntt_ops.phase_plan(phase, 4, 3, 2, 12, 192, 256)


def test_blocks_gather_plain():
    """automorphism_blocks: block j of every cluster writes its slice of the
    outputs through its slice of the table."""
    lc, cs, B, ell, N = 2, 4, 3, 2, 64
    full = torch.randint(0, 1 << 30, (lc, cs, B, ell, N), dtype=torch.int32)
    table = torch.randperm(N)
    got = auto_ops.automorphism_blocks(full, table)
    n = N // cs
    for j in range(cs):
        assert torch.equal(got[:, j], full[:, j][..., table[j * n:(j + 1) * n]])
    with pytest.raises(ValueError):
        auto_ops.automorphism_blocks(full[..., :63], table[:63])
