"""Self-test and traffic measurement of the distributed engine, in one process.

    python -m repro_torch.core._dist_selftest <n_shards> <mode> [...] [--device cpu|cuda]
        [--cards D [--distinct]]

prints one JSON line.  The mesh is ``n_shards`` logical shards on one device
(:class:`repro_torch.core.distributed.Mesh`), so no process is started.
``--cards D`` (suite only) splits its coefficient axis into D parts: D parts
of ``--device``, or with ``--distinct`` the cards cuda:0 … cuda:D−1; the
suite then runs every map whose block size D divides, and holds each
primitive's bytes between parts to their closed form
(:func:`part_bytes_closed_form`).

Modes:
  correctness  — the standalone programs (baseline and four-step NTT, ARK and
                 limb-duplication BConv) on the square map of n_shards must
                 equal the single-device results.  Extra args: ``ell K N``.
  traffic      — the bytes each of those programs' executed collectives moved
                 between distinct blocks (Fig. 7).  Extra args: ``ell K N``.
  suite        — the ``dist_scope`` engine on every cluster-map shape of
                 n_shards (:func:`_maps_for`): per primitive, bytes against
                 the permuted single-device results and both collective
                 tallies (the mesh's executed one, ``count_collective``'s)
                 against ``cost_model.predict_collectives``; then hmult →
                 rescale → hoisted rotations [1, 2], whose digests must equal
                 the single-device eager engine's on every map.  Everything
                 is asserted here; the JSON carries the booleans and counts.
                 Extra arg: ``N`` (default 256).
  bench        — one square map: the pipeline's digests against the
                 single-device eager engine, its collectives, and wall-clock
                 (median of ``reps``).  Extra args: ``N reps``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time

import numpy as np


# ----------------------------------------------------------------------------
# cluster-map shapes exercised per shard count
# ----------------------------------------------------------------------------

#: The paper's 16-core package under its default block (§VI-F) and under
#: coefficient scattering.
PAPER_MAPS = ("4x4-BK-2x2", "4x4-coef-scatter")


def _maps_for(n: int):
    """Every structurally distinct ClusterMap of an n-core package: limb
    scattering (cs = 1), coefficient scattering (L_c = 1) and the block
    shapes between; at 16 cores the square map and the paper's two."""
    from repro_torch.core import mapping as M
    shapes = {
        1: [(1, 1, 1, 1)],
        2: [(1, 2, 1, 1), (1, 2, 1, 2)],
        4: [(2, 2, 1, 1), (2, 2, 2, 1), (2, 2, 2, 2)],
        8: [(2, 4, 1, 1), (2, 4, 2, 1), (2, 4, 2, 2), (2, 4, 2, 4)],
    }
    if n in shapes:
        return [M.ClusterMap(*s) for s in shapes[n]]
    maps = [_square_map(n)]
    if n == 16:
        maps += [M.ClusterMap.parse(s) for s in PAPER_MAPS]
    return maps


def _square_map(n: int):
    from repro_torch.core import mapping as M
    lc = 1
    while lc * lc < n:
        lc *= 2
    return M.ClusterMap(lc, n // lc, 1, n // lc)


# ----------------------------------------------------------------------------
# digests and inputs
# ----------------------------------------------------------------------------

def _delta_matches(delta: dict, predicted: dict) -> bool:
    return ({k: v for k, v in delta.items() if v}
            == {k: v for k, v in predicted.items() if v})


def digest(arr) -> str:
    """Order/shape/dtype-binding SHA-256 of a u32 array (a residue tensor is
    read as its u32 bits), the reference's ``_dist_selftest.digest``."""
    import torch
    from repro_torch.core import poly as pl
    from repro_torch.core.parts import Parts
    a = (pl.to_numpy(arr) if isinstance(arr, (torch.Tensor, Parts))
         else np.asarray(arr))
    a = np.ascontiguousarray(a)
    h = hashlib.sha256()
    h.update(str((a.shape, a.dtype.str)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def pipeline_digests(mult, rots, dec) -> dict:
    return {
        "mult_a": digest(mult.a.data), "mult_b": digest(mult.b.data),
        "rots": [[digest(r.a.data), digest(r.b.data)] for r in rots],
        "dec": digest(dec),
    }


def _make_inputs(p, seed: int = 7, device="cuda"):
    """The reference's inputs: keygen(rotations=(1, 2), seed) and two
    encryptions of normal(slots) messages at scale q_top."""
    from repro_torch.core import encoding as enc
    from repro_torch.core import keys as keysm
    ks = keysm.keygen(p, rotations=(1, 2), seed=seed, device=device)
    rng = np.random.default_rng(seed)
    scale = float(p.q[-1])
    cts = []
    for _ in range(2):
        z = rng.normal(size=p.slots) + 1j * rng.normal(size=p.slots)
        pt = enc.encode(z, scale, p.q, p.N)
        cts.append(keysm.encrypt(pt, scale, ks.sk, p.q, p.N, device=device))
    return ks, cts[0], cts[1]


def reference_pipeline(p, ks, ct1, ct2, engine: str = "eager") -> dict:
    """The single-device pipeline's digests on ``engine`` (no scope)."""
    from repro_torch.core import ckks
    from repro_torch.core import keys as keysm
    with ckks.use_engine(engine):
        mult = ckks.rescale(ckks.hmult(ct1, ct2, ks), p)
        rots = ckks.hrot_hoisted(mult, [1, 2], ks)
    return pipeline_digests(mult, rots, keysm.decrypt(mult, ks.sk))


# ----------------------------------------------------------------------------
# suite
# ----------------------------------------------------------------------------

def _tallied(ctx, fn):
    """(result, count_collective delta, mesh-executed counts, bytes, bytes
    between parts) of fn()."""
    from repro_torch.kernels import config as kcfg
    before = kcfg.collective_counts()
    snap = ctx.mesh.snapshot()
    out = fn()
    executed, nbytes = ctx.mesh.since(snap)
    return (out, kcfg.collectives_since(before), executed, nbytes,
            ctx.mesh.parts_since(snap))


def part_bytes_closed_form(op: str, ell: int, N: int, D: int) -> dict:
    """Bytes a primitive on one (ℓ, N) operand copies between the D parts
    of a mesh split along "coef": the NTT's all-to-all sends every other
    part its share, (D − 1)/D of the operand; the AutoU all-gather gives
    every part the other D − 1 parts' words; the BConv's collectives run
    along "limb", inside each part.  A replicated operand travels once for
    all limb clusters, so no map's limb clusters enter."""
    words = ell * N * 4
    if D == 1 or op == "bconv":
        return {}
    if op in ("ntt", "intt"):
        return {"all_to_all": words * (D - 1) // D}
    return {"all_gather": words * (D - 1)}


def _entry(out, exact, counts, executed, nbytes, part_bytes, predicted,
           **extra) -> dict:
    return {"exact": bool(exact), "digest": digest(out), "counts": counts,
            "executed": executed,
            "bytes": nbytes, "part_bytes": part_bytes, "predicted": predicted,
            "counts_match": _delta_matches(counts, predicted)
                            and _delta_matches(executed, predicted),
            **extra}


def _prim_checks(ctx, p, rng, device) -> dict:
    """Per primitive under an ACTIVE dist_scope: bytes against the permuted
    single-device result, and both tallies against the prediction."""
    import torch
    from repro_torch.core import cost_model as cost
    from repro_torch.core import bconv as bc
    from repro_torch.core import distributed as D
    from repro_torch.core import poly as pl
    from repro_torch.kernels.bconv import ops as bconv_ops
    from repro_torch.kernels.ntt import ops as ntt_ops

    N, basis = p.N, p.q
    R = ctx.submodules(N)
    cperm = D.dist_layout(N, R, ctx.cs, pl.COEFF)[0]
    nperm = D.dist_layout(N, R, ctx.cs, pl.NTT)[0]
    dev = torch.device(device)
    rows = lambda prims: np.stack(
        [rng.integers(0, q, N, dtype=np.int64).astype(np.uint32) for q in prims])
    out: dict = {}

    x = rows(basis)
    want_ntt = pl.to_numpy(ntt_ops.ntt_fwd(pl.to_tensor(x, dev), basis))
    sp = D.shard_poly(pl.RnsPoly(pl.to_tensor(x, dev), basis, pl.COEFF), ctx)
    sn, *t_fwd = _tallied(ctx, sp.to_ntt)
    sc, *t_inv = _tallied(ctx, sn.to_coeff)
    p_fwd = cost.predict_collectives("ntt", ctx.cm)
    p_inv = cost.predict_collectives("intt", ctx.cm)
    out["ntt"] = _entry(sn.data, np.array_equal(pl.to_numpy(sn.data),
                                                want_ntt[:, nperm]),
                        *t_fwd, p_fwd)
    out["intt"] = _entry(sc.data, np.array_equal(pl.to_numpy(sc.data), x[:, cperm]),
                         *t_inv, p_inv)

    # BConv at the two pipeline shapes: ModUp-like (few → many limbs) and
    # ModDown-like (many → few); the method flips across cluster maps
    for tag, src, dst in (("bconv_up", p.p, p.q), ("bconv_down", p.q, p.p)):
        xs = rows(src)
        want = pl.to_numpy(bconv_ops.bconv(pl.to_tensor(xs, dev), src, dst))
        spc = D.shard_poly(pl.RnsPoly(pl.to_tensor(xs, dev), src, pl.COEFF), ctx)
        got, *tallies = _tallied(ctx, lambda: bc.bconv_raw(spc.data, src, dst))
        pred = cost.predict_collectives("bconv", ctx.cm, n_in=len(src),
                                        n_out=len(dst), N=N)
        out[tag] = _entry(got, np.array_equal(pl.to_numpy(got), want[:, cperm]),
                          *tallies, pred,
                          method=cost.bconv_method(ctx.cm, len(src), len(dst), N=N))

    # slot-parallel automorphism (the AutoU of AutoU∘KS)
    g = pl.galois_elt(1, N)
    want_auto = want_ntt[:, pl.automorphism_perm(N, g)]
    sa, *tallies = _tallied(
        ctx, lambda: pl.RnsPoly(sn.data, basis, pl.NTT).automorphism_by_gelt(g))
    out["auto"] = _entry(sa.data, np.array_equal(pl.to_numpy(sa.data),
                                                 want_auto[:, nperm]),
                         *tallies, cost.predict_collectives("auto", ctx.cm))
    D = ctx.mesh.n_parts
    for op, res in out.items():
        assert res["exact"], (ctx.cm.name, op)
        assert res["counts_match"], (ctx.cm.name, op, res)
        ell = len(p.q) if op in ("ntt", "intt", "auto") else 0
        assert res["part_bytes"] == part_bytes_closed_form(
            op.split("_")[0], ell, N, D), (ctx.cm.name, op, res["part_bytes"])
    return out


def _pipeline_run(cm, p, ks, ct1, ct2, device, devices=None) -> dict:
    """hmult → rescale → hoisted rotations [1, 2] under dist_scope (on
    ``devices``' parts when given): digests of the unsharded outputs, both
    collective tallies and the bytes moved between blocks and between
    parts."""
    from repro_torch.core import ckks
    from repro_torch.core import distributed as D
    from repro_torch.core import keys as keysm
    from repro_torch.kernels import config as kcfg

    with D.dist_scope(cm, device=device, devices=devices) as ctx:
        dk = D.shard_keyset(ks, ctx)
        d1 = D.shard_ciphertext(ct1, ctx)
        d2 = D.shard_ciphertext(ct2, ctx)
        before = kcfg.collective_counts()
        snap = ctx.mesh.snapshot()
        dm = ckks.rescale(ckks.hmult(d1, d2, dk), p)
        drots = ckks.hrot_hoisted(dm, [1, 2], dk)
        counts = kcfg.collectives_since(before)
        executed, nbytes = ctx.mesh.since(snap)
        part_bytes = ctx.mesh.parts_since(snap)
        um = D.unshard_ciphertext(dm, ctx)
        urots = [D.unshard_ciphertext(r, ctx) for r in drots]
    assert D.dist_active() is None
    return {"digests": pipeline_digests(um, urots, keysm.decrypt(um, ks.sk)),
            "collectives": counts, "executed": executed, "bytes": nbytes,
            "part_bytes": part_bytes}


def maps_for_parts(n: int, D: int) -> list:
    """The maps of ``n`` shards whose block size D parts split."""
    return [cm for cm in _maps_for(n) if cm.block_size % D == 0]


def run_suite(n: int, N: int = 256, device="cuda", maps=None,
              reference: dict | None = None, devices=None) -> dict:
    """Every map of ``n`` shards (or ``maps``) — on ``devices``' parts,
    every such map whose block size they divide: primitives, then the
    pipeline, whose digests must equal ``reference`` (the single-device
    eager engine's, computed here when not given)."""
    from repro_torch.core import distributed as D
    from repro_torch.core import params as prm

    # L = 8 divides the 2/4/8-cluster maps; the ℓ = 10 ModUp extension and
    # the post-rescale ℓ = 7 exercise the replicated-limb path
    p = prm.make_params(N=N, L=8, K=2, dnum=4)
    ks, ct1, ct2 = _make_inputs(p, device=device)
    if reference is None:
        reference = reference_pipeline(p, ks, ct1, ct2, "eager")
    parts = len(devices) if devices else 1
    out: dict = {"n_shards": n, "N": N, "L": len(p.q), "device": str(device),
                 "devices": [str(d) for d in devices] if devices else None,
                 "maps": []}
    rng = np.random.default_rng(11)
    for cm in maps or maps_for_parts(n, parts):
        entry: dict = {"map": cm.name, "cs": cm.block_size,
                       "lc": cm.n_limb_clusters}
        t0 = time.perf_counter()
        with D.dist_scope(cm, device=device, devices=devices) as ctx:
            entry["prims"] = _prim_checks(ctx, p, rng, device)
        t1 = time.perf_counter()
        entry["pipeline"] = _pipeline_run(cm, p, ks, ct1, ct2, device, devices)
        entry["pipeline_exact"] = entry["pipeline"]["digests"] == reference
        print(f"  {cm.name}: prims {t1 - t0:.2f}s pipeline "
              f"{time.perf_counter() - t1:.2f}s", file=sys.stderr, flush=True)
        assert entry["pipeline_exact"], (cm.name, "digest mismatch")
        out["maps"].append(entry)
    out["reference"] = reference
    out["ok"] = True
    return out


def run_bench(n: int, N: int = 2048, reps: int = 3, device="cuda") -> dict:
    """One square map: the pipeline's digests against the single-device
    eager engine, its collectives, and wall-clock per run (ending in a
    device sync)."""
    import torch
    from repro_torch.core import ckks
    from repro_torch.core import distributed as D
    from repro_torch.core import params as prm

    cm = _square_map(n)
    p = prm.make_params(N=N, L=8, K=2, dnum=4)
    ks, ct1, ct2 = _make_inputs(p, device=device)
    reference = reference_pipeline(p, ks, ct1, ct2, "eager")
    pipe = _pipeline_run(cm, p, ks, ct1, ct2, device)
    sync = ((lambda: torch.cuda.synchronize())
            if torch.device(device).type == "cuda" else (lambda: None))
    coeff = ct1.a.to_coeff()                 # natural order, outside the scope
    with D.dist_scope(cm, device=device) as ctx:
        dk = D.shard_keyset(ks, ctx)
        d1 = D.shard_ciphertext(ct1, ctx)
        d2 = D.shard_ciphertext(ct2, ctx)
        sp = D.shard_poly(coeff, ctx)

        def step():
            ckks.hrot_hoisted(ckks.rescale(ckks.hmult(d1, d2, dk), p), [1, 2], dk)
            sync()

        def ntt_step():
            sp.to_ntt()
            sync()
        step()
        ntt_step()
        t_pipe, t_ntt = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            step()
            t_pipe.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            ntt_step()
            t_ntt.append(time.perf_counter() - t0)
    return {"n_shards": n, "map": cm.name, "N": N, "reps": reps,
            "device": str(device), "digests": pipe["digests"],
            "exact": pipe["digests"] == reference,
            "collectives": pipe["collectives"], "executed": pipe["executed"],
            "bytes": pipe["bytes"],
            "pipeline_ms": 1e3 * statistics.median(t_pipe),
            "ntt_ms": 1e3 * statistics.median(t_ntt)}


# ----------------------------------------------------------------------------
# standalone programs: correctness and Fig. 7 traffic
# ----------------------------------------------------------------------------

def _operand(n, ell, K, N, device):
    import torch
    from repro_torch.core import poly as pl
    from repro_torch.core import rns
    basis = tuple(rns.gen_ntt_primes(ell, N))
    dst = tuple(rns.gen_ntt_primes(K, N, exclude=basis))
    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, q, N, dtype=np.int64).astype(np.uint32)
                  for q in basis])
    return basis, dst, x, pl.to_tensor(x, torch.device(device))


def run_correctness(n: int, ell: int = 8, K: int = 4, N: int = 256,
                    device="cuda") -> dict:
    from repro_torch.core import distributed as D
    from repro_torch.core import poly as pl
    from repro_torch.kernels.bconv import ops as bconv_ops
    from repro_torch.kernels.ntt import ops as ntt_ops

    cm = _square_map(n)
    mesh = cm.make_mesh(device)
    basis, dst, x, xt = _operand(n, ell, K, N, device)
    want = pl.to_numpy(ntt_ops.ntt_fwd(xt, basis))
    got = D.run_dist_ntt(mesh, xt, basis)
    back = D.run_dist_ntt(mesh, got, basis, forward=False)
    assert np.array_equal(pl.to_numpy(got), want), "dist_ntt forward"
    assert np.array_equal(pl.to_numpy(back), x), "dist_ntt inverse"
    R = 16
    perm = D.ntt_layout_perm(N, R)
    cperm = D.coef_layout_perm(N, R, cm.block_size)
    got4 = D.run_dist_ntt_fourstep(mesh, pl.to_tensor(x[:, cperm], xt.device),
                                   basis, R)
    back4 = D.run_dist_ntt_fourstep(mesh, got4, basis, R, forward=False)
    assert np.array_equal(pl.to_numpy(got4), want[:, perm]), "four-step layout"
    assert np.array_equal(pl.to_numpy(back4), x[:, cperm]), "four-step inverse"
    want_bc = pl.to_numpy(bconv_ops.bconv(xt, basis, dst))
    g1 = D.dist_bconv_ark(mesh, xt, basis, dst)
    g2 = D.dist_bconv_limbdup(mesh, xt, basis, dst)
    assert np.array_equal(pl.to_numpy(g1), want_bc), "bconv ark"
    assert np.array_equal(pl.to_numpy(g2), want_bc), "bconv limbdup"
    return {"map": cm.name, "n_shards": n, "ell": ell, "K": K, "N": N,
            "executed": mesh.executed(), "ok": True}


def _summary(mesh, fn) -> dict:
    """{kind: bytes moved, …, "total"} of the collectives fn() executed."""
    snap = mesh.snapshot()
    fn()
    _, nbytes = mesh.since(snap)
    return {**nbytes, "total": sum(nbytes.values())}


def run_traffic(n: int, ell: int = 12, K: int = 48, N: int = 1024,
                device="cuda") -> dict:
    """Bytes moved between distinct blocks by ARK and limb duplication at
    (ℓ → K), and by the baseline and four-step NTT (ℓ rounded up to a
    multiple of n, so the baseline's limbs split over every core)."""
    from repro_torch.core import distributed as D
    from repro_torch.core import poly as pl
    from repro_torch.core import rns

    cm = _square_map(n)
    mesh = cm.make_mesh(device)
    basis, dst, _, xt = _operand(n, ell, K, N, device)
    ntt_ell = -(-ell // n) * n
    ntt_basis = tuple(rns.gen_ntt_primes(ntt_ell, N))
    rng = np.random.default_rng(1)
    xn = pl.to_tensor(np.stack([rng.integers(0, q, N, dtype=np.int64).astype(np.uint32)
                                for q in ntt_basis]), xt.device)
    return {
        "map": cm.name, "n_shards": n, "ell": ell, "K": K, "N": N,
        "bconv_ark": _summary(mesh, lambda: D.dist_bconv_ark(mesh, xt, basis, dst)),
        "bconv_limbdup": _summary(
            mesh, lambda: D.dist_bconv_limbdup(mesh, xt, basis, dst)),
        "ntt_baseline": _summary(mesh, lambda: D.run_dist_ntt(mesh, xn, ntt_basis)),
        "ntt_fourstep": _summary(
            mesh, lambda: D.run_dist_ntt_fourstep(mesh, xn, ntt_basis, 16)),
        "ntt_ell": ntt_ell,
        "eq3_beneficial": D.limbdup_beneficial(ell, K, cm),
    }


# ----------------------------------------------------------------------------
# entry point
# ----------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_shards", type=int, nargs="?", default=8)
    ap.add_argument("mode", nargs="?", default="correctness",
                    choices=("correctness", "traffic", "suite", "bench"))
    ap.add_argument("args", type=int, nargs="*")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cards", type=int, default=1,
                    help="parts the mesh's coefficient axis is split into (suite)")
    ap.add_argument("--distinct", action="store_true",
                    help="the parts on cuda:0 … cuda:D−1, not on --device")
    a = ap.parse_args(argv)
    n, extra = a.n_shards, a.args
    devices = None
    if a.cards > 1 or a.distinct:
        devices = ([f"cuda:{k}" for k in range(a.cards)] if a.distinct
                   else [a.device] * a.cards)
    if devices and a.mode != "suite":
        ap.error("--cards and --distinct apply to the suite")
    if a.mode == "suite":
        out = run_suite(n, *(extra[:1] or [256]),
                        device=devices[0] if devices else a.device, devices=devices)
    elif a.mode == "bench":
        out = run_bench(n, *(extra[:2] or [2048]), device=a.device)
    elif a.mode == "traffic":
        out = run_traffic(n, *(extra[:3] or [12, 48, 1024]), device=a.device)
    else:
        out = run_correctness(n, *(extra[:3] or [8, 4, 256]), device=a.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
