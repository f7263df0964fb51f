"""Self-test and traffic measurement of the distributed engine, in one process.

    python -m repro_torch.core._dist_selftest <n_shards> <mode> [...] [--device cpu|cuda]
        [--cards D [--rows Dl] [--distinct]]

prints one JSON line.  The mesh is ``n_shards`` logical shards on one device
(:class:`repro_torch.core.distributed.Mesh`), so no process is started.
``--cards D`` (suite only) splits it into D parts: D parts of ``--device``,
or with ``--distinct`` the cards cuda:0 … cuda:D−1, as a grid of ``--rows``
Dl rows along "limb" by D/Dl columns along "coef" (default one row: the
coefficient axis alone); the suite then runs every map the grid splits
(Dl | lc, D/Dl | cs), and holds each primitive's, the pipeline's and the
batched chain's bytes between parts to their closed forms per axis
(:func:`part_bytes_closed_form`, :class:`_Flow`).

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
                 rescale → hoisted rotations [1, 2], and the batched families
                 (:func:`batched_chain`), whose digests must equal the
                 single-device eager engine's on every map.  Everything
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


#: The batched families at a served wave's shape: B = 4 pairs of the two
#: inputs, each rotated by one of the self-test keys' amounts.
BATCH_ROTS = (1, 2, 2, 1)


def batched_chain(ckks, enc, make_pt, p, ks, ct1, ct2, rots=BATCH_ROTS) -> dict:
    """hmult_many → rescale_many → hrot_many(``rots``) → hadd_many(rescaled,
    rotated) → pmult_many(sums, B encoded plaintexts) over B = len(rots)
    pairs of the two inputs: {stage: its B ciphertexts}.  ``ckks`` and
    ``enc`` are either package's modules and ``make_pt(residues, basis)``
    wraps (ℓ, N) host residues as its coefficient-domain ``RnsPoly`` (sharded
    under a scope), so the JAX package's record and the port run one chain."""
    B = len(rots)
    c1s = [(ct1, ct2)[i % 2] for i in range(B)]
    c2s = [(ct2, ct1, ct1, ct2)[i % 4] for i in range(B)]
    mult = ckks.hmult_many(c1s, c2s, ks)
    resc = ckks.rescale_many(mult, p)
    rot = ckks.hrot_many(resc, list(rots), ks)
    summed = ckks.hadd_many(resc, rot)
    basis = summed[0].basis
    scale = float(basis[-1])
    rng = np.random.default_rng(B)
    pts = [make_pt(enc.encode(rng.normal(size=p.slots) + 1j * rng.normal(size=p.slots),
                              scale, basis, p.N), basis) for _ in range(B)]
    prod = ckks.pmult_many(summed, pts, [scale] * B)
    return {"hmult_many": mult, "rescale_many": resc, "hrot_many": rot,
            "hadd_many": summed, "pmult_many": prod}


def batched_digests(stages: dict) -> dict:
    """{stage: [[digest(a), digest(b)] per ciphertext]} of :func:`batched_chain`."""
    return {k: [[digest(c.a.data), digest(c.b.data)] for c in cts]
            for k, cts in stages.items()}


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

def axis_bytes(mesh, snap) -> dict:
    """{axis: {kind: bytes}} between parts since a snapshot (empty axes
    omitted)."""
    out = {ax: mesh.parts_since(snap, ax) for ax in ("coef", "limb")}
    return {ax: v for ax, v in out.items() if v}


def _tallied(ctx, fn):
    """(result, count_collective delta, mesh-executed counts, bytes, bytes
    between parts per kind and per axis) of fn()."""
    from repro_torch.kernels import config as kcfg
    before = kcfg.collective_counts()
    snap = ctx.mesh.snapshot()
    out = fn()
    executed, nbytes = ctx.mesh.since(snap)
    return (out, kcfg.collectives_since(before), executed, nbytes,
            ctx.mesh.parts_since(snap), axis_bytes(ctx.mesh, snap))


def part_bytes_closed_form(op: str, ell: int, N: int, cm, rows: int = 1,
                           cols: int = 1, n_out: int = 0) -> dict:
    """{axis: {kind: bytes}} a primitive on one (ℓ, N) operand, held as
    :func:`shard_poly` holds it, copies between the parts of a ``rows ×
    cols`` grid (axes with no copy omitted): the NTT's all-to-all along
    "coef" sends every other part of a row its share, (cols − 1)/cols of the
    row's words; the AutoU all-gather gives every part the other cols − 1
    parts' words; the BConv (ℓ → ``n_out`` limbs) copies along "limb" only:
    ARK's two all-to-alls (rows − 1)/rows of the input's and of the output's
    words, limb duplication's all-gather rows − 1 times the input's, the
    "local" method's regroup of a row-split input into replication the same.
    A replicated operand travels once for all limb clusters of a part, and
    each grid row holds its own copy of it.  :class:`_Flow`."""
    f = _Flow(cm, N, rows, cols)
    if op in ("ntt", "intt"):
        f.ntt(ell, 1)
    elif op == "auto":
        f.auto(ell, 1)
    else:
        f.bconv(ell, f.S(ell), n_out, 1)
    return f.by_axis()


class _Flow:
    """The closed form of the bytes the eager engine copies between the parts
    of a ``rows × cols`` grid of a ClusterMap's mesh, by a walk over the
    CKKS ops on abstract values: each value is its limb count ℓ and whether
    it is split over the grid's rows (``S``: ℓ a multiple of lc on a grid of
    several rows) or replicated.  The terms (4 bytes a word, ``B`` the
    leading dims):

    * NTT/iNTT: "coef" all-to-all, 4·B·ℓ·N·(cols − 1)/cols, times rows for a
      replicated operand (every row exchanges its own copy);
    * AutoU: "coef" all-gather, 4·B·ℓ·N·(cols − 1), times rows likewise;
    * BConv ℓ → K: "limb" — ARK 4·B·(ℓ + K)·N·(rows − 1)/rows, limb
      duplication (ℓ a multiple of lc) 4·B·ℓ·N·(rows − 1), "local" with a
      row-split input 4·B·ℓ·N·(rows − 1) (a regroup into replication);
    * regroup of limbs ``idx`` from row-split or replicated sources: every
      part copies the limbs its row needs and does not hold, 4·B·N words a
      limb summed over the rows (the grid's columns hold N/cols each).

    Outputs of the shard bodies are split iff ``S(ℓ)``; a ring op's is split
    iff an operand's is; a regroup's iff ``S(len(idx))`` and a source is
    split; the centered lift's and a "local" BConv's are replicated."""

    def __init__(self, cm, N: int, rows: int, cols: int, params=None,
                 warm: bool = False):
        self.lc, self.N, self.rows, self.cols = cm.n_limb_clusters, N, rows, cols
        self.method = lambda n_in, n_out: _cost_method(cm, n_in, n_out, N)
        self.p = params
        self.bytes: dict = {}
        self.warm = warm                    # every evk level slice made already
        self.sliced: set = set()            # (key, ℓ) evk level slices made

    def S(self, ell: int) -> bool:
        return self.rows > 1 and ell % self.lc == 0

    def _add(self, axis: str, kind: str, nbytes: int) -> None:
        if nbytes:
            k = (axis, kind)
            self.bytes[k] = self.bytes.get(k, 0) + int(nbytes)

    def by_axis(self) -> dict:
        out: dict = {}
        for (axis, kind), v in sorted(self.bytes.items()):
            out.setdefault(axis, {})[kind] = v
        return out

    def _rep(self, ell: int) -> int:
        """Copies of a value's words along "coef": one per grid row for a
        replicated operand (limb-sharded blocks: one in all)."""
        return 1 if (self.lc == 1 or ell % self.lc == 0) else self.rows

    def ntt(self, ell: int, B: int) -> bool:
        c = self.cols
        self._add("coef", "all_to_all",
                  4 * B * ell * self.N * (c - 1) // c * self._rep(ell))
        return self.S(ell)

    def auto(self, ell: int, B: int) -> bool:
        self._add("coef", "all_gather",
                  4 * B * ell * self.N * (self.cols - 1) * self._rep(ell))
        return self.S(ell)

    def bconv(self, n_in: int, in_split: bool, n_out: int, B: int) -> bool:
        r, w = self.rows, 4 * B * self.N
        m = self.method(n_in, n_out)
        if m == "ark":
            self._add("limb", "all_to_all", w * (n_in + n_out) * (r - 1) // r)
        elif m == "limbdup" and n_in % self.lc == 0:
            self._add("limb", "all_gather", w * n_in * (r - 1))
        elif m == "local" and in_split:
            self._add("limb", "regroup", w * n_in * (r - 1))
        return m != "local" and self.S(n_out)

    def regroup(self, srcs, idx, B: int) -> bool:
        """``srcs``: [(ℓ, split)], concatenated along the limbs."""
        idx = list(idx)
        split = self.S(len(idx)) and any(sp for _, sp in srcs)
        where = [(ell, sp, j) for ell, sp in srcs for j in range(ell)]
        per = len(idx) // self.rows
        missing = 0
        for a in range(self.rows):
            for g in (idx[a * per:(a + 1) * per] if split else idx):
                ell, sp, j = where[g]
                missing += sp and j // (ell // self.rows) != a
        self._add("limb", "regroup", 4 * B * self.N * missing)
        return split

    # -- the CKKS ops, as ckks.py's eager engine runs them -----------------
    def mod_up(self, ell: int, d_split: bool, B: int) -> list:
        p = self.p
        K, c_split = len(p.p), self.ntt(ell, B)           # d_coeff = iNTT(d)
        exts, start = [], 0
        for dj in p.digit_bases(ell):
            a = len(dj)
            idx = range(start, start + a)
            dig = self.regroup([(ell, c_split)], idx, B)
            dig_ntt = self.regroup([(ell, d_split)], idx, B)
            n_o = ell - a + K
            self.bconv(a, dig, n_o, B)
            conv_ntt = self.ntt(n_o, B)
            conv = iter(range(a, a + n_o))
            perm = [next(conv) if not start <= i < start + a else i - start
                    for i in range(ell)] + list(conv)
            exts.append(self.regroup([(a, dig_ntt), (n_o, conv_ntt)], perm, B))
            start += a
        return exts

    def ks_inner(self, exts: list, key, ell: int, B: int) -> bool:
        p = self.p
        L, K = len(p.q), len(p.p)
        ev_split = self.S(L + K)
        idx = list(range(ell)) + [L + k for k in range(K)]
        ev = self.S(ell + K) and ev_split
        if not self.warm and (key, ell) not in self.sliced:
            self.sliced.add((key, ell))
            for _ in range(2 * len(exts)):               # both halves, each digit
                self.regroup([(L + K, ev_split)], idx, 1)
        acc = ev or any(exts)
        xq = self.regroup([(ell + K, acc)], range(ell), 2 * B)
        self.regroup([(ell + K, acc)], range(ell, ell + K), 2 * B)
        xp = self.ntt(K, 2 * B)                           # iNTT of the P part
        self.bconv(K, xp, ell, 2 * B)
        conv = self.ntt(ell, 2 * B)
        return xq or conv

    def hmult(self, ell: int, B: int = 1) -> bool:
        d = self.S(ell)
        return self.ks_inner(self.mod_up(ell, d, B), "relin", ell, B) or d

    def rescale_once(self, ell: int, split: bool, B: int) -> bool:
        self.regroup([(ell, split)], [ell - 1], 2 * B)    # the top limb
        self.ntt(1, 2 * B)
        lifted = self.ntt(ell - 1, 2 * B)
        return self.regroup([(ell, split)], range(ell - 1), 2 * B) or lifted

    def rotate(self, ell: int, split: bool, g) -> bool:
        """The eager rotation of one ciphertext: both halves permuted, then a
        key switch of φ(a)."""
        b = self.auto(ell, 1)
        a = self.auto(ell, 1)
        return self.ks_inner(self.mod_up(ell, a, 1), g, ell, 1) or b

    def hoisted(self, ell: int, split: bool, gs) -> None:
        exts = self.mod_up(ell, split, 1)
        K = len(self.p.p)
        for g in gs:
            rot = [self.auto(ell + K, 1) for _ in exts]
            self.ks_inner(rot, g, ell, 1)
            self.auto(ell, 1)


def _cost_method(cm, n_in: int, n_out: int, N: int) -> str:
    from repro_torch.core import cost_model as cost
    return cost.bconv_method(cm, n_in, n_out, N=N)


def pipeline_bytes_closed_form(p, cm, rows: int, cols: int, rots=(1, 2),
                               warm: bool = False) -> dict:
    """{axis: {kind: bytes}} between the parts of a ``rows × cols`` grid for
    hmult → rescale → hrot_hoisted(``rots``) on a freshly sharded key set,
    or (``warm``) on one whose evk level slices are made (:class:`_Flow`)."""
    f = _Flow(cm, p.N, rows, cols, p, warm)
    ell = len(p.q)
    split = f.hmult(ell)
    for _ in range(p.rescale_primes):
        split = f.rescale_once(ell, split, 1)
        ell -= 1
    f.hoisted(ell, split, [r for r in rots if r % (p.N // 2)])
    return f.by_axis()


def batched_bytes_closed_form(p, cm, rows: int, cols: int, rots=BATCH_ROTS,
                              warm: bool = False) -> dict:
    """{axis: {kind: bytes}} for :func:`batched_chain` on a freshly sharded
    key set, or a warm one (:class:`_Flow`): the B stacked members ride the
    leading dims, hrot_many's eager engine rotates each member alone."""
    f = _Flow(cm, p.N, rows, cols, p, warm)
    ell, B = len(p.q), len(rots)
    split = f.hmult(ell, B)
    for _ in range(p.rescale_primes):
        split = f.rescale_once(ell, split, B)
        ell -= 1
    for r in rots:
        if r % (p.N // 2):
            f.rotate(ell, split, r)
    f.ntt(ell, B)                                        # the plaintexts
    return f.by_axis()


def _entry(out, exact, counts, executed, nbytes, part_bytes, by_axis, predicted,
           **extra) -> dict:
    return {"exact": bool(exact), "digest": digest(out), "counts": counts,
            "executed": executed, "bytes": nbytes, "part_bytes": part_bytes,
            "axis_bytes": by_axis, "predicted": predicted,
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
    grid = ctx.mesh.rows, ctx.mesh.cols
    shapes = {"bconv_up": (len(p.p), len(p.q)), "bconv_down": (len(p.q), len(p.p))}
    for op, res in out.items():
        assert res["exact"], (ctx.cm.name, op)
        assert res["counts_match"], (ctx.cm.name, op, res)
        ell, n_out = shapes.get(op, (len(p.q), 0))
        want = part_bytes_closed_form(op.split("_")[0], ell, N, ctx.cm, *grid, n_out)
        assert res["axis_bytes"] == want, (ctx.cm.name, grid, op, res["axis_bytes"], want)
    return out


def _pipeline_run(cm, p, ks, ct1, ct2, device, devices=None) -> dict:
    """hmult → rescale → hoisted rotations [1, 2] under dist_scope (on
    ``devices``' parts when given: a sequence, or a grid of rows): digests
    of the unsharded outputs, both collective tallies and the bytes moved
    between blocks and between parts (per kind, and per axis)."""
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
        by_axis = axis_bytes(ctx.mesh, snap)
        um = D.unshard_ciphertext(dm, ctx)
        urots = [D.unshard_ciphertext(r, ctx) for r in drots]
    assert D.dist_active() is None
    return {"digests": pipeline_digests(um, urots, keysm.decrypt(um, ks.sk)),
            "collectives": counts, "executed": executed, "bytes": nbytes,
            "part_bytes": part_bytes, "axis_bytes": by_axis}


def _batched_run(cm, p, ks, ct1, ct2, device, devices=None) -> dict:
    """:func:`batched_chain` under dist_scope (on ``devices``' parts when
    given): the digests of its unsharded stages, both collective tallies and
    the bytes between blocks and, per axis, between parts."""
    from repro_torch.core import ckks, encoding as enc, poly as pl
    from repro_torch.core import distributed as D
    from repro_torch.kernels import config as kcfg

    with D.dist_scope(cm, device=device, devices=devices) as ctx:
        dk = D.shard_keyset(ks, ctx)
        d1 = D.shard_ciphertext(ct1, ctx)
        d2 = D.shard_ciphertext(ct2, ctx)
        dev = ctx.mesh.devices[0]
        make_pt = lambda res, basis: D.shard_poly(
            pl.RnsPoly(pl.to_tensor(res, dev), basis, pl.COEFF), ctx)
        before = kcfg.collective_counts()
        snap = ctx.mesh.snapshot()
        stages = batched_chain(ckks, enc, make_pt, p, dk, d1, d2)
        counts = kcfg.collectives_since(before)
        executed, nbytes = ctx.mesh.since(snap)
        by_axis = axis_bytes(ctx.mesh, snap)
        stages = {k: [D.unshard_ciphertext(c, ctx) for c in v]
                  for k, v in stages.items()}
    return {"digests": batched_digests(stages), "collectives": counts,
            "executed": executed, "bytes": nbytes, "axis_bytes": by_axis}


def grid_of(devices, rows: int = 1) -> list:
    """A flat sequence of devices as ``rows`` rows of a grid (one row: the
    sequence itself, the coefficient split alone)."""
    devices = list(devices)
    if rows == 1:
        return devices
    if len(devices) % rows:
        raise ValueError(f"{len(devices)} devices do not form {rows} rows")
    c = len(devices) // rows
    return [devices[a * c:(a + 1) * c] for a in range(rows)]


def maps_for_parts(n: int, D: int, rows: int = 1) -> list:
    """The maps of ``n`` shards a grid of ``rows`` × D/rows parts splits:
    rows | lc and D/rows | cs."""
    return [cm for cm in _maps_for(n)
            if cm.n_limb_clusters % rows == 0 and cm.block_size % (D // rows) == 0]


def reference_batched(p, ks, ct1, ct2) -> dict:
    """:func:`batched_chain`'s digests on the single-device eager engine."""
    from repro_torch.core import ckks, encoding as enc, poly as pl
    dev = ct1.a.device
    make_pt = lambda res, basis: pl.RnsPoly(pl.to_tensor(res, dev), basis, pl.COEFF)
    with ckks.use_engine("eager"):
        return batched_digests(batched_chain(ckks, enc, make_pt, p, ks, ct1, ct2))


def run_suite(n: int, N: int = 256, device="cuda", maps=None,
              reference: dict | None = None, devices=None) -> dict:
    """Every map of ``n`` shards (or ``maps``) — on ``devices``' parts (a
    sequence, or a grid of rows), every such map they split: primitives,
    then the pipeline, whose digests must equal ``reference`` (the
    single-device eager engine's, computed here when not given), then the
    batched chain against the single-device eager engine's; bytes between
    parts equal their closed forms per axis."""
    from repro_torch.core import distributed as D
    from repro_torch.core import params as prm

    # L = 8 divides the 2/4/8-cluster maps; the ℓ = 10 ModUp extension and
    # the post-rescale ℓ = 7 exercise the replicated-limb path
    p = prm.make_params(N=N, L=8, K=2, dnum=4)
    ks, ct1, ct2 = _make_inputs(p, device=device)
    if reference is None:
        reference = reference_pipeline(p, ks, ct1, ct2, "eager")
    ref_batched = reference_batched(p, ks, ct1, ct2)
    flat = [d for r in devices for d in (r if isinstance(r, list) else [r])] \
        if devices else [device]
    rows = len(devices) if devices and isinstance(devices[0], list) else 1
    cols = len(flat) // rows
    out: dict = {"n_shards": n, "N": N, "L": len(p.q), "device": str(device),
                 "devices": [str(d) for d in flat] if devices else None,
                 "grid": [rows, cols], "maps": []}
    rng = np.random.default_rng(11)
    for cm in maps or maps_for_parts(n, len(flat), rows):
        entry: dict = {"map": cm.name, "cs": cm.block_size,
                       "lc": cm.n_limb_clusters}
        t0 = time.perf_counter()
        with D.dist_scope(cm, device=device, devices=devices) as ctx:
            entry["prims"] = _prim_checks(ctx, p, rng, device)
        t1 = time.perf_counter()
        entry["pipeline"] = pipe = _pipeline_run(cm, p, ks, ct1, ct2, device, devices)
        entry["pipeline_exact"] = pipe["digests"] == reference
        entry["batched"] = bat = _batched_run(cm, p, ks, ct1, ct2, device, devices)
        entry["batched_exact"] = bat["digests"] == ref_batched
        print(f"  {cm.name}: prims {t1 - t0:.2f}s pipeline and batched "
              f"{time.perf_counter() - t1:.2f}s", file=sys.stderr, flush=True)
        assert entry["pipeline_exact"], (cm.name, "digest mismatch")
        assert entry["batched_exact"], (cm.name, "batched digest mismatch")
        for run, want in ((pipe, pipeline_bytes_closed_form(p, cm, rows, cols)),
                          (bat, batched_bytes_closed_form(p, cm, rows, cols))):
            assert run["executed"] == run["collectives"], (cm.name, run["executed"])
            assert run["axis_bytes"] == want, (cm.name, run["axis_bytes"], want)
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
    ap.add_argument("--rows", type=int, default=1,
                    help="grid rows the parts form along the limb axis (suite)")
    a = ap.parse_args(argv)
    n, extra = a.n_shards, a.args
    devices = None
    if a.cards > 1 or a.distinct:
        devices = grid_of([f"cuda:{k}" for k in range(a.cards)] if a.distinct
                          else [a.device] * a.cards, a.rows)
    if devices and a.mode != "suite":
        ap.error("--cards and --distinct apply to the suite")
    if a.mode == "suite":
        first = (devices[0][0] if isinstance(devices[0], list) else devices[0]) \
            if devices else a.device
        out = run_suite(n, *(extra[:1] or [256]), device=first, devices=devices)
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
