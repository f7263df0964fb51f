"""The distributed engine's mesh on a limb × coef grid of parts, on the CPU.

``repro_torch.core.distributed.Mesh(…, devices)`` takes a grid of ``Dl`` rows
by ``Dc`` columns (``devices=[["cpu"] * Dc] * Dl``): part (a, k) holds the
limb clusters a·lc/Dl … and the cores k·cs/Dc … of each, values between the
shard bodies are split over the rows or replicated over them, and the
collectives along "limb" copy between the parts of a grid column.  Every
kernel wrapper takes its plain version here.  At ``make_params(N=256, L=8,
K=2, dnum=4)``:

* each collective along both axes, on a limb-split and a replicated
  operand, and each primitive (four-step NTT both ways, BConv up and down,
  the slot-parallel AutoU), on every grid of four parts and every map of
  1–16 shards it splits, gives the one-part mesh's bytes and tallies, and
  its closed form between parts per axis;
* hmult → rescale → ``hrot_hoisted([1, 2])`` and the batched families
  (``_dist_selftest.batched_chain``: hmult_many → rescale_many → hrot_many
  → hadd_many → pmult_many, B = 4) under ``dist_scope`` on grids 1 × 1,
  1 × 2, 2 × 1 and 2 × 2 give the JAX package's single-device eager digests
  (``tests/torch_dist_ref.json``), executed collectives equal to the
  prediction and bytes between parts equal to their closed form per axis
  (``_dist_selftest._Flow``); the batched ops on several parts raised
  ``PartsError`` before ``ckks._stack_polys`` read ``devices``;
* what must raise: a grid that does not divide lc or cs, an operand on the
  wrong grid, a limb index that leaves its rows, and the bootstrap's
  layout-blind ops under a scope.

Tolerance: exact equality of bytes and counts.  No subprocess, no JAX.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import (_dist_selftest as S, bootstrap, ckks,
                              distributed as D, params as prm, poly as pl)
from repro_torch.core.mapping import ClusterMap
from repro_torch.core.parts import Parts, PartsError
from repro_torch.kernels import config

CPU = "cpu"
with open(os.path.join(os.path.dirname(__file__), "torch_dist_ref.json")) as _f:
    _REF = json.load(_f)
WANT = _REF["N"]["256"]["engines"]["eager"]
WANT_BATCHED = _REF["batched"]["256"]["digests"]

GRIDS4 = ((1, 4), (2, 2), (4, 1))
#: the pipeline and batched grids: one part, each axis alone, both
GRIDS = ((1, 1), (1, 2), (2, 1), (2, 2))


def _grid(rows, cols):
    return None if rows * cols == 1 else S.grid_of([CPU] * (rows * cols), rows)


@pytest.fixture(scope="module")
def n256():
    torch.set_num_threads(1)
    p = prm.make_params(N=256, L=8, K=2, dnum=4)
    return (p, *S._make_inputs(p, device=CPU))


def _joined(mesh, out):
    """A grid's blocks as the one-part mesh's (lc, cs, …) tensor."""
    if not isinstance(out, list):
        return out
    c = mesh.cols
    return torch.cat([torch.cat(out[a * c:(a + 1) * c], dim=1)
                      for a in range(mesh.rows)], dim=0)


def _collectives_match_one_part(cm, rows, cols):
    """all_to_all and all_gather along both axes on a limb-split and on a
    replicated (stride-0) operand: the one-part mesh's bytes and tallies,
    and between parts along "coef" (cols − 1)/cols of each row's words for
    the all-to-all and cols − 1 times them for the all-gather, along "limb"
    (rows − 1)/rows of each column's words and rows − 1 times them; a
    replicated operand's once for all limb clusters of a part (every row
    holds its own copy)."""
    lc, cs = cm.n_limb_clusters, cm.block_size
    one, grid = D.Mesh(lc, cs, CPU), D.Mesh(lc, cs, S.grid_of([CPU] * 4, rows))
    g = torch.Generator().manual_seed(cs * rows + cols)
    x = torch.randint(0, 1 << 30, (3, 16 * lc, 16 * cs), generator=g,
                      dtype=torch.int32)           # blocks of (3, 16 or 16·lc, 16)
    xg = grid.split(x)
    assert isinstance(xg, Parts) and xg.rows == rows and xg.split == (rows > 1)
    assert torch.equal(grid.join(xg), x)
    for sharded in (True, False):
        src = xg if sharded else grid.replicate(xg)
        b1, bg = one.place(x, sharded), grid.place(src, sharded)
        assert torch.equal(_joined(grid, bg), b1)
        words = b1.numel() * 4 if sharded else b1[:1].numel() * 4 * rows
        for axis, n in (("coef", cols), ("limb", rows)):
            for s, c in ((-1, -2), (-2, -1)):
                if axis == "limb" and not sharded:
                    continue      # a replicated operand is never exchanged along "limb"
                s1, sg = one.snapshot(), grid.snapshot()
                got, want = grid.all_to_all(bg, axis, s, c), one.all_to_all(b1, axis, s, c)
                assert torch.equal(_joined(grid, got), want)
                assert grid.since(sg) == one.since(s1)
                assert grid.parts_since(sg, axis) == (
                    {"all_to_all": words * (n - 1) // n} if n > 1 else {})
            if axis == "limb" and not sharded:
                continue
            s1, sg = one.snapshot(), grid.snapshot()
            got, want = grid.all_gather(bg, axis, -1), one.all_gather(b1, axis, -1)
            assert torch.equal(_joined(grid, got), want)
            assert grid.since(sg) == one.since(s1)
            assert grid.parts_since(sg, axis) == (
                {"all_gather": words * (n - 1)} if n > 1 else {})
        assert torch.equal(grid.join(grid.collect(bg, sharded, (3,))), x)


def test_grid_collectives_and_primitives_equal_one_part(n256):
    """On the 1 × 4, 2 × 2 and 4 × 1 grids of CPU parts, every map of 1–16
    shards the grid splits (rows | lc, cols | cs): the collectives
    (:func:`_collectives_match_one_part`), then each primitive under the
    scope against the same primitive on one part — equal bytes (both also
    equal the permuted single-device result), equal executed collectives and
    bytes between blocks, both tallies equal to the prediction, and between
    parts the closed form per axis (``_dist_selftest.part_bytes_closed_form``,
    asserted by ``_prim_checks``)."""
    p = n256[0]
    config.reset_launches()
    ran = set()
    for rows, cols in GRIDS4:
        for n in (1, 2, 4, 8, 16):
            for cm in S.maps_for_parts(n, 4, rows):
                ran.add((rows, cols))
                _collectives_match_one_part(cm, rows, cols)
                runs = {}
                for devices in (None, _grid(rows, cols)):
                    with D.dist_scope(cm, device=CPU, devices=devices) as ctx:
                        runs[bool(devices)] = S._prim_checks(
                            ctx, p, np.random.default_rng(11), CPU)
                for op, res in runs[True].items():
                    one = runs[False][op]
                    assert res["exact"] and res["counts_match"], (cm.name, op, res)
                    assert (res["digest"], res["executed"], res["bytes"]) == \
                        (one["digest"], one["executed"], one["bytes"]), (cm.name, op)
                    assert res["executed"] == res["predicted"], (cm.name, op)
                    assert one["axis_bytes"] == {}
    assert ran == set(GRIDS4)
    assert config.launch_counts() == {}


def test_grid_pipeline_and_batched_ops_give_the_jax_digests(n256):
    """hmult → rescale → hrot_hoisted([1, 2]) and the batched families under
    dist_scope on grids 1 × 1, 1 × 2, 2 × 1 and 2 × 2 of the CPU, for the
    maps of 4 and 16 shards each grid splits: the JAX package's
    single-device eager digests, both collective tallies equal to the
    prediction and the one-part mesh's, and the bytes between parts per
    axis equal to their closed forms (``pipeline_bytes_closed_form``,
    ``batched_bytes_closed_form``).  The batched ops' repair: a multi-part
    poly has no ``device`` (what ``ckks._stack_polys`` read before, raising
    ``PartsError`` on two or more parts); they now stack its parts."""
    p, ks, ct1, ct2 = n256
    seen = {}
    for rows, cols in GRIDS:
        maps = [cm for n in (4, 16) for cm in S.maps_for_parts(n, rows * cols, rows)]
        for cm in maps:
            devs = _grid(rows, cols)
            pipe = S._pipeline_run(cm, p, ks, ct1, ct2, CPU, devs)
            bat = S._batched_run(cm, p, ks, ct1, ct2, CPU, devs)
            assert pipe["digests"] == WANT, (rows, cols, cm.name)
            assert bat["digests"] == WANT_BATCHED, (rows, cols, cm.name)
            for run, want in ((pipe, S.pipeline_bytes_closed_form(p, cm, rows, cols)),
                              (bat, S.batched_bytes_closed_form(p, cm, rows, cols))):
                assert run["executed"] == run["collectives"], (rows, cols, cm.name)
                assert run["axis_bytes"] == want, (rows, cols, cm.name)
                one = seen.setdefault((cm.name, run is bat), run)
                assert (run["executed"], run["bytes"]) == (one["executed"], one["bytes"])
    # limb duplication's all-gather and the regroups cross the rows of 2 × 2
    cm = ClusterMap.parse("2x4-BK-2x2")
    assert set(S.batched_bytes_closed_form(p, cm, 2, 2)["limb"]) == {"all_gather",
                                                                       "regroup"}
    with D.dist_scope("4x4-BK-2x2", devices=_grid(2, 2)) as ctx:
        a = D.shard_poly(ct1.a, ctx)
        with pytest.raises(PartsError):
            a.device
        two = ckks._stack_polys([a, a])
        assert two.devices == a.devices and two.data.shape == (2, *a.data.shape)


def test_grid_refuses_what_it_cannot_hold(n256):
    """A grid whose rows do not divide lc or whose columns do not divide cs
    raises ValueError, as does one of unequal rows; an operand on another
    grid of the same devices raises; a limb index of a row-split value
    raises (``RnsPoly.limbs`` regroups it through the mesh instead), while
    one of a replicated value maps over its parts; under a scope the
    bootstrap's natural-order tables raise NotImplementedError naming
    ROADMAP A.17 (CoeffToSlot returned other bytes than the single-device
    engine)."""
    p, ks, ct1, ct2 = n256
    for lc, cs, grid in ((2, 4, S.grid_of([CPU] * 4, 4)),        # 4 ∤ lc
                         (4, 2, S.grid_of([CPU] * 8, 2)),        # 4 ∤ cs
                         (4, 4, [[CPU, CPU], [CPU]])):           # unequal rows
        with pytest.raises(ValueError):
            D.Mesh(lc, cs, grid)
    with pytest.raises(ValueError):
        D.dist_scope("4x4-coef-scatter", devices=_grid(2, 2))    # lc = 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            D.Mesh(2, 2, [["cuda:0"], ["cuda:1"]])               # no CPU fallback
    plain = ct1.a.to_ntt()
    with D.dist_scope("4x4-BK-2x2", devices=_grid(2, 2)) as ctx:
        a = D.shard_poly(plain, ctx)                              # ℓ = 8: split
        assert a.data.split and a.data.rows == 2
        with pytest.raises(PartsError):
            a.data[..., 2:4, :]                                   # leaves its rows
        with pytest.raises(PartsError):
            torch.cat([a.data, a.data], dim=-2)
        got = a.limbs(slice(3, 7))                                # regrouped
        assert np.array_equal(pl.to_numpy(got.data), pl.to_numpy(a.data)[3:7])
        rep = ctx.mesh.replicate(a.data)
        assert not rep.split and np.array_equal(pl.to_numpy(rep[..., 2:4, :]),
                                                pl.to_numpy(a.data)[2:4])
        with D.dist_scope("4x4-BK-2x2", devices=_grid(4, 1)) as ctx41:
            other = D.shard_poly(plain, ctx41)
        with pytest.raises(PartsError):
            a + other                                             # same devices, 4 × 1
        with pytest.raises(PartsError):
            D.sharded_ntt(ctx41, a.data, p.q, False)
        dct = D.shard_ciphertext(ct1, ctx)
        for layout_blind in (lambda: ckks.mul_monomial(dct, 4),
                             lambda: bootstrap.mul_const_vec(dct, np.ones(4), p),
                             lambda: bootstrap.linear_transform(dct, {0: np.ones(4)},
                                                                None)):
            with pytest.raises(NotImplementedError, match="A.17"):
                layout_blind()
