"""The distributed engine's mesh split into parts along "coef", on the CPU.

``repro_torch.core.distributed.Mesh(…, devices)`` splits the coefficient axis
of a mesh over D devices; here D ∈ {2, 4} parts of the CPU, where every kernel
wrapper takes its plain version.  Held, on every map of 1, 2, 4, 8 and 16
logical shards at ``make_params(N=256, L=8, K=2, dnum=4)`` whose block size D
divides:

* each collective, on blocks of limb-split and replicated operands, gives the
  one-part mesh's bytes and tallies, and copies its closed form between
  parts; each primitive (four-step NTT both ways, BConv up and down, the
  slot-parallel AutoU) gives the one-part engine's bytes and tallies, and its
  closed form between parts;
* hmult → rescale → ``hrot_hoisted([1, 2])`` under ``dist_scope(cm,
  devices=["cpu"] * D)`` gives the JAX package's single-device eager digests
  (``tests/torch_dist_ref.json``), with the one-part mesh's collectives and
  bytes, and both collective tallies equal to the prediction;
* what must raise: parts that do not divide the block size, an operand on
  the wrong parts, an op that mixes coefficients across parts outside the
  sharded primitives.

Tolerance: exact equality of bytes and counts.  No subprocess, no JAX.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import _dist_selftest as S
from repro_torch.core import bconv as bc, distributed as D, params as prm, poly as pl
from repro_torch.core.mapping import ClusterMap
from repro_torch.core.parts import Parts, PartsError
from repro_torch.kernels import config

CPU = "cpu"
with open(os.path.join(os.path.dirname(__file__), "torch_dist_ref.json")) as _f:
    WANT = json.load(_f)["N"]["256"]["engines"]["eager"]

SHARDS = (1, 2, 4, 8, 16)
CASES = [(n_parts, cm) for n_parts in (2, 4) for n in SHARDS
         for cm in S.maps_for_parts(n, n_parts)]


@pytest.fixture(scope="module")
def n256():
    p = prm.make_params(N=256, L=8, K=2, dnum=4)
    return (p, *S._make_inputs(p, device=CPU))


def _joined(out):
    """A multi-part mesh's blocks as the one-part mesh's (lc, cs, …) tensor."""
    return torch.cat(out, dim=1) if isinstance(out, list) else out


def _collectives_match_one_part(cm, n_parts):
    """all_to_all and all_gather along both axes on a limb-split and on a
    replicated (stride-0) operand: the one-part mesh's bytes and tallies, and
    between parts the closed form — along "coef" (D − 1)/D of the operand
    for the all-to-all and D − 1 times it for the all-gather, a replicated
    operand counted once for all limb clusters; along "limb" nothing."""
    lc, cs = cm.n_limb_clusters, cm.block_size
    one, multi = D.Mesh(lc, cs, CPU), D.Mesh(lc, cs, [CPU] * n_parts)
    g = torch.Generator().manual_seed(cs * n_parts)
    x = torch.randint(0, 1 << 30, (3, 16 * lc, 16 * cs), generator=g,
                      dtype=torch.int32)          # blocks of (3, 16 or 16·lc, 16)
    xp = multi.split(x)
    for sharded in (True, False):
        b1, bm = one.place(x, sharded), multi.place(xp, sharded)
        assert torch.equal(_joined(bm), b1)
        words = b1[:1].numel() * 4 if not sharded else b1.numel() * 4
        for axis in D.AXES:
            coef = axis == "coef"
            for s, c in ((-1, -2), (-2, -1)):
                s1, sm = one.snapshot(), multi.snapshot()
                got, want = multi.all_to_all(bm, axis, s, c), one.all_to_all(b1, axis, s, c)
                assert torch.equal(_joined(got), want)
                assert multi.since(sm) == one.since(s1)
                assert multi.parts_since(sm) == (
                    {"all_to_all": words * (n_parts - 1) // n_parts} if coef else {})
            s1, sm = one.snapshot(), multi.snapshot()
            got, want = multi.all_gather(bm, axis, -1), one.all_gather(b1, axis, -1)
            assert torch.equal(_joined(got), want)
            assert multi.since(sm) == one.since(s1)
            assert multi.parts_since(sm) == (
                {"all_gather": words * (n_parts - 1)} if coef else {})
        assert torch.equal(multi.join(multi.collect(bm, sharded, (3,))), x)


def test_parts_collectives_and_primitives_equal_one_part(n256):
    """On 2 and 4 parts, every map whose block size they divide: the collectives
    (:func:`_collectives_match_one_part`), then each primitive under the
    scope on D parts against the same primitive on one part — equal bytes
    (both also equal the permuted single-device result), equal executed
    collectives and bytes between blocks, both tallies equal to the
    prediction, and between parts the closed form
    (``_dist_selftest.part_bytes_closed_form``, asserted by ``_prim_checks``)."""
    p = n256[0]
    config.reset_launches()
    assert {k for k, _ in CASES} == {2, 4}
    for n_parts, cm in CASES:
        assert cm.block_size % n_parts == 0
        _collectives_match_one_part(cm, n_parts)
        runs = {}
        for devices in (None, [CPU] * n_parts):
            with D.dist_scope(cm, device=CPU, devices=devices) as ctx:
                assert ctx.mesh.n_parts == (n_parts if devices else 1)
                runs[bool(devices)] = S._prim_checks(ctx, p, np.random.default_rng(11), CPU)
        for op, res in runs[True].items():
            one = runs[False][op]
            assert res["exact"] and res["counts_match"], (cm.name, op, res)
            assert (res["digest"], res["executed"], res["bytes"]) == \
                (one["digest"], one["executed"], one["bytes"]), (cm.name, op)
            assert res["executed"] == res["predicted"], (cm.name, op)
            assert one["part_bytes"] == {}
    assert config.launch_counts() == {}


def test_parts_pipeline_gives_the_jax_digests(n256):
    """hmult → rescale → hrot_hoisted([1, 2]) under dist_scope on 2 and 4
    parts of the CPU, every map whose block size they divide: the JAX
    package's single-device eager digests, the one-part mesh's collectives
    and bytes between blocks, both tallies equal to the prediction, and the
    same bytes between parts on every map (replicated operands travel once,
    so only ℓ, N and D enter); a sharded key set whose caches were dropped
    regenerates its a-halves into the parts."""
    p, ks, ct1, ct2 = n256
    between = {}
    for n_parts, cm in CASES:
        out = S._pipeline_run(cm, p, ks, ct1, ct2, CPU, [CPU] * n_parts)
        one = S._pipeline_run(cm, p, ks, ct1, ct2, CPU)
        assert out["digests"] == WANT, (n_parts, cm.name)
        assert out["executed"] == out["collectives"] == one["executed"], cm.name
        assert out["bytes"] == one["bytes"], cm.name
        assert set(out["part_bytes"]) == {"all_to_all", "all_gather"}
        assert between.setdefault(n_parts, out["part_bytes"]) == out["part_bytes"]
    # a sharded key regenerates its dropped a-halves into the parts
    from repro_torch.core import ckks, keys as keysm
    with D.dist_scope("4x4-BK-2x2", devices=[CPU] * 4) as ctx:
        dk = D.shard_keyset(ks, ctx)
        dk.drop_device_caches()
        dm = ckks.rescale(ckks.hmult(D.shard_ciphertext(ct1, ctx),
                                     D.shard_ciphertext(ct2, ctx), dk), p)
        rots = [D.unshard_ciphertext(r, ctx) for r in ckks.hrot_hoisted(dm, [1, 2], dk)]
        um = D.unshard_ciphertext(dm, ctx)
    assert S.pipeline_digests(um, rots, keysm.decrypt(um, ks.sk)) == WANT
    assert D.dist_active() is None


def test_parts_refuse_what_they_cannot_hold(n256):
    """Parts that do not divide the block size raise ValueError; an operand
    on other parts (a plain tensor, another part count) raises; ops that
    mix coefficients across parts outside the sharded primitives raise —
    an NTT, an automorphism or a BConv outside the scope, an index, a
    reshape or a move of the coefficient axis, a torch function that is
    not position-wise."""
    p, ks, ct1, ct2 = n256
    with pytest.raises(ValueError):
        D.Mesh(2, 2, [CPU] * 4)
    with pytest.raises(ValueError):
        ClusterMap.parse("4x4-BK-2x2").make_mesh(devices=[CPU] * 3)
    with pytest.raises(ValueError):
        D.dist_scope("2x4-DW", devices=[CPU] * 4)          # cs = 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            D.Mesh(1, 2, ["cuda:0", "cuda:1"])               # no CPU fallback
    plain = ct1.a.to_ntt()
    with D.dist_scope("4x4-BK-2x2", devices=[CPU] * 4) as ctx:
        a, b = D.shard_poly(plain, ctx), D.shard_poly(ct2.a.to_ntt(), ctx)
        assert isinstance(a.data, Parts) and a.devices == (torch.device(CPU),) * 4
        assert np.array_equal(pl.to_numpy((a * b).data), pl.to_numpy(
            D.shard_poly(plain * ct2.a.to_ntt(), ctx).data))
        assert np.array_equal(pl.to_numpy(a.data[..., 2:4, :]),
                              pl.to_numpy(a.data)[2:4])
        with pytest.raises(PartsError):
            a * plain                                        # a tensor on one device
        with D.dist_scope("4x4-BK-2x2", devices=[CPU] * 2) as ctx2:
            two = D.shard_poly(plain, ctx2)
        with pytest.raises(PartsError):
            a + two                                          # other parts
        with pytest.raises(PartsError):
            D.sharded_ntt(ctx2, a.data, p.q, False)          # a mesh of 2 parts
        with pytest.raises(PartsError):
            a.device
    for mixing in (lambda: a.to_coeff(), lambda: a.automorphism_by_gelt(5),
                   lambda: bc.bconv_raw(a.data, p.q, p.p),
                   lambda: a.data[..., :4], lambda: a.data[0, 1],
                   lambda: a.data.index_select(-1, torch.arange(4)),
                   lambda: a.data.to(CPU), lambda: a.data.expand(2, 8, 128),
                   lambda: torch.roll(a.data, 1, -1),
                   lambda: torch.cat([a.data, b.data], dim=-1),
                   lambda: torch.stack([a.data, b.data], dim=-1)):
        with pytest.raises(PartsError):
            mixing()
