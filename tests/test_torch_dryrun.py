"""The port's dry-run tools on the CPU, held to the JAX package's spec layer
and key-switch digests recorded in ``tests/torch_dryrun_ref.json`` by
``tests/make_torch_dryrun_ref.py`` (no JAX here, no subprocess).

1. The parameter, cache, token and frontend specs of all ten archs equal the
   reference's, leaf for leaf (a stacked leaf's spec without its layer
   axis), on the (2, 4), (16, 16) and (2, 16, 16) meshes, in the layouts 2d,
   replicated and fsdp_all; ``get_cell`` and ``shape_applicable`` too.
2. The reference's own test cell, xlstm-1.3b × decode_32k on the fake
   (16, 16) pod: ok, FLOPs > 0, temp < 16 GiB, argument bytes equal to the
   padded-shard closed form of the recorded specs; an expert-parallel
   redistribution counted as one all-to-all; every figure of a tiny sharded
   program against its closed form; the wire-byte formulas; and for
   qwen3-4b decode (four layers) on the (2, 4) mesh the L1/L2 extrapolation
   equal to the full-depth count.
3. ``key_switch`` under ``mapping_scope`` with ARK and with limb
   duplication on 2 × 2 logical CPU shards at N = 2⁸: the JAX digests, the
   predicted collectives executed, the bytes of the closed form; a batch of
   two on the multi-pod mesh with nothing across "pod".
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import pytest
import torch

from repro_torch.core import bconv as bc
from repro_torch.core import ckks
from repro_torch.core import distributed as D
from repro_torch.core import params as prm
from repro_torch.interop import reference_path
from repro_torch.launch import dryrun, dryrun_fhe, hlo, specs as S
from repro_torch.launch.mesh import (fake_world, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import registry, sharding as shd_mod
from repro_torch.models.config import SHAPES

REF = json.loads((Path(__file__).parent / "torch_dryrun_ref.json").read_text())
WORLDS = {"host": 8, "pod": 256, "multipod": 512}
LAYOUTS = {"2d": dict(fsdp=True, layout="2d"),
           "replicated": dict(fsdp=False, layout="2d"),
           "fsdp_all": dict(fsdp=True, layout="fsdp_all")}
DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int32: "int32"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(spec) -> tuple:
    """A spec with its one-axis tuples as bare names (both packages' forms)."""
    out = []
    for e in spec:
        if isinstance(e, (list, tuple)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out)


def _mesh(kind: str):
    return make_host_mesh(8) if kind == "host" else make_production_mesh(
        multi_pod=kind == "multipod")


def _leaves(tree, prefix=""):
    """{reference path: tensor} of a cache tree of dicts and tuples."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _one_stack(want: dict) -> dict:
    """The reference's moe cache — a list ``first`` of the dense first layers'
    unstacked caches beside the stack ``layers`` — as the port holds it, one
    stack over every layer; each ``first`` leaf's spec must be the stack's
    without its layer axis."""
    if not any(p.startswith("first/") for p in want):
        return want
    out = {}
    for p, w in want.items():
        if p.startswith("layers/"):
            firsts = [v for q, v in want.items()
                      if q.startswith("first/") and q.split("/", 2)[2] == p[7:]]
            assert all(_norm(f["spec"]) == _norm(w["spec"])[1:] for f in firsts), p
            out[p[7:]] = dict(w, shape=[w["shape"][0] + len(firsts), *w["shape"][1:]])
    return out


def test_specs_equal_the_reference_on_every_mesh_and_layout():
    bad = []
    for mk, world in WORLDS.items():
        with fake_world(world):
            mesh = _mesh(mk)
            dp = ("pod", "data") if mk == "multipod" else ("data",)
            if shd_mod.input_sharding(mesh) != (dp,) or shd_mod.input_sharding(mesh, False):
                bad.append((mk, "input_sharding", shd_mod.input_sharding(mesh)))
            for arch in registry.ARCHS:
                cfg = registry.get_config(arch)
                ref = REF["archs"][arch]
                model = S.param_shapes(cfg)
                named = dict(model.named_parameters())
                for lk, kw in LAYOUTS.items():
                    shd = S.param_shardings(cfg, mesh, model, **kw)
                    ref_specs = ref["param_specs"][mk][lk]
                    seen = set()
                    for name, t in named.items():
                        path, index = reference_path(name)
                        key = "/".join(path)
                        seen.add(key)
                        leaf = ref["params"][key]
                        want_shape = leaf["shape"][len(index):]
                        want = _norm(ref_specs[key])[len(index):]
                        if (list(t.shape) != want_shape or DTYPES[t.dtype] != leaf["dtype"]
                                or _norm(shd[name].spec) != want):
                            bad.append((mk, arch, lk, name, shd[name].spec, want))
                    if seen != set(ref_specs):
                        bad.append((mk, arch, lk, "leaves", sorted(set(ref_specs) ^ seen)))
                for shape, modes in ref["cache"][mk].items():
                    cell = S.get_cell(arch, shape)
                    cshape = S.cache_shapes(cfg, cell.global_batch, cell.seq_len)
                    for seq, want in modes.items():
                        got = _leaves(S.cache_shardings(cfg, mesh, cshape, cell.global_batch,
                                                        seq_shard=seq == "True"))
                        shapes = _leaves(cshape)
                        want = _one_stack(want)
                        if set(got) != set(want):
                            bad.append((mk, arch, shape, seq, sorted(got), sorted(want)))
                            continue
                        for p, w in want.items():
                            if (_norm(got[p].spec) != _norm(w["spec"])
                                    or list(shapes[p].shape) != w["shape"]
                                    or DTYPES[shapes[p].dtype] != w["dtype"]):
                                bad.append((mk, arch, shape, seq, p, got[p].spec, w))
                for shape, sh in SHAPES.items():
                    tok, tok_shd = S.token_specs(cfg, mesh, sh["global_batch"], sh["seq_len"])
                    w = ref["tokens"][mk][shape]
                    if list(tok.shape) != w["shape"] or _norm(tok_shd.spec) != _norm(w["spec"]):
                        bad.append((mk, arch, shape, "tokens", tok_shd.spec, w))
                    fe, fe_shd = S.frontend_specs(cfg, mesh, sh["global_batch"])
                    w = ref["frontend"][mk][shape]
                    got = None if fe is None else [list(fe.shape), _norm(fe_shd.spec)]
                    if got != (None if w is None else [w["shape"], _norm(w["spec"])]):
                        bad.append((mk, arch, shape, "frontend", got, w))
    for name, want in REF["cells"].items():
        arch, shape = name.split("__")
        c = S.get_cell(arch, shape)
        ok, why = registry.shape_applicable(registry.get_config(arch), shape)
        got = {"arch": c.arch, "shape": c.shape, "kind": c.kind, "seq_len": c.seq_len,
               "global_batch": c.global_batch, "name": c.name, "applicable": ok, "why": why}
        if got != want:
            bad.append((name, got, want))
    assert not bad, bad[:10]


def _padded_bytes(shape, dtype, spec, sizes) -> int:
    """Rank 0's bytes of a leaf: each sharded dim cut to the ceiling of its
    share, as XLA pads every shard."""
    n = {"float32": 4, "bfloat16": 2, "int32": 4}[dtype]
    spec = list(_norm(spec)) + [None] * (len(shape) - len(spec))
    for dim, e in zip(shape, spec):
        axes = () if e is None else (e,) if isinstance(e, str) else e
        n *= -(-dim // math.prod(sizes[a] for a in axes))
    return n


def test_dryrun_cells_on_fake_meshes():
    # the reference's own test cell, its assertions, and the closed form
    rec = dryrun.run_cell("xlstm_1_3b", "decode_32k", "pod", scale_metrics=False)
    assert rec["ok"], rec.get("error")
    assert rec["flops"] > 0
    assert rec["memory"]["temp_bytes"] < 16 * 2**30
    assert rec["collectives"]["total"] > 0
    ref = REF["archs"]["xlstm_1_3b"]
    sizes = {"data": 16, "model": 16}
    want = sum(_padded_bytes(ref["params"][p]["shape"], ref["params"][p]["dtype"], s, sizes)
               for p, s in ref["param_specs"]["pod"]["2d"].items())
    want += sum(_padded_bytes(w["shape"], w["dtype"], w["spec"], sizes)
                for w in ref["cache"]["pod"]["decode_32k"]["False"].values())
    tok = ref["tokens"]["pod"]["decode_32k"]
    want += _padded_bytes([tok["shape"][0], 1], "int32", tok["spec"], sizes)
    assert rec["memory"]["argument_bytes"] == want

    # an expert-parallel exchange (Shard→Shard on one mesh dim) is one all-to-all
    with fake_world(8):
        mesh = make_host_mesh(8)
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            x = dryrun.fake_dtensor((64, 8, 256), torch.bfloat16,
                                    S.NamedSharding(mesh, (None, "model")))
        got = hlo.analyze(lambda t: t.redistribute(mesh, S.NamedSharding(
            mesh, (None, None, "model")).placements), (x,))
        assert got["collective_counts"] == {"all-to-all": 1}, got
        assert got["collectives"]["all-to-all"] == 64 * 2 * 256 * 2 * 3 / 4

        # every figure of a tiny program pinned to its closed form, so that
        # a torch whose DTensor moves ops between counted and bookkeeping
        # fails here: x (15, 12) on (data, model), uneven over "data" (rank 0
        # holds 8 rows), w (12, 20) on (model, -); rank 0's product (8, 3) @
        # (3, 20) is partial over "model", made whole by one all-reduce, plus
        # a table the program makes itself
        with FakeTensorMode():
            x = dryrun.fake_dtensor((15, 12), torch.float32,
                                    S.NamedSharding(mesh, ("data", "model")))
            w = dryrun.fake_dtensor((12, 20), torch.float32,
                                    S.NamedSharding(mesh, ("model", None)))
        rows = S.NamedSharding(mesh, ("data", None)).placements
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            got = hlo.analyze(lambda x, w: (x @ w).redistribute(mesh, rows)
                              + torch.arange(20, dtype=torch.float32), (x, w))
        y = 8 * 20 * 4                                  # rank 0's output bytes
        assert got["collective_counts"] == {"all-reduce": 1}, got
        assert got["collectives"]["all-reduce"] == 2 * y * 3 / 4
        assert got["flops"] == 2 * 8 * 3 * 20 + 8 * 20
        assert got["bytes_accessed"] == (8 * 3 + 3 * 20) * 4 + y + 20 * 4 + (y + 20 * 4) + y
        assert got["memory"]["argument_bytes"] == (8 * 3 + 3 * 20) * 4
        assert got["memory"]["output_bytes"] == y

        # the L1/L2 method against the full-depth count (qwen3-4b decode,
        # cut to a homogeneous stack of four layers: the same check of the
        # method; the sweep's pod cell holds it at all 36)
        cfg = dryrun.with_layers(registry.get_config("qwen3_4b"), 4)
        cell = S.get_cell("qwen3_4b", "decode_32k")
        full, _ = dryrun.lower_cell(cfg, mesh, cell)
        m1, _ = dryrun.lower_cell(dryrun.with_layers(cfg, 1), mesh, cell)
        m2, _ = dryrun.lower_cell(dryrun.with_layers(cfg, 2), mesh, cell)
    scaled = dryrun._scaled_full(cfg, full, m1, m2)
    assert scaled["flops_scaled"] == full["flops"] > 0
    assert scaled["argument_bytes_scaled"] == full["memory"]["argument_bytes"]

    # the reference's wire-byte formulas
    for kind, i, o, g, wire in [("all-gather", 256, 1024, 4, 768.0),
                                ("reduce-scatter", 1024, 256, 4, 768.0),
                                ("all-reduce", 512, 512, 4, 768.0),
                                ("all-to-all", 512, 512, 2, 256.0),
                                ("collective-permute", 32, 32, 2, 32.0),
                                ("all-gather", 64, 64, 1, 0.0)]:
        assert hlo.Collective(kind, i, o, g).wire_bytes == wire


def test_mapping_policies_give_the_reference_bytes():
    p = prm.make_params(N=256, L=8, K=2, dnum=4)
    ks = REF["key_switch"]
    for name, policy in dryrun_fhe.POLICIES.items():
        for mesh_kind, want in (("pod", ks["batch1"]), ("multipod", ks["batch2"])):
            rec = dryrun_fhe.run_cell(mesh_kind, name, ks["ell"], limb_clusters=2,
                                      device="cpu", params=p, n_cores=4, warm_reps=0)
            assert rec["ok"], rec.get("error")
            assert rec["digests"] == want, (name, mesh_kind)
            n_bconv = 5 * len(want)     # four digits' ModUp, one ModDown, per member
            assert rec["executed"] == rec["predicted"] == (
                {"all_to_all": 2 * n_bconv} if name == "ark" else {"all_gather": n_bconv})
            assert rec["collectives"]["total"] == rec["bconv_bytes_closed_form"] > 0
            per_pod = {k: v // len(want) for k, v in rec["executed"].items()}
            assert rec["executed_by_pod"] == [per_pod] * len(want)
            assert rec["cluster_map"] == "2x2-BK-1x2"
    mesh = D.Mesh(2, 2, "cpu")
    with ckks.use_engine("fused"):
        assert ckks._use_fused() and not bc.policy_active()
        with bc.mapping_scope(mesh, D.ARK_POLICY):
            assert bc.policy_active() and not ckks._use_fused()
        assert ckks._use_fused() and not bc.policy_active()
