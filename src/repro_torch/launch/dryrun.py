"""Multi-pod dry-run: lower every (architecture × input shape × mesh) cell
on the production meshes and record per-device memory, cost and collective
figures — the proof that the distribution config is coherent without real
hardware (the port of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun --arch qwen3_4b --shape train_4k \\
        --mesh pod --out experiments/dryrun

"Lowering" a cell runs its step once on DTensors over a fake 256/512-rank
``DeviceMesh`` (:func:`repro_torch.launch.mesh.fake_world`), every local
shard a fake tensor (``FakeTensorMode``): the model is the port's, unchanged,
its parameters, optimizer state, caches and inputs placed by
:mod:`repro_torch.launch.specs`, its activations constrained by
``layers.maybe_shard`` under :func:`~repro_torch.models.sharding.
mesh_context`.  Nothing is allocated and no card is used — that is the
design, as the reference's forced XLA host devices: the figures are
predictions for a mesh of chips nobody ran.  A train cell is one
``loss_fn`` → backward → AdamW step, a prefill cell ``prefill`` (the audio
family ``forward``), a decode cell one ``decode_step`` against a
``seq_len``-deep cache.  Plain tensors the model makes inside (RoPE tables,
masks, positions, recurrent zero states) meet the DTensors under
``implicit_replication()`` (an experimental DTensor API): each counts as
replicated.  An op DTensor has no sharding rule for on its inputs'
placements runs on replicated inputs (``replicated_ops`` in the record
counts them; the replication's collectives are counted with the rest).
:mod:`repro_torch.launch.hlo` counts what rank 0 runs.

The reference's XLA counts a scanned layer body once and recovers per-layer
figures by the L1/L2 delta method; the port runs every layer, so the full
depth is counted directly and, for a homogeneous stack, ``_scaled_full``'s
extrapolation equals it — a check of the method, not a correction.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
from torch import nn

from repro_torch import optim
from repro_torch.launch import hlo
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models.sharding import mesh_context

#: the ranks of each production mesh
MESH_RANKS = {"pod": 256, "multipod": 512}


def scan_unit(cfg) -> int:
    if cfg.family == "hybrid" and cfg.attn_every:
        return cfg.attn_every
    if cfg.family == "ssm" and cfg.slstm_every:
        return cfg.slstm_every
    return 1


def with_layers(cfg, units: int):
    """Reduced-depth variant with ``units`` scan units, for per-layer
    deltas (the port's layers are always unrolled)."""
    unit = scan_unit(cfg)
    n = cfg.moe_first_dense + unit * units
    kw = {"n_layers": n, "unroll": True}
    if cfg.family == "audio":
        kw["enc_layers"] = units
    return dataclasses.replace(cfg, **kw)


def fake_dtensor(shape, dtype, sharding: S.NamedSharding, requires_grad: bool = False):
    """A DTensor of global ``shape`` whose rank-0 shard is a fresh fake
    tensor (call under a ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh, pl = sharding.mesh, sharding.placements
    local_shape = list(shape)
    for size, p in zip(mesh.shape, pl):       # rank 0: the first chunk, ceil
        if isinstance(p, Shard):
            local_shape[p.dim] = -(-local_shape[p.dim] // size)
    local = torch.empty(local_shape, dtype=dtype, device=mesh.device_type)
    stride = torch.empty(shape, device="meta").stride()
    dt = DTensor.from_local(local, mesh, pl, run_check=False,
                            shape=torch.Size(shape), stride=stride)
    return dt.requires_grad_(requires_grad)


def _place_params(model: nn.Module, shardings: dict, requires_grad: bool) -> nn.Module:
    """``model`` (on the meta device) with every parameter replaced by a
    fake DTensor of its sharding."""
    for name, p in list(model.named_parameters()):
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        dt = fake_dtensor(p.shape, p.dtype, shardings[name])
        owner._parameters[leaf] = nn.Parameter(dt, requires_grad=requires_grad)
    return model


@contextlib.contextmanager
def _opts_scope(opts):
    """The global knobs of ``dp_over_model`` and ``chunk_attn``, restored on
    exit (the reference sets them for its one cell per process)."""
    saved = (dict(L._LOGICAL), S.DP_AXES, L.CHUNKED_THRESHOLD)
    try:
        if "dp_over_model" in opts:
            L.set_logical_axes(dp=("pod", "data", "model"), tp=None)
            S.set_dp_axes(("pod", "data", "model"))
        if "chunk_attn" in opts:
            L.set_chunked_threshold(2048)
        yield
    finally:
        L._LOGICAL.update(saved[0])
        S.set_dp_axes(saved[1])
        L.set_chunked_threshold(saved[2])


class _ReplicateFallback(torch.overrides.TorchFunctionMode):
    """Where DTensor has no sharding rule for an op (``log_sigmoid_forward``),
    or none for its inputs' placements (a view that splits a dim sharded
    over more ranks than it has rows: the xLSTM's 4 heads over 16), replicate
    every DTensor input — an all-gather or all-reduce, counted — run the op
    on the local replicas and hand its result back replicated: the op runs,
    on replicated data.  An op that writes into its input fails instead.
    ``count``: how many times, per function."""

    def __init__(self):
        super().__init__()
        self.count: dict[str, int] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_map_only
        kwargs = kwargs or {}
        try:
            return func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            name = getattr(func, "__name__", str(func))
            inplace = name.endswith("_") and not name.startswith("__") \
                or name == "__setitem__"
            msg = str(e)
            if inplace or not ("Sharding propagation failed" in msg
                               or "does not have a sharding strategy" in msg):
                raise
        self.count[name] = self.count.get(name, 0) + 1
        mesh = next(t.device_mesh for t in
                    torch.utils._pytree.tree_leaves((args, kwargs))
                    if isinstance(t, DTensor))
        rep = [Replicate()] * mesh.ndim
        args, kwargs = tree_map_only(
            DTensor, lambda t: t.redistribute(mesh, rep).to_local(), (args, kwargs))
        return tree_map_only(torch.Tensor, lambda t: DTensor.from_local(
            t, mesh, rep, run_check=False), func(*args, **kwargs))


def _train_step(mod, cfg, tcfg: dict):
    def step_fn(params, opt_state, batch, step):
        named = optim.named_tensors(params)
        loss = mod.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                    materialize_grads=True)
        grads, gnorm = optim.clip_by_global_norm(dict(zip(named, grads)),
                                                 tcfg["max_grad_norm"])
        lr = float(optim.cosine_schedule(step, tcfg["base_lr"], tcfg["warmup_steps"],
                                         tcfg["total_steps"]))
        opt_state = optim.adamw_update(params, grads, opt_state, lr,
                                       weight_decay=tcfg["weight_decay"])
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr}
    return step_fn


#: the reference's TrainStepConfig() defaults
optim_cfg = dict(base_lr=3e-4, warmup_steps=100, total_steps=10_000,
                 max_grad_norm=1.0, weight_decay=0.1)


def lower_cell(cfg, mesh, cell: S.Cell, compile_: bool = True,
               opts: tuple[str, ...] = ()):
    """Build + lower one cell on ``mesh``; returns (metrics, seconds).

    ``opts`` — the reference's hillclimb knobs:
      remat_dots    save matmul results in remat
      remat_outs    save the named block outputs in remat
      no_fsdp       train weights TP-sharded only, replicated over DP
      serve_repl    serving layout: same as no_fsdp for decode/prefill cells
      dp_over_model batch and activations over every axis, params fsdp_all
      chunk_attn    the chunked attention path above 2048 positions
      seq_shard     decode caches sharded on their context dim over "model"
    ``compile_=False`` builds the stand-ins and shardings only.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    mod = registry.get_module(cfg)
    if "remat_dots" in opts:
        cfg = dataclasses.replace(cfg, remat_policy="dots")
    if "remat_outs" in opts:
        cfg = dataclasses.replace(cfg, remat_policy="outs")
    train_fsdp = "no_fsdp" not in opts
    serve_fsdp = "serve_repl" not in opts
    t0 = time.time()
    with _opts_scope(opts):
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        model = S.param_shapes(cfg)
        with fake:
            if cell.kind == "train":
                layout = "fsdp_all" if "dp_over_model" in opts else "2d"
                pshard = S.param_shardings(cfg, mesh, model, fsdp=train_fsdp,
                                           layout=layout)
                params = _place_params(model, pshard, requires_grad=True)
                oshard = S.opt_shardings(cfg, mesh, pshard)
                moment = lambda n, p: fake_dtensor(p.shape, torch.float32, oshard.mu[n])
                named = dict(params.named_parameters())
                opt_state = optim.AdamState(
                    step=fake_dtensor((), torch.int32, oshard.step),
                    mu={n: moment(n, p) for n, p in named.items()},
                    nu={n: moment(n, p) for n, p in named.items()})
                tok, tok_shd = S.token_specs(cfg, mesh, cell.global_batch, cell.seq_len)
                batch = {"tokens": fake_dtensor(tok.shape, tok.dtype, tok_shd),
                         "labels": fake_dtensor(tok.shape, tok.dtype, tok_shd)}
                fe, fe_shd = S.frontend_specs(cfg, mesh, cell.global_batch)
                if fe is not None:
                    batch["prefix_embeds"] = fake_dtensor(fe.shape, fe.dtype, fe_shd)
                fn = _train_step(mod, cfg, optim_cfg)
                args = (params, opt_state, batch, 0)
            elif cell.kind == "prefill":
                pshard = S.param_shardings(cfg, mesh, model, fsdp=serve_fsdp)
                params = _place_params(model, pshard, requires_grad=False)
                tok, tok_shd = S.token_specs(cfg, mesh, cell.global_batch, cell.seq_len)
                tokens = fake_dtensor(tok.shape, tok.dtype, tok_shd)
                fe, fe_shd = S.frontend_specs(cfg, mesh, cell.global_batch)
                prefix = None if fe is None else fake_dtensor(fe.shape, fe.dtype, fe_shd)
                if cfg.family == "audio":
                    def fn(params, tokens, frames):
                        logits, _ = mod.forward(params, cfg, tokens, frames)
                        return logits[:, -1:]
                    args = (params, tokens, prefix)
                elif cfg.frontend:
                    def fn(params, tokens, prefix):
                        return mod.prefill(params, cfg, tokens, prefix)
                    args = (params, tokens, prefix)
                else:
                    def fn(params, tokens):
                        return mod.prefill(params, cfg, tokens)
                    args = (params, tokens)
            else:  # decode: one new token against a seq_len-deep cache
                pshard = S.param_shardings(cfg, mesh, model, fsdp=serve_fsdp)
                params = _place_params(model, pshard, requires_grad=False)
                B = cell.global_batch
                cshape = S.cache_shapes(cfg, B, cell.seq_len)
                cshard = S.cache_shardings(cfg, mesh, cshape, B,
                                           seq_shard=("seq_shard" in opts))
                cache = _map2(lambda t, s: fake_dtensor(t.shape, t.dtype, s),
                              cshape, cshard)
                token = fake_dtensor((B, 1), torch.int32,
                                     S.NamedSharding(mesh, (S._dp(mesh, B) or None, None)))

                def fn(params, token, cache, pos):
                    return mod.decode_step(params, cfg, token, cache, pos)
                args = (params, token, cache, cell.seq_len - 1)
        if not compile_:
            return {"lower_only": True}, time.time() - t0
        grad = torch.enable_grad() if cell.kind == "train" else torch.no_grad()
        fallback = _ReplicateFallback()
        with mesh_context(mesh), implicit_replication(), grad, fallback:
            metrics = hlo.analyze(fn, args)
        metrics["replicated_ops"] = fallback.count
    metrics["compile_s"] = time.time() - t0
    return metrics, time.time() - t0


def _map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map2(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def _scaled_full(cfg, m_full, m1, m2):
    """Per-layer extrapolation: full = L1 + (units−1)·(L2−L1) — exact for a
    homogeneous stack, where it must equal the full-depth count."""
    unit = scan_unit(cfg)
    units_full = (cfg.n_layers - cfg.moe_first_dense) / unit
    out = dict(m_full)
    for key in ("flops", "bytes_accessed", "transcendentals"):
        d = m2[key] - m1[key]
        out[key + "_scaled"] = m1[key] + (units_full - 1) * d
    a1, a2 = m1["memory"]["argument_bytes"], m2["memory"]["argument_bytes"]
    out["argument_bytes_scaled"] = a1 + (units_full - 1) * (a2 - a1)
    coll1 = m1["collectives"].get("total", 0.0)
    coll2 = m2["collectives"].get("total", 0.0)
    out["collective_bytes_scaled"] = coll1 + (units_full - 1) * (coll2 - coll1)
    out["units_full"] = units_full
    return out


def probes_only(cfg, cell: S.Cell) -> bool:
    """Whether a cell is lowered through its L1/L2 probes alone: the
    recurrent families' full-sequence passes (prefill, train), whose sLSTM
    and Mamba layers step over the sequence in Python, one DTensor dispatch
    chain per position."""
    return cfg.family in ("hybrid", "ssm") and cell.kind in ("prefill", "train")


def run_cell(arch: str, shape: str, mesh_kind: str, scale_metrics: bool = True,
             opts: tuple[str, ...] = ()):
    """One cell's record, on a production mesh over its own fake world.  A
    :func:`probes_only` cell has no full-depth figures: it records the
    ``_scaled`` extrapolations to full depth, and the two-unit probe's own
    figures under ``probe`` (``probes_only`` true)."""
    cfg = registry.get_config(arch)
    cell = S.get_cell(arch, shape)
    ok, why = registry.shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "applicable": ok,
           "opts": list(opts)}
    if not ok:
        rec["skip_reason"] = why
        return rec
    with fake_world(MESH_RANKS[mesh_kind]):
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"))
        try:
            if probes_only(cfg, cell):
                m1, _ = lower_cell(with_layers(cfg, 1), mesh, cell, opts=opts)
                m2, _ = lower_cell(with_layers(cfg, 2), mesh, cell, opts=opts)
                rec.update(_scaled_full(cfg, {}, m1, m2))
                rec["probe"] = m2
                rec["probes_only"] = True
                rec["ok"] = True
                return rec
            m_full, _ = lower_cell(cfg, mesh, cell, opts=opts)
            rec.update(m_full)
            rec["ok"] = True
            if scale_metrics and mesh_kind == "pod":
                m1, _ = lower_cell(with_layers(cfg, 1), mesh, cell, opts=opts)
                m2, _ = lower_cell(with_layers(cfg, 2), mesh, cell, opts=opts)
                rec.update(_scaled_full(cfg, m_full, m1, m2))
        except Exception as e:  # a failure here is a bug in the system
            rec["ok"] = False
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def record_path(out: str, rec: dict) -> str:
    suffix = ("__" + "_".join(rec["opts"])) if rec["opts"] else ""
    return os.path.join(out, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(S.SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--no-scale-metrics", action="store_true")
    ap.add_argument("--opts", default="",
                    help="comma-separated hillclimb options (remat_dots,remat_outs,"
                         "no_fsdp,serve_repl,dp_over_model,chunk_attn,seq_shard)")
    args = ap.parse_args()
    opts = tuple(o for o in args.opts.split(",") if o)
    rec = run_cell(registry.normalize(args.arch), args.shape, args.mesh,
                   scale_metrics=not args.no_scale_metrics, opts=opts)
    os.makedirs(args.out, exist_ok=True)
    with open(record_path(args.out, rec), "w") as f:
        json.dump(rec, f, indent=1)
    if rec.get("ok") and rec.get("probes_only"):
        print(f"OK {rec['arch']} {rec['shape']} {rec['mesh']} (L1/L2 probes) "
              f"flops={rec['flops_scaled']:.3e} "
              f"args={rec['argument_bytes_scaled']/2**30:.2f}GiB "
              f"temp=not extrapolated "
              f"compile={rec['probe']['compile_s']:.0f}s")
    elif rec.get("ok"):
        mem = rec["memory"]
        print(f"OK {rec['arch']} {rec['shape']} {rec['mesh']} "
              f"flops={rec.get('flops_scaled', rec['flops']):.3e} "
              f"args={mem['argument_bytes']/2**30:.2f}GiB "
              f"temp={mem['temp_bytes']/2**30:.2f}GiB "
              f"compile={rec['compile_s']:.0f}s")
    elif rec.get("applicable"):
        print(f"FAIL {rec['arch']} {rec['shape']} {rec['mesh']}: "
              f"{rec.get('error')}")
    else:
        print(f"SKIP {rec['arch']} {rec['shape']}: {rec.get('skip_reason')}")
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"})[:800])


if __name__ == "__main__":
    main()
