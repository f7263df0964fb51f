"""Shape stand-ins and sharding specs for every (arch × shape) cell — the
no-allocation inputs the dry-run lowers against (the port of
``repro.launch.specs``).

Stand-ins are tensors on the ``meta`` device: the port's modules built there
(:func:`param_shapes`), their caches (:func:`cache_shapes`), token and
frontend inputs.  A sharding is a :class:`NamedSharding`, a mesh and a spec
(:mod:`repro_torch.models.sharding`'s tuple form); its :attr:`~NamedSharding.
placements` are the DTensor placements.  Parameters, optimizer moments and
caches are dicts keyed as the port keys them (parameter names; the caches'
nested dicts and tuples), one sharding per tensor.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import registry, sharding as shd
from repro_torch.models.config import SHAPES, ModelConfig

DP_AXES = ("pod", "data")   # extended to include "model" by dp_over_model


def set_dp_axes(axes):
    global DP_AXES
    DP_AXES = tuple(axes)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        return shd.placements(self.mesh, self.spec)


def _dp(mesh, size: int):
    """Data-parallel axes that evenly divide ``size`` (batch dim)."""
    shape = shd.mesh_shape(mesh)
    keep = []
    prod = 1
    for a in (a for a in DP_AXES if a in shape):
        if size % (prod * shape[a]) == 0:
            keep.append(a)
            prod *= shape[a]
    return tuple(keep)


def _div(n: int, mesh, axis: str) -> bool:
    shape = shd.mesh_shape(mesh)
    return axis in shape and n % shape[axis] == 0


def token_specs(cfg: ModelConfig, mesh, batch: int, seq: int):
    spec = (_dp(mesh, batch) or None, None)
    return (torch.empty((batch, seq), dtype=torch.int32, device="meta"),
            NamedSharding(mesh, spec))


def frontend_specs(cfg: ModelConfig, mesh, batch: int):
    if not cfg.frontend:
        return None, None
    shape = (batch, cfg.frontend_tokens, cfg.d_model)
    spec = (_dp(mesh, batch) or None, None, None)
    return (torch.empty(shape, dtype=torch.float32, device="meta"),
            NamedSharding(mesh, spec))


def param_shapes(cfg: ModelConfig):
    """The port's model of ``cfg`` on the meta device (no storage)."""
    from repro_torch.models import encdec, transformer
    cls = encdec.EncDec if cfg.family == "audio" else transformer.Transformer
    return cls(cfg, "meta")


def param_shardings(cfg: ModelConfig, mesh, params_shape=None,
                    fsdp: bool = True, layout: str = "2d") -> dict:
    """{parameter name: NamedSharding}.  Parameter layouts:
      2d          — FSDP("data") × TP("model"), the baseline;
      replicated  — fsdp=False: TP only, DP-replicated (serving layout);
      fsdp_all    — pure FSDP: the largest dim of every sharded param that
                    divides the device count shards over ALL axes, no tensor
                    parallelism (for models whose layers fit one chip).
    A stacked leaf's largest dim is searched among its per-layer dims, as
    the reference's own search never picks the layer axis (the widths are
    larger)."""
    params_shape = params_shape if params_shape is not None else param_shapes(cfg)
    specs = shd.param_specs(params_shape, cfg, mesh)
    shape = shd.mesh_shape(mesh)
    all_axes = tuple(a for a in ("pod", "data", "model") if a in shape)
    total = 1
    for a in all_axes:
        total *= shape[a]

    def strip_data(spec):
        if fsdp:
            return spec
        cleaned = []
        for ax in spec:
            if ax == "data":
                cleaned.append(None)
            elif isinstance(ax, tuple):
                t = tuple(a for a in ax if a != "data")
                cleaned.append(t or None)
            else:
                cleaned.append(ax)
        return tuple(cleaned)

    def fsdp_all(spec, leaf):
        if not any(ax is not None for ax in spec):
            return ()
        dims = list(leaf.shape)
        # shard the largest dim divisible by the full device count
        for i in sorted(range(len(dims)), key=lambda i: -dims[i]):
            if dims[i] % total == 0:
                out = [None] * len(dims)
                out[i] = all_axes if len(all_axes) > 1 else all_axes[0]
                return tuple(out)
        return strip_data(spec)      # fallback: indivisible → TP-ish

    from repro_torch.optim import named_tensors
    leaves = named_tensors(params_shape)
    if layout == "fsdp_all":
        return {n: NamedSharding(mesh, fsdp_all(s, leaves[n])) for n, s in specs.items()}
    return {n: NamedSharding(mesh, strip_data(s)) for n, s in specs.items()}


def opt_shardings(cfg: ModelConfig, mesh, param_shd: dict):
    """AdamState: step replicated; mu/nu follow the params."""
    from repro_torch.optim import AdamState
    return AdamState(step=NamedSharding(mesh, ()), mu=dict(param_shd),
                     nu=dict(param_shd))


def cache_shapes(cfg: ModelConfig, batch: int, seq_len: int):
    """The decode caches of ``cfg`` on the meta device."""
    mod = registry.get_module(cfg)
    if cfg.family == "audio":
        return mod.init_cache(cfg, batch, seq_len, "meta", enc_len=cfg.frontend_tokens)
    return mod.init_cache(cfg, batch, seq_len, "meta")


def map_tree(fn, tree):
    """``fn`` over every tensor of a tree of dicts and tuples (a cache)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def cache_shardings(cfg: ModelConfig, mesh, cache_shape, batch: int,
                    seq_shard: bool = False):
    """KV caches: batch→dp when divisible, else time→"data"; head_dim→model.
    Recurrent states: batch→dp, widest feature dim→model.

    ``seq_shard=True`` (serving layout): the cache's LARGEST dim — the
    context length for attention caches — shards over "model" instead of
    head_dim: attention against the cache becomes a local partial softmax +
    tiny stat all-reduces (flash-decoding style) instead of gathering the
    expanded KV.  The port's caches are stacked on a leading layer axis as
    the reference's are, so the batch dim is found on the same leaf."""
    dp = _dp(mesh, batch)
    shape = shd.mesh_shape(mesh)

    def spec_for(leaf):
        dims = list(leaf.shape)
        nd = len(dims)
        if nd >= 4:                       # (L?, B, T, KV, hd) or (L?,B,H,dk,dv)
            s = [None] * nd
            # find the batch dim: the first dim equal to `batch`
            bdim = dims.index(batch) if batch in dims else None
            if bdim is not None and dp:
                s[bdim] = dp
            elif batch == 1 and "data" in shape:
                # long-context single request: shard time/feature over data
                big = max(range(nd), key=lambda i: dims[i])
                if dims[big] % shape["data"] == 0:
                    s[big] = "data"
            placed = False
            if seq_shard:
                big = max(range(nd), key=lambda i: dims[i])
                if s[big] is None and _div(dims[big], mesh, "model"):
                    s[big] = "model"
                    placed = True
            if not placed:
                if _div(dims[-1], mesh, "model") and s[-1] is None:
                    s[-1] = "model"
                elif _div(dims[-2], mesh, "model") and s[-2] is None:
                    s[-2] = "model"
            return NamedSharding(mesh, tuple(s))
        if nd >= 1 and dp and dims[0] == batch:
            return NamedSharding(mesh, (dp,))
        # 1-D slot_pos arrays etc.: shard over model when the largest dim
        if seq_shard and nd >= 1 and _div(dims[-1], mesh, "model"):
            return NamedSharding(mesh, (*([None] * (nd - 1)), "model"))
        return NamedSharding(mesh, ())

    return map_tree(spec_for, cache_shape)


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str
    seq_len: int
    global_batch: int

    @property
    def name(self) -> str:
        return f"{self.arch}__{self.shape}"


def get_cell(arch: str, shape: str) -> Cell:
    s = SHAPES[shape]
    return Cell(arch=arch, shape=shape, kind=s["kind"],
                seq_len=s["seq_len"], global_batch=s["global_batch"])
