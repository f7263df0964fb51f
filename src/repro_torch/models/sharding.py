"""Partition rules for params and activations — the CiFHER mapping insight
applied to the LM substrate (the port of ``repro.models.sharding``).

Mesh axes: ``("data", "model")`` within a pod, plus ``"pod"`` across pods.
Params are 2-D sharded (embed-dim → "data" = FSDP, heads/ffn/experts →
"model" = TP), replicated across "pod"; the batch shards over
("pod", "data").  This mirrors block clustering: collectives for parameter
gathering stay inside a pod (the "cluster"), only gradient all-reduce crosses
pods — the same shrink-the-collective-domain argument as paper §IV.

A **spec** is the reference's ``PartitionSpec`` as a tuple: one entry per
leading dim of the tensor, each ``None`` (replicated), an axis name, or a
tuple of axis names (the dim split over their product, the first axis
major); dims past the spec's end are replicated.  :func:`placements` turns a
spec into DTensor placements on a :class:`~torch.distributed.device_mesh.
DeviceMesh` whose ``mesh_dim_names`` are the axis names.

Rules are name-based on the reference's tree path of a parameter
(:func:`repro_torch.interop.reference_path`: ``layers.3.attn.wq`` is the
leaf ``layers/attn/wq`` stacked over the layers).  The port holds one tensor
per layer, so its spec is the reference's without the stacked leading
``None``.  GQA KV projections with few heads (glm4's kv=2) keep the
flattened (KV·hd) dim sharded — the head_dim splits instead; where a dim
does not divide its axes, DTensor shards it unevenly (rank 0 holds the
ceiling, as XLA pads it).

The active mesh (:func:`mesh_context`, :func:`active_mesh`: the reference's
``mesh_context`` and ``abstract_mesh``) is a contextvar holding the
``DeviceMesh``; the layers' activation constraints
(:func:`repro_torch.models.layers.maybe_shard`) read it and do nothing
without one.
"""
from __future__ import annotations

import contextlib
import contextvars
import re

#: a spec entry: None, an axis name, or a tuple of axis names
Spec = tuple

_active_mesh: contextvars.ContextVar = contextvars.ContextVar("lm_mesh", default=None)


@contextlib.contextmanager
def mesh_context(mesh):
    """Make ``mesh`` the active mesh of the activation constraints."""
    tok = _active_mesh.set(mesh)
    try:
        yield mesh
    finally:
        _active_mesh.reset(tok)


def active_mesh():
    """The active ``DeviceMesh``, or None."""
    return _active_mesh.get()


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every mesh
    dim that tensor dim ``d`` names, ``Replicate()`` on the others.  A dim
    split over several axes must name them in the mesh's order (DTensor
    shards the major axis first, as the reference's tuple does)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} names {axes} out of the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


# (regex on path, spec builder taking (data_axis, model_axis))
_RULES = [
    # embeddings / head
    (r"embed/table$", lambda d, m: (m, d)),
    (r"head/w$", lambda d, m: (d, m)),
    # attention
    (r"(attn|xattn)/w[qkv]$", lambda d, m: (d, m)),
    (r"(attn|xattn)/wo$", lambda d, m: (m, d)),
    # dense mlp
    (r"mlp/w[ig]$", lambda d, m: (d, m)),
    (r"mlp/wo$", lambda d, m: (m, d)),
    # moe
    (r"moe/router$", lambda d, m: (d, None)),
    (r"moe/w[ig]$", lambda d, m: (None, d, m)),     # experts repl, F → model
    (r"moe/wo$", lambda d, m: (None, m, d)),
    (r"moe/shared/w[ig]$", lambda d, m: (d, m)),
    (r"moe/shared/wo$", lambda d, m: (m, d)),
    # mamba2
    (r"mamba/in_proj$", lambda d, m: (d, m)),
    (r"mamba/conv_w$", lambda d, m: (None, m)),
    (r"mamba/out_proj$", lambda d, m: (m, d)),
    # xlstm
    (r"mlstm/up$", lambda d, m: (d, m)),
    (r"mlstm/w[qkv]$", lambda d, m: (d, m)),
    (r"mlstm/w[if]$", lambda d, m: (d, None)),
    (r"mlstm/down$", lambda d, m: (m, d)),
    (r"slstm/w[xh]$", lambda d, m: (d, m)),
    (r"slstm/ff_up$", lambda d, m: (d, m)),
    (r"slstm/ff_down$", lambda d, m: (m, d)),
]


def moe_expert_sharded_rules(n_experts: int, model_size: int):
    """True expert parallelism when E divides the model axis (deepseek 64)."""
    if n_experts % model_size == 0:
        return [
            (r"moe/w[ig]$", lambda d, m: (m, d, None)),
            (r"moe/wo$", lambda d, m: (m, None, d)),
        ]
    return []


def param_specs(params, cfg, mesh, data_axis="data", model_axis="model") -> dict:
    """{parameter name: spec} of a module (or a {name: tensor} dict): the
    reference's rule for the parameter's tree path, without the stacked
    layer axis; norms, scalars and biases replicated (``()``)."""
    from repro_torch.interop import reference_path
    from repro_torch.optim import named_tensors
    extra = moe_expert_sharded_rules(cfg.moe_experts,
                                     mesh_shape(mesh).get(model_axis, 1)) \
        if cfg.moe_experts else []
    rules = extra + _RULES

    def spec_for(name, leaf):
        path, _ = reference_path(name)
        ps = "/".join(path)
        for pat, builder in rules:
            if re.search(pat, ps):
                return builder(data_axis, model_axis)[:leaf.dim()]
        return ()

    return {n: spec_for(n, t) for n, t in named_tensors(params).items()}


def batch_axes(mesh) -> tuple:
    """Data-parallel axes for the batch dim: ("pod","data") when multi-pod."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def input_sharding(mesh, batch_shardable: bool = True) -> Spec:
    if not batch_shardable:
        return ()
    return (batch_axes(mesh),)
