"""Shared transformer layers: norms, RoPE, GQA attention (qk-norm, sliding
window, chunked online-softmax long-context path), SwiGLU MLP, embeddings.

The port of ``repro.models.layers``.  Parameters live in small ``nn.Module``
containers (:class:`RMSNorm`, :class:`Attention`, :class:`MLP`,
:class:`Embedding`, :class:`Head`) whose attribute names are the reference's
dict keys, and every function takes (module, config, inputs) where the
reference takes (params dict, config, inputs).  The dtype rules are the
reference's: weights and activations in bf16 when ``cfg.dtype ==
"bfloat16"`` (each leaf the reference keeps in fp32 is fp32 here too: a
container passes ``dtype`` to :func:`_weight`), norm scales and the norm
itself in fp32, attention logits cast
to fp32 before the softmax, masked logits set to -1e30.  Attention is plain
tensor algebra (``einsum`` and ``softmax``), as the reference's is plain
``jnp``.

The reference's activation constraints (:func:`maybe_shard`,
:func:`_shard_heads`, the embedding's, the MLP's and the head's, the
residual stream's in ``transformer``) act only under an active mesh
(:func:`repro_torch.models.sharding.mesh_context`), on DTensor activations:
the dry-run's lowering (:mod:`repro_torch.launch.dryrun`).  Without one, or
on a plain tensor, they return their argument untouched.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from . import sharding as shd
from .config import ModelConfig

#: the masked-logit value of the reference
MASK_VALUE = -1e30


# ----------------------------------------------------------------------------
# Activation constraints
# ----------------------------------------------------------------------------

# logical→physical axis translation for activation constraints.  The default
# is 2-D FSDP+TP; launch/dryrun.py's `dp_over_model` layout remaps dp to all
# axes and drops the TP axis (pure-FSDP training for models whose layer
# width doesn't need tensor parallelism).
_LOGICAL = {"dp": ("pod", "data"), "tp": "model"}


def set_logical_axes(dp=("pod", "data"), tp="model"):
    _LOGICAL["dp"] = tuple(dp)
    _LOGICAL["tp"] = tp


def maybe_shard(x, *spec):
    """``x`` redistributed to ``spec`` (:mod:`.sharding`'s form, ``("pod",
    "data")`` and ``"model"`` read through :func:`set_logical_axes`, axes the
    mesh lacks dropped) when a mesh is active and ``x`` is a DTensor on it;
    ``x`` untouched otherwise."""
    mesh = shd.active_mesh()
    if mesh is None or getattr(x, "device_mesh", None) is not mesh:
        return x
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} for a tensor of rank {x.dim()}")
    names = set(mesh.mesh_dim_names)
    cleaned = []
    for s in spec:
        if s == ("pod", "data"):
            s = _LOGICAL["dp"]
        elif s == "model":
            s = _LOGICAL["tp"]
        if isinstance(s, tuple):
            s = tuple(a for a in s if a in names) or None
        elif s is not None and s not in names:
            s = None
        cleaned.append(s)
    want = shd.placements(mesh, tuple(cleaned))
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _weight(shape, cfg: ModelConfig, device, dtype=None) -> nn.Parameter:
    """An uninitialised weight in ``dtype``, by default the model's."""
    return nn.Parameter(torch.empty(shape, dtype=dtype or _dtype(cfg), device=device))


def init_(w: torch.Tensor, generator: torch.Generator, scale: float | None = None):
    """Fill ``w`` in place with N(0, scale²), ``scale`` = 1/√fan_in
    (fan_in = ``w.shape[0]``) unless given: the reference's ``_init`` law,
    drawn in fp32 from ``generator`` on ``w``'s device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(w.shape[0])
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=generator, dtype=torch.float32,
                            device=w.device) * scale)


def init_weights(model: nn.Module, generator: torch.Generator):
    """The reference's initialiser law over every leaf of ``model``: norm
    scales 1, the embedding table N(0, 1), the scales a container names in
    its ``INIT_SCALE``, N(0, 1/fan_in) for every other weight, and then the
    constants a container sets in its ``init_fixed``."""
    for mod in model.modules():
        if isinstance(mod, RMSNorm):
            with torch.no_grad():
                mod.scale.fill_(1.0)
            continue
        scales = getattr(mod, "INIT_SCALE", {})
        for name, w in mod.named_parameters(recurse=False):
            init_(w, generator, scale=1.0 if isinstance(mod, Embedding)
                  else scales.get(name))
        if hasattr(mod, "init_fixed"):
            mod.init_fixed()


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=torch.float32, device=device))


def rmsnorm(p: RMSNorm, x, eps: float):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p.scale).to(x.dtype)


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freqs                 # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# GQA attention
# ----------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = _weight((D, H * hd), cfg, device)
        self.wk = _weight((D, KV * hd), cfg, device)
        self.wv = _weight((D, KV * hd), cfg, device)
        self.wo = _weight((H * hd, D), cfg, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, device)
            self.k_norm = RMSNorm(hd, device)


def _qkv(p: Attention, cfg: ModelConfig, x, positions):
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p.wq).reshape(B, S, H, hd)
    k = (x @ p.wk).reshape(B, S, KV, hd)
    v = (x @ p.wv).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm(p.k_norm, k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k, H: int):
    """GQA: replicate each KV head to its H/KV query heads (``jnp.repeat``'s
    order: query head h reads KV head h // (H/KV))."""
    KV = k.shape[2]
    if KV == H:
        return k
    return torch.repeat_interleave(k, H // KV, dim=2)


def _shard_heads(x):
    """(B, S, H, hd): batch over dp axes, heads over the model axis."""
    return maybe_shard(x, ("pod", "data"), None, "model", None)


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q: (B,S,H,hd), k/v: (B,T,KV,hd) → (B,S,H,hd); mask (S,T) or None."""
    B, S, H, hd = q.shape
    k = _shard_heads(_expand_kv(k, H))
    v = _shard_heads(_expand_kv(v, H))
    q = _shard_heads(q)
    logits = torch.einsum("bshd,bthd->bhst", q, k).float()
    logits = logits / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask[None, None], logits, MASK_VALUE)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", w, v)


def _sdpa_chunked(q, k, v, cfg: ModelConfig, q_offset: int,
                  chunk: int = 1024, causal: bool = True):
    """Flash-style online-softmax attention over key chunks: the (S, chunk)
    score tile is the only quadratic temporary.  Sliding windows are folded
    into the mask."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    q = _shard_heads(q)
    k = _shard_heads(_expand_kv(k, H))
    v = _shard_heads(_expand_kv(v, H))
    nchunks = -(-T // chunk)
    pad = nchunks * chunk - T
    kc = F.pad(k, (0, 0, 0, 0, 0, pad)).reshape(B, nchunks, chunk, H, hd)
    vc = F.pad(v, (0, 0, 0, 0, 0, pad)).reshape(B, nchunks, chunk, H, hd)
    qpos = q_offset + torch.arange(S, device=q.device)

    m = torch.full((B, H, S), MASK_VALUE, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, hd), dtype=torch.float32, device=q.device)
    for c in range(nchunks):
        kb, vb = kc[:, c], vc[:, c]
        kpos = c * chunk + torch.arange(chunk, device=q.device)
        logits = torch.einsum("bshd,bthd->bhst", q, kb).float() / math.sqrt(hd)
        valid = kpos[None, :] < T
        if causal:
            valid = valid & (kpos[None, :] <= qpos[:, None])
        if cfg.sliding_window:
            valid = valid & (kpos[None, :] > qpos[:, None] - cfg.sliding_window)
        logits = torch.where(valid[None, None], logits, MASK_VALUE)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(logits - m_new[..., None])
        l = l * alpha + pexp.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhst,bthd->bhsd", pexp.to(vb.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.movedim(2, 1).to(q.dtype)                  # (B,S,H,hd)


CHUNKED_THRESHOLD = 8192    # sequences longer than this take the chunked path


def set_chunked_threshold(n: int):
    global CHUNKED_THRESHOLD
    CHUNKED_THRESHOLD = n


def attention(p: Attention, cfg: ModelConfig, x, positions, causal: bool = True):
    """Full self-attention over x (training / encoder)."""
    B, S, D = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    if S > CHUNKED_THRESHOLD:
        out = _sdpa_chunked(q, k, v, cfg, q_offset=0, causal=causal)
    else:
        i = torch.arange(S, device=x.device)
        mask = None
        if causal:
            mask = i[:, None] >= i[None, :]
            if cfg.sliding_window:
                mask &= i[:, None] - i[None, :] < cfg.sliding_window
        out = _sdpa(q, k, v, mask, cfg)
    return out.reshape(B, S, -1) @ p.wo


def attention_decode(p: Attention, cfg: ModelConfig, x, cache_k, cache_v,
                     kpos, pos: int):
    """One-token decode against a (B, T, KV, hd) cache; returns (y, k, v).

    ``kpos``: (T,) the absolute position stored in each cache slot (−1 =
    empty), for both the linear cache and the sliding-window ring buffer.
    ``pos``: the current position.  The returned (k, v) are the roped new
    entries for the caller to write.
    """
    B, S, D = x.shape                                   # S == 1
    positions = torch.full((B, S), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    valid = (kpos >= 0) & (kpos <= pos)
    if cfg.sliding_window:
        valid &= kpos > pos - cfg.sliding_window
    H = cfg.n_heads
    # the current token's k/v are not in the cache yet: append them so the
    # token attends to itself (cache slots carry strictly older positions)
    ck = torch.cat([_expand_kv(cache_k.to(q.dtype), H),
                    _expand_kv(k.to(q.dtype), H)], dim=1)
    cv = torch.cat([_expand_kv(cache_v.to(q.dtype), H),
                    _expand_kv(v.to(q.dtype), H)], dim=1)
    valid = torch.cat([valid & (kpos != pos),
                       torch.ones(1, dtype=torch.bool, device=x.device)])
    logits = torch.einsum("bshd,bthd->bhst", q, ck).float()
    logits = logits / math.sqrt(cfg.hd)
    logits = torch.where(valid[None, None, None, :], logits, MASK_VALUE)
    w = torch.softmax(logits, dim=-1).to(cv.dtype)
    out = torch.einsum("bhst,bthd->bshd", w, cv).reshape(B, 1, -1)
    return out @ p.wo, k, v


# ----------------------------------------------------------------------------
# MLP (SwiGLU)
# ----------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, d_ff: int | None = None, device=None):
        super().__init__()
        D, Fw = cfg.d_model, d_ff or cfg.d_ff
        self.wi = _weight((D, Fw), cfg, device)
        self.wg = _weight((D, Fw), cfg, device)
        self.wo = _weight((Fw, D), cfg, device)


def mlp(p: MLP, x):
    h = F.silu(x @ p.wg) * (x @ p.wi)
    h = maybe_shard(h, ("pod", "data"), None, "model")   # F over TP axis
    return h @ p.wo


# ----------------------------------------------------------------------------
# Embedding / head
# ----------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.table = _weight((cfg.padded_vocab, cfg.d_model), cfg, device)


def embed(p: Embedding, tokens):
    return maybe_shard(F.embedding(tokens.long(), p.table), ("pod", "data"), None, None)


class Head(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.w = _weight((cfg.d_model, cfg.padded_vocab), cfg, device)


def lm_head(p: Head, x):
    # vocab stays model-sharded through the loss (batch over pod/data)
    return maybe_shard(x @ p.w, ("pod", "data"), None, "model")


# ----------------------------------------------------------------------------
# Activation checkpointing
# ----------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _named(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` under a checkpoint name: an op the ``"outs"`` policy can see."""
    return x.clone()


@_named.register_fake
def _(x, name):
    return torch.empty_like(x)


_named.register_autograd(lambda ctx, grad: (grad, None))


def checkpoint_name(x, cfg: ModelConfig, name: str):
    """``x`` itself, or, while gradients are recorded in a model checkpointed
    with policy ``"outs"``, a copy of it that the policy saves (the
    reference's ``jax.ad_checkpoint.checkpoint_name``; the port names
    ``attn_out`` and ``mlp_out`` only, the two values ``"outs"`` keeps)."""
    if cfg.remat and cfg.remat_policy == "outs" and torch.is_grad_enabled():
        return torch.ops.repro_torch.checkpoint_name(x, name)
    return x


#: the ops whose outputs each policy saves (``"full"``: none)
_SAVED = {"full": (), "dots": ("aten.mm.default", "aten.addmm.default"),
          "outs": ("repro_torch.checkpoint_name.default",)}


def remat_wrap(fn, cfg: ModelConfig):
    """Activation checkpointing of one layer while gradients are recorded,
    with the reference's policies: ``"full"`` saves nothing inside the layer
    and the backward pass recomputes it; ``"dots"`` saves the outputs of the
    matrix products with no batch dimension (``aten.mm`` and ``aten.addmm``,
    as ``dots_with_no_batch_dims_saveable``); ``"outs"`` saves the values
    named by :func:`checkpoint_name`."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy not in _SAVED:
        raise ValueError(f"unknown remat policy {cfg.remat_policy!r}")
    saved = _SAVED[cfg.remat_policy]

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if str(op) in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    context_fn = (functools.partial(create_selective_checkpoint_contexts, policy)
                  if saved else noop_context_fn)

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)
    return wrapped


def cross_entropy(logits, labels, vocab: int):
    """Mean CE over tokens; labels < 0 are masked.

    Gather-free as the reference's: the gold logit is a masked sum over the
    vocab axis.
    """
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = logits - m
    logz = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0]
    iota = torch.arange(logits.shape[-1], device=logits.device)
    onehot = iota == torch.clamp(labels, min=0)[..., None]
    gold = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    losses = logz - gold
    mask = (labels >= 0).float()
    return (losses * mask).sum() / torch.clamp(mask.sum(), min=1.0)
