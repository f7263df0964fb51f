"""Decoder-only LM for the dense / moe / vlm / hybrid / ssm families: the
port of ``repro.models.transformer``.

:class:`Transformer` holds the parameters under the reference's names
(``embed.table``, ``layers.<i>.…``, ``final_norm.scale``, ``head.w``, and
``first_layers.<j>.…`` / ``shared_attn.…`` where the family has them);
where the reference stacks the layers on a leading axis for ``lax.scan``,
the port keeps one block per layer and loops over them (``cfg.unroll`` is
accepted and changes nothing), and the reference's ``lax.cond`` on the
layer index is a Python branch:

* moe (deepseek, mixtral): attention + :mod:`moe` blocks; deepseek's first
  ``moe_first_dense`` layers are dense, FFN width d_ff·(top_k + shared),
  run before the stack.  ``forward`` returns the summed load-balance aux.
* hybrid (zamba2): every layer is a Mamba2 block; after every
  ``attn_every``-th layer the **weight-shared** attention+MLP block runs
  (its parameters held once, outside the layer list).
* ssm (xlstm): an mLSTM block, an sLSTM block every ``slstm_every`` layers;
  every layer holds both.
* vlm (llava): precomputed patch embeddings (anyres frontend stub) are
  prepended to the token embeddings.

Serving uses per-layer caches stacked on a leading layer axis: attention KV
(linear or sliding-window ring buffer; moe keeps one stack for the dense
first layers and the rest), Mamba2 (conv window + SSD state) with the
shared block's KV, mLSTM/sLSTM recurrent states.  ``decode_step`` writes
the caches in place and returns them.  The audio family is
:mod:`repro_torch.models.encdec`.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

from . import layers as L
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xl
from .config import ModelConfig

#: the families this module runs
FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm")


def _check_family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a decoder-only "
                         f"family ({', '.join(FAMILIES)}); audio is models.encdec")


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------

class Block(nn.Module):
    """One pre-norm attention + SwiGLU layer (ln1, attn, ln2, mlp): the
    dense/vlm layer, deepseek's dense first layers (``d_ff`` given) and
    zamba2's shared block."""

    def __init__(self, cfg: ModelConfig, device=None, d_ff: int | None = None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.RMSNorm(cfg.d_model, device)
        self.mlp = L.MLP(cfg, d_ff=d_ff, device=device)


class MoEBlock(nn.Module):
    """ln1, attn, ln2, moe."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.RMSNorm(cfg.d_model, device)
        self.moe = moe_mod.MoE(cfg, device)


class HybridBlock(nn.Module):
    """ln1, mamba."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        self.mamba = ssm_mod.Mamba(cfg, device)


class XLSTMBlock(nn.Module):
    """ln1, mlstm, ln1s, slstm."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        self.mlstm = xl.MLSTM(cfg, device)
        self.ln1s = L.RMSNorm(cfg.d_model, device)
        self.slstm = xl.SLSTM(cfg, device)


_BLOCKS = {"dense": Block, "vlm": Block, "moe": MoEBlock, "hybrid": HybridBlock,
           "ssm": XLSTMBlock}


class Transformer(nn.Module):
    """The parameters of a decoder-only model on ``device``, uninitialised
    (see :func:`init_params`)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        _check_family(cfg)
        block = _BLOCKS[cfg.family]
        self.embed = L.Embedding(cfg, device)
        self.layers = nn.ModuleList(block(cfg, device)
                                    for _ in range(cfg.n_layers - cfg.moe_first_dense))
        self.final_norm = L.RMSNorm(cfg.d_model, device)
        self.head = L.Head(cfg, device)
        if cfg.moe_first_dense:
            dense_ff = cfg.d_ff * (cfg.moe_top_k + cfg.moe_shared_experts)
            self.first_layers = nn.ModuleList(Block(cfg, device, d_ff=dense_ff)
                                              for _ in range(cfg.moe_first_dense))
        if cfg.family == "hybrid":
            self.shared_attn = Block(cfg, device)


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None) -> Transformer:
    """A :class:`Transformer` on ``device`` (default: the generator's) with
    the reference's initialiser law (:func:`layers.init_weights`), drawn
    from ``generator``."""
    model = Transformer(cfg, device if device is not None else generator.device)
    L.init_weights(model, generator)
    return model


# ----------------------------------------------------------------------------
# forward (training / full-sequence)
# ----------------------------------------------------------------------------

def _attn_mlp_block(lp, cfg: ModelConfig, x, positions):
    """Pre-norm attention + (mlp|moe) block.  Returns (x, aux)."""
    h = L.attention(lp.attn, cfg, L.rmsnorm(lp.ln1, x, cfg.norm_eps), positions)
    h = L.checkpoint_name(h, cfg, "attn_out")
    x = x + h
    y = L.rmsnorm(lp.ln2, x, cfg.norm_eps)
    if isinstance(lp, MoEBlock):
        out, aux = moe_mod.moe(lp.moe, cfg, y)
    else:
        out, aux = L.mlp(lp.mlp, y), torch.zeros((), dtype=torch.float32, device=x.device)
    out = L.checkpoint_name(out, cfg, "mlp_out")
    return x + out, aux


def _is_slstm(cfg: ModelConfig, idx: int) -> bool:
    return bool(cfg.slstm_every) and (idx + 1) % cfg.slstm_every == 0


def _runs_shared(cfg: ModelConfig, idx: int) -> bool:
    return bool(cfg.attn_every) and (idx + 1) % cfg.attn_every == 0


def _superblock(cfg: ModelConfig, shared, lp, x, positions, idx: int):
    """One layer of the stack, the unit of activation checkpointing.
    Returns (x, aux).  Under an active mesh the residual stream enters it
    d_model-sharded over the TP axis (sequence-parallel style), as the
    reference's scanned layer body."""
    x = L.maybe_shard(x, ("pod", "data"), None, "model")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in ("dense", "vlm", "moe"):
        x, aux = _attn_mlp_block(lp, cfg, x, positions)
    elif cfg.family == "hybrid":
        x = x + ssm_mod.mamba_block(lp.mamba, cfg, L.rmsnorm(lp.ln1, x, cfg.norm_eps))
        if _runs_shared(cfg, idx):
            x, _ = _attn_mlp_block(shared, cfg, x, positions)
    elif _is_slstm(cfg, idx):
        x = x + xl.slstm_block(lp.slstm, cfg, L.rmsnorm(lp.ln1s, x, cfg.norm_eps))
    else:
        x = x + xl.mlstm_block(lp.mlstm, cfg, L.rmsnorm(lp.ln1, x, cfg.norm_eps))
    return x, aux


def _embed_tokens(params, cfg: ModelConfig, tokens):
    x = L.embed(params.embed, tokens) * math.sqrt(cfg.d_model)
    return x.to(L._dtype(cfg))


def forward(params: Transformer, cfg: ModelConfig, tokens, prefix_embeds=None):
    """tokens: (B, S) int; prefix_embeds: (B, P, D) frontend stub (vlm).
    Returns logits (B, P + S, padded vocab) and the aux loss (float32)."""
    _check_family(cfg)
    x = _embed_tokens(params, cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    for flp in getattr(params, "first_layers", ()):    # deepseek's dense head layers
        x, _ = _attn_mlp_block(flp, cfg, x, positions)
    fn = L.remat_wrap(functools.partial(_superblock, cfg,
                                        getattr(params, "shared_attn", None)), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params.layers):
        x, a = fn(lp, x, positions, i)
        aux = aux + a
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return L.lm_head(params.head, x), aux


def loss_fn(params: Transformer, cfg: ModelConfig, batch) -> torch.Tensor:
    """batch: {tokens (B,S), labels (B,S), [prefix_embeds]}."""
    logits, aux = forward(params, cfg, batch["tokens"], batch.get("prefix_embeds"))
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:      # vlm prefix positions
        logits = logits[:, -labels.shape[1]:]
    return L.cross_entropy(logits, labels, cfg.vocab) + 0.01 * aux


# ----------------------------------------------------------------------------
# serving: caches, prefill, decode
# ----------------------------------------------------------------------------

def _cache_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def kv_cache_init(cfg: ModelConfig, layers: int, batch: int, T: int, device) -> dict:
    """``layers`` stacked KV caches on ``device``: ``k``, ``v``
    (L, B, T, KV, hd) and ``slot_pos`` (L, T), the position held in each
    slot (−1 = empty)."""
    shape = (layers, batch, T, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=L._dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=L._dtype(cfg), device=device),
            "slot_pos": torch.full((layers, T), -1, dtype=torch.int32, device=device)}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    """Per-layer caches on ``device``, stacked on a leading layer axis:
    dense/vlm/moe the KV cache of every layer (:func:`kv_cache_init`);
    hybrid ``{"mamba": {conv, ssd}, "attn": KV of the n_layers // attn_every
    shared-block runs}``; ssm ``{"mlstm": {state}, "slstm": {state}}``."""
    _check_family(cfg)
    if cfg.family in ("dense", "vlm", "moe"):
        return kv_cache_init(cfg, cfg.n_layers, batch, _cache_len(cfg, seq_len), device)
    if cfg.family == "hybrid":
        cache = {"mamba": ssm_mod.mamba_cache_init(cfg, batch, device, cfg.n_layers)}
        if cfg.attn_every:
            cache["attn"] = kv_cache_init(cfg, cfg.n_layers // cfg.attn_every, batch,
                                          _cache_len(cfg, seq_len), device)
        return cache
    return {"mlstm": xl.mlstm_cache_init(cfg, batch, device, cfg.n_layers),
            "slstm": xl.slstm_cache_init(cfg, batch, device, cfg.n_layers)}


def _layer(cache, i: int):
    """Layer ``i``'s views of a stacked cache (dicts and tuples kept)."""
    if isinstance(cache, dict):
        return {k: _layer(v, i) for k, v in cache.items()}
    if isinstance(cache, tuple):
        return tuple(_layer(v, i) for v in cache)
    return cache[i]


def _write_kv(cache_layer: dict, k, v, pos: int, window: int) -> dict:
    """Write one token's (B,1,KV,hd) k/v at position ``pos``, in place."""
    T = cache_layer["k"].shape[1]
    idx = pos % T if window else min(pos, T - 1)
    cache_layer["k"][:, idx] = k[:, 0]
    cache_layer["v"][:, idx] = v[:, 0]
    cache_layer["slot_pos"][idx].fill_(pos)     # a kernel, no host-to-device copy
    return cache_layer


def _attn_decode_block(lp, cfg: ModelConfig, x, cl: dict, pos: int):
    """One token through a pre-norm attention + (mlp|moe) block against its
    KV cache ``cl``, written in place."""
    h = L.rmsnorm(lp.ln1, x, cfg.norm_eps)
    y, k, v = L.attention_decode(lp.attn, cfg, h, cl["k"], cl["v"], cl["slot_pos"], pos)
    _write_kv(cl, k, v, pos, cfg.sliding_window)
    x = x + y
    h2 = L.rmsnorm(lp.ln2, x, cfg.norm_eps)
    if isinstance(lp, MoEBlock):
        return x + moe_mod.moe(lp.moe, cfg, h2)[0]
    return x + L.mlp(lp.mlp, h2)


def decode_step(params: Transformer, cfg: ModelConfig, token, cache: dict, pos: int):
    """token: (B, 1) int; pos: the position of this token.  Returns (logits,
    cache), the cache updated in place."""
    _check_family(cfg)
    pos = int(pos)
    x = _embed_tokens(params, cfg, token)
    if cfg.family in ("dense", "vlm", "moe"):
        stack = [*getattr(params, "first_layers", ()), *params.layers]
        for i, lp in enumerate(stack):
            x = _attn_decode_block(lp, cfg, x, _layer(cache, i), pos)
    elif cfg.family == "hybrid":
        aidx = 0
        for i, lp in enumerate(params.layers):
            h = L.rmsnorm(lp.ln1, x, cfg.norm_eps)
            x = x + ssm_mod.mamba_decode_step(lp.mamba, cfg, h, _layer(cache["mamba"], i))
            if _runs_shared(cfg, i):
                x = _attn_decode_block(params.shared_attn, cfg, x,
                                       _layer(cache["attn"], aidx), pos)
                aidx += 1
    else:
        # the reference advances both recurrent states of every layer and
        # keeps the output of the layer's own block
        for i, lp in enumerate(params.layers):
            ym = xl.mlstm_decode_step(lp.mlstm, cfg, L.rmsnorm(lp.ln1, x, cfg.norm_eps),
                                      _layer(cache["mlstm"], i))
            ys = xl.slstm_decode_step(lp.slstm, cfg, L.rmsnorm(lp.ln1s, x, cfg.norm_eps),
                                      _layer(cache["slstm"], i))
            x = x + (ys if _is_slstm(cfg, i) else ym)
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return L.lm_head(params.head, x), cache


def prefill(params: Transformer, cfg: ModelConfig, tokens, prefix_embeds=None):
    """Full-sequence prefill; returns the last position's logits (the cache
    fill is modelled by the same forward graph, as in the reference)."""
    logits, _ = forward(params, cfg, tokens, prefix_embeds)
    return logits[:, -1:]
