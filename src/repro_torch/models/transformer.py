"""Decoder-only LM for the dense and vlm families: the port of
``repro.models.transformer``.

:class:`Transformer` holds the parameters under the reference's names
(``embed.table``, ``layers.<i>.{ln1,attn,ln2,mlp}``, ``final_norm.scale``,
``head.w``); where the reference stacks the layers on a leading axis for
``lax.scan``, the port keeps one :class:`Block` per layer and loops over
them (``cfg.unroll`` is accepted and changes nothing).  vlm (llava): the
precomputed patch embeddings (anyres frontend stub) are prepended to the
token embeddings.

Serving uses per-layer KV caches stacked on a leading layer axis, linear or
a sliding-window ring buffer.  ``decode_step`` writes the new entries into
the cache in place and returns it.

The moe, hybrid, ssm and audio families are not ported (ROADMAP A.13b):
building or running one raises ``NotImplementedError``.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

from . import layers as L
from .config import ModelConfig

#: the families this module runs
FAMILIES = ("dense", "vlm")


def check_family(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"(ROADMAP A.13b); the port runs {', '.join(FAMILIES)}")


# ----------------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------------

class Block(nn.Module):
    """One pre-norm attention + SwiGLU layer (the reference's dense/vlm
    ``_layer_init``: ln1, attn, ln2, mlp)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.RMSNorm(cfg.d_model, device)
        self.mlp = L.MLP(cfg, device=device)


class Transformer(nn.Module):
    """The parameters of a dense or vlm decoder on ``device``, uninitialised
    (see :func:`init_params`)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        check_family(cfg)
        self.embed = L.Embedding(cfg, device)
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, device)
        self.head = L.Head(cfg, device)


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None) -> Transformer:
    """A :class:`Transformer` on ``device`` (default: the generator's) with
    the reference's initialiser law: norm scales 1, the embedding table
    N(0, 1), every other weight N(0, 1/fan_in), drawn from ``generator``."""
    model = Transformer(cfg, device if device is not None else generator.device)
    for name, w in model.named_parameters():
        if not name.endswith(".scale"):
            L.init_(w, generator, scale=1.0 if name == "embed.table" else None)
    return model


# ----------------------------------------------------------------------------
# forward (training / full-sequence)
# ----------------------------------------------------------------------------

def _superblock(cfg: ModelConfig, lp: Block, x, positions):
    """One pre-norm attention + MLP layer, the unit of activation
    checkpointing."""
    h = L.attention(lp.attn, cfg, L.rmsnorm(lp.ln1, x, cfg.norm_eps), positions)
    x = x + h
    out = L.mlp(lp.mlp, L.rmsnorm(lp.ln2, x, cfg.norm_eps))
    return x + out


def _embed_tokens(params: Transformer, cfg: ModelConfig, tokens):
    x = L.embed(params.embed, tokens) * math.sqrt(cfg.d_model)
    return x.to(L._dtype(cfg))


def forward(params: Transformer, cfg: ModelConfig, tokens, prefix_embeds=None):
    """tokens: (B, S) int; prefix_embeds: (B, P, D) frontend stub (vlm).
    Returns logits (B, P + S, padded vocab) and the aux loss (0 here)."""
    check_family(cfg)
    x = _embed_tokens(params, cfg, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    fn = L.remat_wrap(functools.partial(_superblock, cfg), cfg)
    for lp in params.layers:
        x = fn(lp, x, positions)
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    logits = L.lm_head(params.head, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


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


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    """Per-layer KV caches on ``device``, stacked on a leading layer axis:
    ``k``, ``v`` (L, B, T, KV, hd) and ``slot_pos`` (L, T), the position
    held in each slot (−1 = empty)."""
    check_family(cfg)
    T = _cache_len(cfg, seq_len)
    shape = (cfg.n_layers, batch, T, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=L._dtype(cfg), device=device),
        "v": torch.zeros(shape, dtype=L._dtype(cfg), device=device),
        "slot_pos": torch.full((cfg.n_layers, T), -1, dtype=torch.int32, device=device),
    }


def _write_kv(cache_layer: dict, k, v, pos: int, window: int) -> dict:
    """Write one token's (B,1,KV,hd) k/v at position ``pos``, in place."""
    T = cache_layer["k"].shape[1]
    idx = pos % T if window else min(pos, T - 1)
    cache_layer["k"][:, idx] = k[:, 0]
    cache_layer["v"][:, idx] = v[:, 0]
    cache_layer["slot_pos"][idx].fill_(pos)     # a kernel, no host-to-device copy
    return cache_layer


def decode_step(params: Transformer, cfg: ModelConfig, token, cache: dict, pos: int):
    """token: (B, 1) int; pos: the position of this token.  Returns (logits,
    cache), the cache updated in place."""
    check_family(cfg)
    pos = int(pos)
    x = _embed_tokens(params, cfg, token)
    for i, lp in enumerate(params.layers):
        cl = {name: t[i] for name, t in cache.items()}
        h = L.rmsnorm(lp.ln1, x, cfg.norm_eps)
        y, k, v = L.attention_decode(lp.attn, cfg, h, cl["k"], cl["v"],
                                     cl["slot_pos"], pos)
        _write_kv(cl, k, v, pos, cfg.sliding_window)
        x = x + y
        x = x + L.mlp(lp.mlp, L.rmsnorm(lp.ln2, x, cfg.norm_eps))
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return L.lm_head(params.head, x), cache


def prefill(params: Transformer, cfg: ModelConfig, tokens, prefix_embeds=None):
    """Full-sequence prefill; returns the last position's logits (the cache
    fill is modelled by the same forward graph, as in the reference)."""
    logits, _ = forward(params, cfg, tokens, prefix_embeds)
    return logits[:, -1:]
