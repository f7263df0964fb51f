"""Encoder-decoder backbone for seamless-m4t-medium (audio family): the port
of ``repro.models.encdec``.

The speech frontend is a stub: the caller provides precomputed frame
embeddings (B, T_frames, D).  The encoder is non-causal self-attention; the
text decoder is a pre-norm transformer with cross-attention, which
rope-rotates q at the decoder's positions and k at the encoder's, with no
mask.  Decode caches the self-attention KV and the (static) encoder
cross-KV.

:class:`EncDec` holds the parameters under the reference's names
(``embed.table``, ``enc_layers.<i>.…``, ``enc_norm.scale``,
``dec_layers.<i>.{ln1,attn,lnx,xattn,ln2,mlp}``, ``final_norm.scale``,
``head.w``), one block per layer, looped over.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from . import layers as L
from .config import ModelConfig
from .transformer import Block, _embed_tokens, _layer, _write_kv, kv_cache_init


class DecBlock(nn.Module):
    """ln1, attn, lnx, xattn, ln2, mlp."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        self.attn = L.Attention(cfg, device)
        self.lnx = L.RMSNorm(cfg.d_model, device)
        self.xattn = L.Attention(cfg, device)
        self.ln2 = L.RMSNorm(cfg.d_model, device)
        self.mlp = L.MLP(cfg, device=device)


class EncDec(nn.Module):
    """The parameters of an encoder-decoder on ``device``, uninitialised
    (see :func:`init_params`)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.family != "audio":
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not audio")
        self.embed = L.Embedding(cfg, device)
        self.enc_layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.enc_layers))
        self.enc_norm = L.RMSNorm(cfg.d_model, device)
        self.dec_layers = nn.ModuleList(DecBlock(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, device)
        self.head = L.Head(cfg, device)


def init_params(generator: torch.Generator, cfg: ModelConfig, device=None) -> EncDec:
    """An :class:`EncDec` on ``device`` (default: the generator's) with the
    reference's initialiser law, drawn from ``generator``."""
    model = EncDec(cfg, device if device is not None else generator.device)
    L.init_weights(model, generator)
    return model


def _positions(B: int, S: int, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _enc_block(cfg: ModelConfig, lp: Block, x, positions):
    h = L.attention(lp.attn, cfg, L.rmsnorm(lp.ln1, x, cfg.norm_eps), positions,
                    causal=False)
    x = x + h
    return x + L.mlp(lp.mlp, L.rmsnorm(lp.ln2, x, cfg.norm_eps))


def encode(params: EncDec, cfg: ModelConfig, frames):
    """frames: (B, T, D) frontend-stub embeddings → encoder states."""
    B, T, D = frames.shape
    x = frames.to(L._dtype(cfg))
    positions = _positions(B, T, x.device)
    fn = L.remat_wrap(functools.partial(_enc_block, cfg), cfg)
    for lp in params.enc_layers:
        x = fn(lp, x, positions)
    return L.rmsnorm(params.enc_norm, x, cfg.norm_eps)


def _cross_attend(lp: L.Attention, cfg: ModelConfig, x, enc_kv, positions):
    """Cross-attention against precomputed encoder K/V."""
    B, S, D = x.shape
    q = (x @ lp.wq).reshape(B, S, cfg.n_heads, cfg.hd)
    q = L.rope(q, positions, cfg.rope_theta)
    k, v = enc_kv
    out = L._sdpa(q, k, v, None, cfg)
    return out.reshape(B, S, -1) @ lp.wo


def _enc_kv(lp: L.Attention, cfg: ModelConfig, enc_out):
    """The cross-attention's (k, v) of the encoder states, k roped at the
    encoder's positions."""
    B, T, D = enc_out.shape
    k = (enc_out @ lp.wk).reshape(B, T, cfg.n_kv_heads, cfg.hd)
    v = (enc_out @ lp.wv).reshape(B, T, cfg.n_kv_heads, cfg.hd)
    return L.rope(k, _positions(B, T, enc_out.device), cfg.rope_theta), v


def _dec_block(cfg: ModelConfig, lp: DecBlock, x, enc_out, positions):
    h = L.attention(lp.attn, cfg, L.rmsnorm(lp.ln1, x, cfg.norm_eps), positions,
                    causal=True)
    x = x + h
    kx = _enc_kv(lp.xattn, cfg, enc_out)
    x = x + _cross_attend(lp.xattn, cfg, L.rmsnorm(lp.lnx, x, cfg.norm_eps), kx, positions)
    return x + L.mlp(lp.mlp, L.rmsnorm(lp.ln2, x, cfg.norm_eps))


def forward(params: EncDec, cfg: ModelConfig, tokens, frames):
    """Teacher-forced decode over target tokens given source frames.
    Returns logits (B, S, padded vocab) and the aux loss (0)."""
    enc_out = encode(params, cfg, frames)
    B, S = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    positions = _positions(B, S, x.device)
    fn = L.remat_wrap(functools.partial(_dec_block, cfg), cfg)
    for lp in params.dec_layers:
        x = fn(lp, x, enc_out, positions)
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return L.lm_head(params.head, x), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: EncDec, cfg: ModelConfig, batch) -> torch.Tensor:
    """batch: {tokens (B,S), labels (B,S), prefix_embeds (B,T,D) frames}."""
    logits, _ = forward(params, cfg, batch["tokens"], batch["prefix_embeds"])
    return L.cross_entropy(logits, batch["labels"], cfg.vocab)


# ----------------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device,
               enc_len: int | None = None) -> dict:
    """The decoder's caches on ``device``, stacked on a leading layer axis:
    self-attention ``k``, ``v`` (L, B, T, KV, hd) and ``slot_pos`` (L, T);
    cross-attention ``xk``, ``xv`` (L, B, T_enc, KV, hd), T_enc = ``enc_len``
    or the config's frame count."""
    Te = enc_len or cfg.frontend_tokens
    cache = kv_cache_init(cfg, cfg.n_layers, batch, seq_len, device)
    shape = (cfg.n_layers, batch, Te, cfg.n_kv_heads, cfg.hd)
    cache["xk"] = torch.zeros(shape, dtype=L._dtype(cfg), device=device)
    cache["xv"] = torch.zeros(shape, dtype=L._dtype(cfg), device=device)
    return cache


def start_decode(params: EncDec, cfg: ModelConfig, frames, cache: dict) -> dict:
    """Encode the source and fill every layer's cross-KV cache, in place."""
    enc_out = encode(params, cfg, frames)
    for i, lp in enumerate(params.dec_layers):
        k, v = _enc_kv(lp.xattn, cfg, enc_out)
        cache["xk"][i] = k
        cache["xv"][i] = v
    return cache


def decode_step(params: EncDec, cfg: ModelConfig, token, cache: dict, pos: int):
    """token: (B, 1) int; pos: the position of this token (written at
    min(pos, T−1), as ``dynamic_update_slice`` clamps).  Returns (logits,
    cache), the cache updated in place."""
    pos = int(pos)
    B = token.shape[0]
    x = _embed_tokens(params, cfg, token)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(params.dec_layers):
        cl = _layer(cache, i)
        h = L.rmsnorm(lp.ln1, x, cfg.norm_eps)
        y, k, v = L.attention_decode(lp.attn, cfg, h, cl["k"], cl["v"], cl["slot_pos"], pos)
        _write_kv(cl, k, v, pos, window=0)
        x = x + y
        hx = L.rmsnorm(lp.lnx, x, cfg.norm_eps)
        x = x + _cross_attend(lp.xattn, cfg, hx, (cl["xk"], cl["xv"]), positions)
        x = x + L.mlp(lp.mlp, L.rmsnorm(lp.ln2, x, cfg.norm_eps))
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    return L.lm_head(params.head, x), cache
