"""Mamba2 block (SSD) on the shared chunked-GLA core (the zamba2 backbone):
the port of ``repro.models.ssm``.

Projections follow the Mamba2 layout: one input projection produces
(z | x | B | C | dt); the SSD recurrence runs per head with scalar decay
A·Δt; a depthwise causal conv precedes the SSM; gated RMSNorm + out-proj
close the block.  ``A_log``, ``dt_bias`` and ``D_skip`` are float32 in every
dtype, and the softplus is taken in float32.  The D-skip term is float32,
so the gated output reaches ``out_proj`` in float32; it is cast to the
weight's dtype for the product (the reference multiplies it by the bf16
weight at default precision).  Decode keeps (conv window,
SSD state) in float32 as the cache: constant memory per step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .gla import gla_chunked, gla_decode_step
from .layers import RMSNorm, _weight, rmsnorm

CONV_K = 4


class Mamba(nn.Module):
    #: the reference's initialiser scales where they are not 1/√fan_in
    INIT_SCALE = {"conv_w": 0.5}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, Din, H, Nst = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state
        proj_out = 2 * Din + 2 * Nst + H              # z, x, B, C, dt (one B/C group)
        f32 = torch.float32
        self.in_proj = _weight((D, proj_out), cfg, device)
        self.conv_w = _weight((CONV_K, Din + 2 * Nst), cfg, device)
        self.A_log = _weight((H,), cfg, device, dtype=f32)
        self.dt_bias = _weight((H,), cfg, device, dtype=f32)
        self.D_skip = _weight((H,), cfg, device, dtype=f32)
        self.norm = RMSNorm(Din, device)
        self.out_proj = _weight((Din, D), cfg, device)

    @torch.no_grad()
    def init_fixed(self):
        """The leaves the reference sets to constants: A_log = log(1 … H),
        dt_bias = 0, D_skip = 1."""
        H = self.A_log.shape[0]
        self.A_log.copy_(torch.log(torch.linspace(1.0, float(H), H, dtype=torch.float32)))
        self.dt_bias.zero_()
        self.D_skip.fill_(1.0)


def _split(cfg: ModelConfig, proj):
    Din, Nst = cfg.d_inner, cfg.ssm_state
    z = proj[..., :Din]
    x = proj[..., Din:2 * Din]
    Bm = proj[..., 2 * Din:2 * Din + Nst]
    Cm = proj[..., 2 * Din + Nst:2 * Din + 2 * Nst]
    dt = proj[..., 2 * Din + 2 * Nst:]
    return z, x, Bm, Cm, dt


def _causal_conv(xbc, w, state=None):
    """Depthwise causal conv over (B, S, C); state: (B, K−1, C) for decode.
    Returns (silu(conv), the last K−1 inputs)."""
    K = w.shape[0]
    if state is None:
        pad = F.pad(xbc, (0, 0, K - 1, 0))
    else:
        pad = torch.cat([state.to(xbc.dtype), xbc], dim=1)
    S = xbc.shape[1]
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu(out), pad[:, -(K - 1):, :]


def _ssd_inputs(p: Mamba, cfg: ModelConfig, xbc, dtr):
    Din, Nst = cfg.d_inner, cfg.ssm_state
    x, Bm, Cm = xbc[..., :Din], xbc[..., Din:Din + Nst], xbc[..., Din + Nst:]
    dt = F.softplus(dtr.float() + p.dt_bias)                      # (..., H) f32
    A = -torch.exp(p.A_log)                                       # (H,) < 0
    return x, Bm, Cm, dt, A


def mamba_block(p: Mamba, cfg: ModelConfig, u, chunk: int = 256):
    """u: (B, S, D) → (B, S, D)."""
    B, S, D = u.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    proj = u @ p.in_proj
    z, x, Bm, Cm, dtr = _split(cfg, proj)
    xbc, _ = _causal_conv(torch.cat([x, Bm, Cm], dim=-1), p.conv_w)
    x, Bm, Cm, dt, A = _ssd_inputs(p, cfg, xbc, dtr)
    xh = x.reshape(B, S, H, P)
    q = Cm[:, :, None, :].expand(B, S, H, Cm.shape[-1])           # (B,S,H,N)
    k = Bm[:, :, None, :].expand(B, S, H, Bm.shape[-1])
    v = xh * dt[..., None].to(xh.dtype)
    y, _ = gla_chunked(q, k, v, dt * A, chunk=min(chunk, S))
    y = y + xh * p.D_skip[None, None, :, None]
    y = y.reshape(B, S, cfg.d_inner)
    y = rmsnorm(p.norm, y * F.silu(z), cfg.norm_eps)
    return (y.to(p.out_proj.dtype) @ p.out_proj).to(u.dtype)


# ----------------------------------------------------------------------------
# Decode (constant-memory state)
# ----------------------------------------------------------------------------

def mamba_cache_init(cfg: ModelConfig, batch: int, device, layers: int) -> dict:
    """``layers`` stacked decode caches on ``device``: the conv window
    ``conv`` (L, B, K−1, d_inner + 2N) and the SSD state ``ssd``
    (L, B, H, N, P), both float32 zeros."""
    H, P, Nst = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    f32 = torch.float32
    return {"conv": torch.zeros((layers, batch, CONV_K - 1, cfg.d_inner + 2 * Nst),
                                dtype=f32, device=device),
            "ssd": torch.zeros((layers, batch, H, Nst, P), dtype=f32, device=device)}


def mamba_decode_step(p: Mamba, cfg: ModelConfig, u, cache: dict):
    """u: (B, 1, D); cache: one layer's {conv, ssd}, updated in place.
    Returns y (B, 1, D)."""
    B = u.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    proj = u @ p.in_proj
    z, x, Bm, Cm, dtr = _split(cfg, proj)
    xbc, conv_state = _causal_conv(torch.cat([x, Bm, Cm], dim=-1), p.conv_w,
                                   cache["conv"])
    cache["conv"].copy_(conv_state)
    x, Bm, Cm, dt, A = _ssd_inputs(p, cfg, xbc, dtr)
    dt = dt[:, 0]                                                 # (B,H)
    xh = x.reshape(B, H, P)
    q = Cm[:, 0, None, :].expand(B, H, Cm.shape[-1])
    k = Bm[:, 0, None, :].expand(B, H, Bm.shape[-1])
    v = xh * dt[..., None].to(xh.dtype)
    y, _ = gla_decode_step(cache["ssd"], q, k, v, dt * A)
    y = y + xh * p.D_skip[None, :, None]
    y = y.reshape(B, 1, cfg.d_inner)
    y = rmsnorm(p.norm, y * F.silu(z), cfg.norm_eps)
    return (y.to(p.out_proj.dtype) @ p.out_proj).to(u.dtype)
