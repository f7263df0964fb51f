"""xLSTM blocks: mLSTM (matrix memory, parallel via chunked GLA with the
augmented-normalizer trick) and sLSTM (scalar memory, sequential loop),
interleaved 7:1 as in the xLSTM-1.3B configuration: the port of
``repro.models.xlstm``.

mLSTM recurrence (per head):     C_t = f_t·C_{t−1} + i_t·k_t⊗v_t
                                 n_t = f_t·n_{t−1} + i_t·k_t
                                 h_t = (qᵀC_t) / max(|qᵀn_t|, 1)
The normalizer n runs as an extra value column inside the same GLA call.
Input gates i_t = exp(ĩ_t) are folded into k (clipped at 8).  The gate
weights ``wi``, ``wf``, the forget bias and the sLSTM bias are float32 in
every dtype.  GELU is the tanh approximation (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .gla import gla_chunked, gla_decode_step
from .layers import RMSNorm, _weight, rmsnorm

MLSTM_PROJ = 2.0    # up-projection factor (paper)
SLSTM_PROJ = 4.0 / 3.0
IGATE_CLAMP = 8.0


def _gelu(x):
    return F.gelu(x, approximate="tanh")


# ----------------------------------------------------------------------------
# mLSTM
# ----------------------------------------------------------------------------

class MLSTM(nn.Module):
    INIT_SCALE = {"wi": 0.02, "wf": 0.02}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        Dm = int(MLSTM_PROJ * D)
        f32 = torch.float32
        self.up = _weight((D, 2 * Dm), cfg, device)            # x-branch, z-gate
        self.wq = _weight((Dm, Dm), cfg, device)
        self.wk = _weight((Dm, Dm), cfg, device)
        self.wv = _weight((Dm, Dm), cfg, device)
        self.wi = _weight((Dm, H), cfg, device, dtype=f32)
        self.wf = _weight((Dm, H), cfg, device, dtype=f32)
        self.fbias = _weight((H,), cfg, device, dtype=f32)
        self.norm = RMSNorm(Dm, device)
        self.down = _weight((Dm, D), cfg, device)

    @torch.no_grad()
    def init_fixed(self):
        """The forget bias starts at 3 (open forget gates)."""
        self.fbias.fill_(3.0)


def _mlstm_qkv(p: MLSTM, cfg: ModelConfig, xm):
    B, S, Dm = xm.shape
    H = cfg.n_heads
    hd = Dm // H
    q = (xm @ p.wq).reshape(B, S, H, hd) / math.sqrt(hd)
    k = (xm @ p.wk).reshape(B, S, H, hd)
    v = (xm @ p.wv).reshape(B, S, H, hd)
    xf = xm.float()
    la = F.logsigmoid(xf @ p.wf + p.fbias)                    # (B,S,H) ≤ 0
    ig = torch.clamp(xf @ p.wi, -1e30, IGATE_CLAMP)
    k = k * torch.exp(ig)[..., None].to(k.dtype)             # fold input gate
    return q, k, v, la


def _mlstm_out(p: MLSTM, cfg: ModelConfig, y_aug, z, shape):
    y, norm = y_aug[..., :-1], y_aug[..., -1:]
    h = y / torch.clamp(torch.abs(norm), min=1.0).to(y.dtype)
    h = rmsnorm(p.norm, h.reshape(shape), cfg.norm_eps) * F.silu(z)
    return h @ p.down


def _augmented(v):
    """v with a column of ones: the normalizer's extra value column."""
    return torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)], -1)


def mlstm_block(p: MLSTM, cfg: ModelConfig, x, chunk: int = 256):
    B, S, D = x.shape
    up = x @ p.up
    Dm = up.shape[-1] // 2
    xm, z = up[..., :Dm], up[..., Dm:]
    q, k, v, la = _mlstm_qkv(p, cfg, xm)
    y_aug, _ = gla_chunked(q, k, _augmented(v), la, chunk=min(chunk, S))
    return _mlstm_out(p, cfg, y_aug, z, (B, S, Dm)).to(x.dtype)


def mlstm_cache_init(cfg: ModelConfig, batch: int, device, layers: int) -> dict:
    """``layers`` stacked mLSTM states ``state`` (L, B, H, hd, hd + 1),
    float32 zeros."""
    Dm = int(MLSTM_PROJ * cfg.d_model)
    H = cfg.n_heads
    hd = Dm // H
    return {"state": torch.zeros((layers, batch, H, hd, hd + 1), dtype=torch.float32,
                                 device=device)}


def mlstm_decode_step(p: MLSTM, cfg: ModelConfig, x, cache: dict):
    """x: (B, 1, D); cache: one layer's {state}, updated in place."""
    B = x.shape[0]
    up = x @ p.up
    Dm = up.shape[-1] // 2
    xm, z = up[..., :Dm], up[..., Dm:]
    q, k, v, la = _mlstm_qkv(p, cfg, xm)
    y_aug, _ = gla_decode_step(cache["state"], q[:, 0], k[:, 0], _augmented(v)[:, 0],
                               la[:, 0])
    return _mlstm_out(p, cfg, y_aug, z, (B, 1, Dm)).to(x.dtype)


# ----------------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------------

def _round128(n: int) -> int:
    return max(128, (n // 128) * 128)


class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D = cfg.d_model
        Dff = _round128(int(SLSTM_PROJ * D))     # TP-width divisible (4/3·D rounded)
        # i, f, z, o gates from input and recurrent h
        self.wx = _weight((D, 4 * D), cfg, device)
        self.wh = _weight((D, 4 * D), cfg, device)
        self.bias = _weight((4 * D,), cfg, device, dtype=torch.float32)
        self.norm = RMSNorm(D, device)
        self.ff_up = _weight((D, Dff), cfg, device)
        self.ff_down = _weight((Dff, D), cfg, device)

    @torch.no_grad()
    def init_fixed(self):
        """The gate bias: 0 for i, 3 for f, 0 for z and o."""
        D = self.bias.shape[0] // 4
        self.bias.zero_()
        self.bias[D:2 * D] = 3.0


def _slstm_cell(p: SLSTM, xt, state):
    """xt: (B, D); state: (h, c, n, m) each (B, D) float32; stabilised
    exponential gating."""
    h, c, n, m = state
    g = (xt @ p.wx).float() + (h.to(xt.dtype) @ p.wh).float() + p.bias
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    logf = F.logsigmoid(gf)
    m_new = torch.maximum(logf + m, gi)                  # stabiliser
    i = torch.exp(gi - m_new)
    f = torch.exp(logf + m - m_new)
    c = f * c + i * torch.tanh(gz)
    n = f * n + i
    h_new = torch.sigmoid(go) * c / torch.clamp(n, min=1.0)
    return h_new, c, n, m_new


def _slstm_ff(p: SLSTM, cfg: ModelConfig, h):
    h = rmsnorm(p.norm, h, cfg.norm_eps)
    return _gelu(h @ p.ff_up) @ p.ff_down


def slstm_block(p: SLSTM, cfg: ModelConfig, x):
    B, S, D = x.shape
    state = tuple(torch.zeros((B, D), dtype=torch.float32, device=x.device)
                  for _ in range(4))
    hs = []
    for t in range(S):
        state = _slstm_cell(p, x[:, t], state)
        hs.append(state[0])
    h = torch.stack(hs, dim=1).to(x.dtype)
    return _slstm_ff(p, cfg, h).to(x.dtype)


def slstm_cache_init(cfg: ModelConfig, batch: int, device, layers: int) -> dict:
    """``layers`` stacked sLSTM states: ``state`` = (h, c, n, m), each
    (L, B, D) float32 zeros."""
    return {"state": tuple(torch.zeros((layers, batch, cfg.d_model), dtype=torch.float32,
                                       device=device) for _ in range(4))}


def slstm_decode_step(p: SLSTM, cfg: ModelConfig, x, cache: dict):
    """x: (B, 1, D); cache: one layer's {state}, updated in place."""
    new = _slstm_cell(p, x[:, 0], cache["state"])
    for old, t in zip(cache["state"], new):
        old.copy_(t)
    return _slstm_ff(p, cfg, new[0][:, None].to(x.dtype)).to(x.dtype)
