"""Mixture-of-Experts layer (mixtral 8×top-2; deepseek-moe fine-grained
64×top-6 + 2 shared experts): the port of ``repro.models.moe``.

GShard-style *grouped* capacity dispatch: tokens are split into groups of
``MOE_GROUP`` and each group dispatches independently with capacity
max(⌊cf·S_g·K/E⌋, 1); a (token, k) pair past its expert's capacity is
dropped.  Dispatch and combine are the reference's one-hot products, so
every expert runs on its ``cap`` slots whether they are filled or not (a
decode step reads every expert's weights).  The router is float32 in every
dtype; ties in the top-k go to the lower expert index, as ``lax.top_k``'s.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import MLP, _weight, mlp

MOE_GROUP = 512          # tokens per dispatch group


class MoE(nn.Module):
    """``router`` (D, E) float32, ``wi``/``wg`` (E, D, F), ``wo`` (E, F, D)
    and, with shared experts, ``shared`` (an :class:`MLP` of width
    F·shared)."""

    #: the reference's initialiser scales where they are not 1/√fan_in
    INIT_SCALE = {"router": 0.02}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        E, D, Fw = cfg.moe_experts, cfg.d_model, cfg.d_ff
        self.router = _weight((D, E), cfg, device, dtype=torch.float32)
        self.wi = _weight((E, D, Fw), cfg, device)
        self.wg = _weight((E, D, Fw), cfg, device)
        self.wo = _weight((E, Fw, D), cfg, device)
        if cfg.moe_shared_experts:
            self.shared = MLP(cfg, d_ff=cfg.d_ff * cfg.moe_shared_experts, device=device)


def top_k(probs, K: int):
    """(values, indices) of the K largest along the last axis, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :K], idx[..., :K]


def moe(p: MoE, cfg: ModelConfig, x):
    """x: (B, S, D) → ((B, S, D), aux_loss)."""
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    Sg = min(MOE_GROUP, T)
    G = T // Sg
    xt = x.reshape(G, Sg, D)

    logits = xt.float() @ p.router                              # (G, Sg, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = top_k(probs, K)                            # (G, Sg, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    cap = max(int(cfg.capacity_factor * Sg * K / E), 1)
    onehot = F.one_hot(idx, E).float()                          # (G, Sg, K, E)
    # queue position of each (token, k) inside its expert, per group, in the
    # (token, k) order flattened as Sg·K
    pos = torch.cumsum(onehot.reshape(G, Sg * K, E), dim=1).reshape(G, Sg, K, E) - 1.0
    pos = torch.sum(pos * onehot, dim=-1)                       # (G, Sg, K)
    keep = pos < cap
    gate_vals = gate_vals * keep.to(gate_vals.dtype)
    pos = torch.where(keep, pos, 0).long()

    dt = xt.dtype
    cap_onehot = F.one_hot(pos, cap).to(dt)                     # (G, Sg, K, cap)
    sel = onehot.to(dt) * keep[..., None].to(dt)                # (G, Sg, K, E)
    disp = torch.einsum("gske,gskc->gsec", sel, cap_onehot)
    expert_in = torch.einsum("gsd,gsec->gecd", xt, disp)        # (G, E, cap, D)

    h = F.silu(torch.einsum("gecd,edf->gecf", expert_in, p.wg)) * \
        torch.einsum("gecd,edf->gecf", expert_in, p.wi)
    expert_out = torch.einsum("gecf,efd->gecd", h, p.wo)        # (G, E, cap, D)

    combine = torch.einsum("gske,gskc,gsk->gsec", sel, cap_onehot, gate_vals.to(dt))
    out = torch.einsum("gecd,gsec->gsd", expert_out, combine)

    out = out.reshape(B, S, D)
    if hasattr(p, "shared"):
        out = out + mlp(p.shared, x)
    # Switch-style load-balance auxiliary: E·Σ_e f_e·P_e, f_e from each
    # token's top-1 expert
    me = probs.mean(dim=(0, 1))
    ce = onehot[..., 0, :].mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)
    return out, aux
