"""AdamW with decoupled weight decay and fp32 moments whatever the
parameter dtype (bf16-safe), as the reference's ``repro.optim.adamw``.

Written by hand: ``torch.optim.AdamW`` keeps its moments in the parameter's
dtype, bf16 for a bf16 model.  :func:`adamw_update` updates the parameters
and the moments in place, in the reference's order of operations.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn


class AdamState(NamedTuple):
    step: torch.Tensor        # int32 scalar
    mu: dict
    nu: dict


def named_tensors(params) -> dict:
    """{name: tensor} of a module's parameters; a dict of tensors as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def adamw_init(params) -> AdamState:
    named = named_tensors(params)
    device = next(iter(named.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu={n: zeros(p) for n, p in named.items()},
                     nu={n: zeros(p) for n, p in named.items()})


def clip_by_global_norm(grads: dict, max_norm: float):
    """→ (grads scaled to a global L2 norm of at most ``max_norm``, each in
    its own dtype; the norm before clipping)."""
    sq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(params, grads: dict, state: AdamState, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> AdamState:
    """One AdamW step: the parameters and moments are updated in place; the
    returned state carries the incremented step."""
    if not isinstance(lr, torch.Tensor):
        lr = float(lr)
    step = state.step + 1
    t = step.float()
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    for name, p in named_tensors(params).items():
        g = grads[name].float()
        m, v = state.mu[name], state.nu[name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return AdamState(step=step, mu=state.mu, nu=state.nu)
