"""Error-feedback int8 gradient compression (the port of
``repro.optim.compress``).

int8 quantization with a per-tensor scale cuts an all-reduce's bytes 4× from
fp32, and the residual carried to the next step (error feedback) keeps
convergence.  The quantize/dequantize pair wraps the data-parallel
reduction; the residual state lives beside the optimizer state.

A "tensor" is a leaf of the reference's parameter tree, where each weight is
stacked over the layers: ``layers.0.attn.wq`` … ``layers.<L-1>.attn.wq``
share one scale (see :func:`stacked_name`).
"""
from __future__ import annotations

import torch


def stacked_name(name: str) -> str:
    """The reference's tree leaf that a parameter belongs to:
    ``layers.<i>.<rest>`` → ``layers.<rest>``; any other name is its own."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] == "layers" and parts[1].isdigit():
        return ".".join(["layers", *parts[2:]])
    return name


def compress_grads_int8(grads: dict, residuals: dict):
    """→ (int8 dict, scales dict, new residual dict); every tensor of a
    stacked leaf carries that leaf's scale."""
    gf = {n: g.float() + residuals[n] for n, g in grads.items()}
    groups: dict[str, list[str]] = {}
    for n in gf:
        groups.setdefault(stacked_name(n), []).append(n)
    q, scales, new_r = {}, {}, {}
    for names in groups.values():
        peak = torch.stack([torch.max(torch.abs(gf[n])) for n in names]).max()
        scale = torch.clamp(peak, min=1e-12) / 127.0
        for n in names:
            q[n] = torch.clamp(torch.round(gf[n] / scale), -127, 127).to(torch.int8)
            scales[n] = scale
            new_r[n] = gf[n] - q[n].float() * scale
    return q, scales, new_r


def decompress_grads_int8(q: dict, scales: dict) -> dict:
    return {n: q[n].float() * scales[n] for n in q}


def residuals_init(params) -> dict:
    from .adamw import named_tensors
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in named_tensors(params).items()}
