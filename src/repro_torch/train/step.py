"""Train step builder: autograd gradients + clip + AdamW, with microbatch
gradient accumulation and optional int8 error-feedback compression of the
data-parallel gradients (the port of ``repro.train.step``).

The returned function takes (params, opt_state, residuals, batch, step) and
returns (params, opt_state, residuals, metrics) as the reference's does; it
updates the parameters and the optimizer state in place.  A step whose loss
or gradient norm is not finite updates nothing and returns its metrics, so a
driver that discards such a step (:class:`repro_torch.runtime.StepDriver`)
keeps the last good state, as with the reference's pure step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import optim


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    weight_decay: float = 0.1
    microbatches: int = 1
    compress_dp_grads: bool = False


def make_train_step(loss_fn: Callable, tcfg: TrainStepConfig):
    """loss_fn(params, batch) → scalar loss; ``params`` a module (or a dict
    of tensors that require grad), ``batch`` a dict of tensors."""

    def grads_of(params, batch):
        named = optim.named_tensors(params)
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
        return loss.detach(), dict(zip(named, grads))

    def accumulate(params, batch):
        mb = tcfg.microbatches
        if mb == 1:
            return grads_of(params, batch)
        # microbatch j holds rows [j·b/mb, (j+1)·b/mb), as the reference's
        # reshape(mb, b // mb, ...); gradients summed in fp32
        g_acc = optim.residuals_init(params)            # fp32 zeros
        loss_acc = 0.0
        for j in range(mb):
            mbatch = {k: x.reshape(mb, x.shape[0] // mb, *x.shape[1:])[j]
                      for k, x in batch.items()}
            loss, g = grads_of(params, mbatch)
            loss_acc = loss_acc + loss
            for n, t in g.items():
                g_acc[n] += t.float()
        scale = 1.0 / mb
        return loss_acc * scale, {n: t * scale for n, t in g_acc.items()}

    def train_step(params, opt_state, residuals, batch, step: int):
        loss, grads = accumulate(params, batch)
        new_residuals = residuals
        if tcfg.compress_dp_grads:
            q, scales, new_residuals = optim.compress_grads_int8(grads, residuals)
            grads = optim.decompress_grads_int8(q, scales)
        grads, gnorm = optim.clip_by_global_norm(grads, tcfg.max_grad_norm)
        lr = float(optim.cosine_schedule(step, tcfg.base_lr, tcfg.warmup_steps,
                                         tcfg.total_steps))
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        # reading the two scalars waits for the backward pass
        if not bool(torch.isfinite(loss) & torch.isfinite(gnorm)):
            return params, opt_state, residuals, metrics
        opt_state = optim.adamw_update(params, grads, opt_state, lr,
                                       weight_decay=tcfg.weight_decay)
        return params, opt_state, new_residuals, metrics

    return train_step
