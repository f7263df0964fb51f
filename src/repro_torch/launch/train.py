"""Training launcher: end-to-end driver wiring data → train step → runtime
(the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \\
        --steps 50 --batch 8 --seq 64 [--ckpt-dir DIR] [--device cpu]

As in the reference, ``--reduced`` is on by default and cannot be turned
off, so the launcher trains the reduced config; a full-width model is
trained through ``examples/torch/lm_train_demo.py``'s entry.  The driver
provides checkpoint/restart, NaN quarantine, straggler logging, and
preemption-safe shutdown (see :mod:`repro_torch.runtime.driver`).
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

from repro_torch import optim
from repro_torch.data import TokenPipeline
from repro_torch.launch import require_device
from repro_torch.models import registry
from repro_torch.runtime import DriverConfig, StepDriver
from repro_torch.train import TrainStepConfig, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model and its state live (no CPU fallback)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    require_device(args.device)

    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mod = registry.get_module(cfg)
    params = mod.init_params(torch.Generator(args.device).manual_seed(args.seed), cfg)
    opt_state = optim.adamw_init(params)
    residuals = optim.residuals_init(params) if args.compress_grads else ()

    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)
    tcfg = TrainStepConfig(base_lr=args.lr, warmup_steps=10,
                           total_steps=args.steps,
                           microbatches=args.microbatches,
                           compress_dp_grads=args.compress_grads)

    def loss_fn(p, batch):
        b = dict(batch)
        if cfg.frontend:
            B = b["tokens"].shape[0]
            b["prefix_embeds"] = torch.zeros(
                (B, cfg.frontend_tokens, cfg.d_model), device=args.device)
        return mod.loss_fn(p, cfg, b)

    ts = make_train_step(loss_fn, tcfg)

    def step_fn(state, batch, step):
        params, opt_state, residuals = state
        params, opt_state, residuals, metrics = ts(
            params, opt_state, residuals,
            {k: torch.from_numpy(v).to(args.device) for k, v in batch.items()},
            step)
        return (params, opt_state, residuals), metrics

    def data_fn(step):
        return pipe.batch_slice(step, 0, 1)

    driver = StepDriver(
        DriverConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                     checkpoint_dir=args.ckpt_dir),
        step_fn, data_fn, (params, opt_state, residuals),
        meter_hook=lambda s, m, dt: print(
            f"step {s:5d} loss {m['loss']:.4f} gnorm {m['grad_norm']:.3f} "
            f"{dt*1e3:.0f}ms"))
    driver.install_signal_handler()
    end = driver.run()
    print(f"finished at step {end}; "
          f"final loss {driver.metrics_history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
