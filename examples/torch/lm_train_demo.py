"""LM substrate demo on the PyTorch/CUDA port: train an assigned architecture
end-to-end with the fault-tolerant driver (checkpoint/restart + NaN
quarantine wired in).

    python examples/torch/lm_train_demo.py [arch]                 # the card
    python examples/torch/lm_train_demo.py [arch] --device cpu    # the CPU

``examples/lm_train_demo.py`` on ``repro_torch``: the reduced architecture
(default qwen3_4b), ``TokenPipeline`` batches of 8 × 32 tokens, 30 AdamW
steps (lr 3e-3, 5 warmup steps), a checkpoint every 10 steps into a
temporary directory; the last loss must be below the first.  The entry,
:func:`build_driver`, takes the ``ModelConfig`` of any family (audio with
zero frames as its source, as the reference's demo), so a full-width one
trains through the same code.  On ``--device cuda`` without
a GPU it fails.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch

from repro_torch import optim
from repro_torch.data import TokenPipeline
from repro_torch.launch import require_device
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import DriverConfig, StepDriver
from repro_torch.train import TrainStepConfig, make_train_step


WARMUP_STEPS = 5


def build_driver(cfg: ModelConfig, device="cuda", *, checkpoint_dir: str,
                 steps: int = 30, batch: int = 8, seq: int = 32,
                 base_lr: float = 3e-3, checkpoint_every: int = 10,
                 keep: int = 3, seed: int = 0, meter_hook=None) -> StepDriver:
    """A :class:`StepDriver` over fresh parameters (from ``seed``) and AdamW
    state, not yet run (``drv.run()`` trains); its state is (params,
    AdamState)."""
    require_device(device)
    mod = registry.get_module(cfg)
    params = mod.init_params(torch.Generator(device).manual_seed(seed), cfg)
    opt = optim.adamw_init(params)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    ts = make_train_step(
        lambda p, b: mod.loss_fn(p, cfg, b),
        TrainStepConfig(base_lr=base_lr, warmup_steps=WARMUP_STEPS,
                        total_steps=steps))

    def step_fn(state, batch, step):
        params, opt = state
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        if cfg.frontend:
            b["prefix_embeds"] = torch.zeros(
                (b["tokens"].shape[0], cfg.frontend_tokens, cfg.d_model),
                device=device)
        params, opt, _, m = ts(params, opt, (), b, step)
        return (params, opt), m

    return StepDriver(
        DriverConfig(total_steps=steps, checkpoint_every=checkpoint_every,
                     checkpoint_dir=checkpoint_dir, keep_checkpoints=keep),
        step_fn, lambda s: pipe.batch_slice(s, 0, 1), (params, opt),
        meter_hook=meter_hook)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="qwen3_4b")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    require_device(args.device)
    cfg = registry.get_config(args.arch).reduced()
    print(f"arch {args.arch} (reduced): {cfg.n_layers}L d={cfg.d_model} "
          f"family={cfg.family} device={args.device}")
    with tempfile.TemporaryDirectory() as d:
        drv = build_driver(cfg, args.device, checkpoint_dir=d,
                           meter_hook=lambda s, m, dt: (s % 10 == 0) and print(
                               f"  step {s:3d} loss {m['loss']:.4f}"))
        drv.run()
        hist = drv.metrics_history
        print(f"loss {hist[0]['loss']:.3f} → {hist[-1]['loss']:.3f} "
              f"({len(hist)} steps, ckpt at {drv.ckpt.latest_step()})")
        if not hist[-1]["loss"] < hist[0]["loss"]:
            raise AssertionError(f"the loss did not fall: {hist[0]} → {hist[-1]}")
    print("LM train demo OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
