"""The port's LM decoder on a card against the same decoder on the CPU.

:func:`card_vs_cpu` builds one set of weights on the CPU, copies it to the
card, and runs on both, in float32 with TF32 off: the forward logits, a
teacher-forced ``decode_step`` sequence, and train steps on the same
``TokenPipeline`` batches.  It returns the differences; the callers hold
them to their tolerances (``tests/test_torch_cuda.py`` at the reduced
config, ``chip_smoke.py`` phase ``lm`` at qwen3-4b's full widths).  This
module imports the port only inside its functions, and never JAX.
"""
from __future__ import annotations

import contextlib
import copy

import numpy as np

#: tolerances: logits (forward and decode) abs, loss and grad norm relative
LOGIT_ATOL = 1e-3
METRIC_RTOL = 1e-4


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls in full float32 on the card."""
    import torch
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def card_vs_cpu(cfg, device, *, seed: int = 0, batch: int = 2, seq: int = 16,
                decode_steps: int = 16, train_steps: int = 2,
                base_lr: float = 1e-3) -> dict:
    """Max abs differences of the forward and decode logits, relative
    differences of each train step's loss and grad norm, the parameters'
    max abs difference after the steps beside ``2·Σ lr`` (the most two
    AdamW runs can part when a gradient's sign is at the rounding level),
    and whether each is inside its tolerance (``ok``)."""
    import torch

    from repro_torch import optim
    from repro_torch.data import TokenPipeline
    from repro_torch.models import transformer as T
    from repro_torch.train import TrainStepConfig, make_train_step

    if cfg.dtype != "float32":
        raise ValueError("the card and the CPU are compared in float32")
    cpu_model = T.init_params(torch.Generator("cpu").manual_seed(seed), cfg, "cpu")
    models = {"cpu": cpu_model, "card": copy.deepcopy(cpu_model).to(device)}
    devices = {"cpu": "cpu", "card": device}
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    out = {}
    with no_tf32():
        logits, decode = {}, {}
        with torch.no_grad():
            for side, model in models.items():
                dev = devices[side]
                tok = torch.from_numpy(tokens).to(dev)
                logits[side] = T.forward(model, cfg, tok)[0].cpu()
                cache = T.init_cache(cfg, batch, seq, device=dev)
                steps = []
                for t in range(decode_steps):
                    lg, cache = T.decode_step(model, cfg, tok[:, t:t + 1], cache, t)
                    steps.append(lg.cpu())
                decode[side] = torch.cat(steps, dim=1)
        out["forward_max_abs"] = float((logits["cpu"] - logits["card"]).abs().max())
        out["decode_max_abs"] = float((decode["cpu"] - decode["card"]).abs().max())
        out["logits_finite"] = bool(torch.isfinite(logits["card"]).all()
                                    and torch.isfinite(decode["card"]).all())

        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed)
        tcfg = TrainStepConfig(base_lr=base_lr, warmup_steps=1, total_steps=train_steps)
        metrics = {side: [] for side in models}
        lr_sum = 0.0
        for side, model in models.items():
            dev = devices[side]
            step_fn = make_train_step(lambda p, b: T.loss_fn(p, cfg, b), tcfg)
            opt = optim.adamw_init(model)
            for step in range(train_steps):
                b = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch_slice(step, 0, 1).items()}
                _, opt, _, m = step_fn(model, opt, (), b, step)
                metrics[side].append({k: float(v) for k, v in m.items()})
                if side == "cpu":
                    lr_sum += metrics[side][-1]["lr"]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    out["loss"] = [(m["loss"], c["loss"]) for m, c in zip(metrics["card"], metrics["cpu"])]
    out["grad_norm"] = [(m["grad_norm"], c["grad_norm"])
                        for m, c in zip(metrics["card"], metrics["cpu"])]
    out["loss_rel"] = max(rel(a, b) for a, b in out["loss"])
    out["grad_norm_rel"] = max(rel(a, b) for a, b in out["grad_norm"])
    cpu_params = dict(models["cpu"].named_parameters())
    out["params_max_abs"] = max(
        float((p.detach().cpu() - cpu_params[n].detach()).abs().max())
        for n, p in models["card"].named_parameters())
    out["params_bound"] = 2 * lr_sum
    out["ok"] = {"forward": out["forward_max_abs"] <= LOGIT_ATOL,
                 "decode": out["decode_max_abs"] <= LOGIT_ATOL,
                 "finite": out["logits_finite"],
                 "loss": out["loss_rel"] <= METRIC_RTOL,
                 "grad_norm": out["grad_norm_rel"] <= METRIC_RTOL,
                 "params": out["params_max_abs"] <= out["params_bound"]}
    return out
