"""Fault-tolerant step driver (the port of ``repro.runtime.driver``).

Responsibilities:
  * periodic (async) and final (blocking) checkpointing, resume-from-latest
    on start;
  * **NaN/Inf quarantine**: a step with non-finite metrics is discarded,
    its data window skipped, and training continues from the last good state;
  * **straggler watchdog**: per-step wall-time EMA; steps slower than
    ``straggler_factor``× the EMA are logged and counted;
  * **preemption save**: SIGTERM flips a flag; the loop checkpoints and
    exits cleanly at the next step boundary;
  * **elastic restart**: data is stateless (step-indexed) and checkpoints
    hold whole arrays, so a relaunch resumes identically.

A step's time ends when its metrics have been read to the host: the read
waits for the device, so step times are the card's.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import os
import signal
import tempfile
import time
from typing import Callable

from repro_torch.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class DriverConfig:
    total_steps: int
    checkpoint_every: int = 100
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0
    ema_alpha: float = 0.1
    max_bad_steps: int = 10


class StepDriver:
    def __init__(self, cfg: DriverConfig, step_fn: Callable, data_fn: Callable,
                 state, meter_hook: Callable | None = None):
        """step_fn(state, batch, step) → (state, metrics);
        data_fn(step) → batch; ``state`` is any tree of tensors and modules
        (params + optimizer state + ...) that :class:`CheckpointManager`
        saves."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.state = state
        self.meter_hook = meter_hook
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep_checkpoints)
        self.preempted = False
        self.bad_steps = 0
        self.straggler_events: list[int] = []
        self.metrics_history: list[dict] = []
        self._ema = None

    def install_signal_handler(self):
        def on_term(signum, frame):
            log.warning("preemption signal received — saving at next boundary")
            self.preempted = True
        signal.signal(signal.SIGTERM, on_term)

    # -- helpers -----------------------------------------------------------
    def _watch_stragglers(self, step: int, dt: float):
        if self._ema is None:
            self._ema = dt
            return
        if dt > self.cfg.straggler_factor * self._ema and step > 3:
            self.straggler_events.append(step)
            log.warning("straggler: step %d took %.3fs (EMA %.3fs) — "
                        "flagging for rebalancing", step, dt, self._ema)
        self._ema = (1 - self.cfg.ema_alpha) * self._ema + self.cfg.ema_alpha * dt

    # -- main loop -----------------------------------------------------------
    def run(self, start_step: int | None = None) -> int:
        step = start_step
        if step is None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                self.state, step = self.ckpt.restore(self.state)
                log.info("resumed from checkpoint step %d", step)
                step += 1
            else:
                step = 0
        history = []
        while step < self.cfg.total_steps and not self.preempted:
            batch = self.data_fn(step)
            t0 = time.monotonic()
            new_state, metrics = self.step_fn(self.state, batch, step)
            host = {k: float(v) for k, v in metrics.items()}   # waits for the device
            dt = time.monotonic() - t0
            self._watch_stragglers(step, dt)

            if not all(math.isfinite(v) for v in host.values()):
                self.bad_steps += 1
                log.error("non-finite metrics at step %d — quarantining "
                          "update (%d/%d)", step, self.bad_steps,
                          self.cfg.max_bad_steps)
                if self.bad_steps > self.cfg.max_bad_steps:
                    raise RuntimeError("too many bad steps; aborting")
                step += 1          # skip the data window, keep old state
                continue

            self.state = new_state
            history.append(host)
            if self.meter_hook:
                self.meter_hook(step, history[-1], dt)
            if (step + 1) % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step, self.state, blocking=False)
            step += 1

        self.ckpt.save(step - 1, self.state, blocking=True)
        self.ckpt.wait()
        self.metrics_history = history
        return step
