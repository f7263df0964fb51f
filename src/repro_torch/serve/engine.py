"""LM decode engine: continuous-batching-lite over the KV caches (the port
of ``repro.serve.engine``).

Requests join a fixed-size slot table; each engine step decodes one token for
every active slot (one ``decode_step`` over the whole batch).  Finished or
empty slots are refilled from the queue with a per-slot prefill.  Slot state
(positions, done flags) is host-side; the model and its caches live on the
model's device.

Two behaviours are the reference's and kept for parity: the prefill feeds a
prompt through ``decode_step`` over all slots, writing token 0 into the
other slots' caches at the prompt's positions, and a step decodes every
active slot at the largest slot position.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (P,) int
    max_new_tokens: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: T.Transformer, batch_slots: int,
                 max_seq: int, eos_id: int = 0):
        T.check_family(cfg)
        self.cfg = cfg
        self.params = params
        self.device = params.embed.table.device
        self.slots = batch_slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.cache = T.init_cache(cfg, batch_slots, max_seq, device=self.device)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, dtype=np.int64)
        self.queue: list[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    @torch.no_grad()
    def _decode(self, tokens: np.ndarray, pos: int):
        """One ``decode_step`` of (slots, 1) host tokens at ``pos``; the
        logits stay on the device."""
        t = torch.from_numpy(tokens).to(self.device)
        logits, self.cache = T.decode_step(self.params, self.cfg, t, self.cache, pos)
        return logits

    def _prefill_slot(self, slot: int, req: Request):
        """Feed the prompt token-by-token through decode_step (cache-filling
        prefill; a production engine fuses this into a chunked prefill)."""
        for i, tok in enumerate(req.prompt):
            tvec = np.full((self.slots, 1), 0, np.int32)
            tvec[slot, 0] = tok
            logits = self._decode(tvec, i)
        self.slot_pos[slot] = len(req.prompt)
        req.generated.append(int(torch.argmax(logits[slot, 0])))

    def step(self) -> int:
        """One engine iteration; returns number of active slots."""
        # refill free slots
        for s in range(self.slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[s] = req
                self._prefill_slot(s, req)
        active = [s for s in range(self.slots) if self.slot_req[s] is not None]
        if not active:
            return 0
        # batched single-token decode at the max position of the active
        # slots (per-slot positions are kept in the cache's slot_pos)
        tok = np.zeros((self.slots, 1), np.int32)
        for s in active:
            tok[s, 0] = self.slot_req[s].generated[-1]
        pos = int(self.slot_pos[active].max())
        nxt_all = torch.argmax(self._decode(tok, pos)[:, 0], dim=-1).tolist()
        for s in active:
            req = self.slot_req[s]
            nxt = nxt_all[s]
            req.generated.append(nxt)
            self.slot_pos[s] += 1
            if (nxt == self.eos_id
                    or len(req.generated) >= req.max_new_tokens):
                req.done = True
                self.slot_req[s] = None
        return len(active)

    def run_until_drained(self, max_iters: int = 10_000):
        done = []
        for _ in range(max_iters):
            n = self.step()
            if n == 0 and not self.queue:
                break
        return done
