"""Plan cache for batched HE op execution.

A *plan* is the resolved executor for one batch shape — keyed on
``(op kind, level basis, batch size, tenant)`` — with everything statically
resolvable bound at build time: the concrete ``*_many`` dispatch closure,
the owning tenant for key-consuming kinds, the params and rescale depth
(see ``Batcher._build``).  Evk *staging* deliberately stays with the
keystore's ``acquire`` on every execution so tenant eviction/re-staging is
always counted there, never hidden inside a cached plan.  Steady-state
serving therefore re-resolves nothing per batch: the engine looks the plan
up (a dict hit), hands it the group, and the plan jumps straight into the
leading-dim-batched kernel path whose constants and evk stacks are already
device-resident.

``hits``/``misses``/``builds`` make the zero-retrace claim measurable: after
the warmup wave of a fixed workload, ``misses`` must stop moving.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Hashable


@dataclasses.dataclass
class Plan:
    key: Hashable
    execute: Callable            # list[(FheRequest, HeOp)] -> None
    uses: int = 0

    def __call__(self, items) -> None:
        self.uses += 1
        self.execute(items)


class PlanCache:
    def __init__(self, max_plans: int = 4096):
        self._plans: dict[Hashable, Plan] = {}
        self.max_plans = max_plans
        self.hits = 0
        self.misses = 0

    @property
    def builds(self) -> int:
        return self.misses

    def get(self, key: Hashable, make: Callable[[], Callable]) -> Plan:
        plan = self._plans.get(key)
        if plan is None:
            self.misses += 1
            if len(self._plans) >= self.max_plans:
                self._plans.pop(next(iter(self._plans)))
            plan = self._plans[key] = Plan(key=key, execute=make())
        else:
            self.hits += 1
        return plan

    def stats(self) -> dict:
        return {"plans": len(self._plans), "hits": self.hits,
                "misses": self.misses}

    def __len__(self) -> int:
        return len(self._plans)

    # -- crash-safe serving (repro_torch.serve.recovery) ----------------------------

    def keys(self) -> list:
        return list(self._plans)

    def state_dict(self) -> dict:
        """Plan keys + hit/miss accounting — executors themselves are
        rebuilt at restore (they close over live keystore state)."""
        return {"keys": self.keys(), "hits": self.hits,
                "misses": self.misses}

    def load_state(self, state: dict, make) -> int:
        """Prewarm from a snapshot: ``make(key)`` returns an executor
        (or None to skip a key that cannot be rebuilt statically — it will
        lazily rebuild on its first post-recovery miss).  Hit/miss
        counters restore verbatim, so prewarming is invisible to the
        zero-steady-state-builds gate.  Returns the number of plans
        rebuilt.  Keys that crossed a JSON round-trip come back as nested
        lists and are re-frozen to the tuples the live cache hashes on."""

        def freeze(k):
            return tuple(freeze(x) for x in k) if isinstance(k, list) else k

        rebuilt = 0
        for key in map(freeze, state["keys"]):
            ex = make(key)
            if ex is not None:
                self._plans[key] = Plan(key=key, execute=ex)
                rebuilt += 1
        self.hits = state["hits"]
        self.misses = state["misses"]
        return rebuilt
