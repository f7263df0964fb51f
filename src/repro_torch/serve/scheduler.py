"""Admission queue for the FHE serving engine.

Earliest-deadline-first within priority class: requests pop in
``(-priority, deadline, submission order)`` order, so urgent tenants are
never starved by a long tail of lax-deadline work and ties break FIFO.
Admission is bounded — a full queue rejects instead of growing without
bound (the engine surfaces rejects in its metrics so load shedding is
visible, not silent).
"""
from __future__ import annotations

import heapq

from .ir import FheRequest


class QueueFull(Exception):
    """Raised by :meth:`AdmissionQueue.push` when at capacity."""


class AdmissionQueue:
    def __init__(self, capacity: int = 1024):
        self.capacity = capacity
        self._heap: list = []
        self._next_seq = 0            # plain int so recovery can restore it

    def push(self, req: FheRequest) -> None:
        if len(self._heap) >= self.capacity:
            raise QueueFull(
                f"admission queue at capacity ({self.capacity})")
        seq = self._next_seq
        self._next_seq += 1
        heapq.heappush(self._heap, (-req.priority, req.deadline, seq, req))

    # -- crash-safe serving (repro_torch.serve.recovery) ----------------------------

    def snapshot_state(self, req_to_wire) -> dict:
        """Queue contents in internal heap-array order (a valid heap
        round-trips verbatim), with each entry's FIFO tie-break sequence —
        restoring reproduces EDF ordering bit-exactly."""
        return {
            "next_seq": self._next_seq,
            "entries": [{"seq": seq, "req": req_to_wire(req)}
                        for (_, _, seq, req) in self._heap],
        }

    def restore_state(self, state: dict, req_from_wire) -> list[FheRequest]:
        """Rebuild the heap from :meth:`snapshot_state`; returns the
        restored requests (so the engine can index them by rid)."""
        reqs = []
        self._heap = []
        for entry in state["entries"]:
            req = req_from_wire(entry["req"])
            self._heap.append(
                (-req.priority, req.deadline, entry["seq"], req))
            reqs.append(req)
        self._next_seq = state["next_seq"]
        return reqs

    def pop(self) -> FheRequest:
        return heapq.heappop(self._heap)[-1]

    def shed_lowest(self, k: int) -> list[FheRequest]:
        """Remove and return the ``k`` least-urgent queued requests.

        "Least urgent" is the max of the heap ordering — lowest priority,
        then laxest deadline, then newest.  Used by the overload controller
        when the engine enters SHEDDING: dropping from the lax tail keeps
        urgent tenants' latency bounded instead of letting the whole queue
        rot."""
        shed = []
        for _ in range(min(k, len(self._heap))):
            worst = max(range(len(self._heap)),
                        key=lambda i: self._heap[i][:3])
            shed.append(self._heap.pop(worst)[-1])
        heapq.heapify(self._heap)
        return shed

    def peek(self) -> FheRequest:
        return self._heap[0][-1]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
