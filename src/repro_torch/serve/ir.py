"""Request IR for the multi-tenant FHE serving subsystem (the port of
``repro.serve.ir``).

A serving request is a straight-line program of primitive HE ops over named
ciphertext registers.  The IR is deliberately tiny — just enough structure
for the batcher to group *same-shaped ops from different requests* into one
stacked kernel dispatch (see :mod:`repro_torch.serve.batcher`): each op names its
kind, destination register, source registers, and an optional immediate
(rotation amount, scalar, plaintext key).

Programs are per-request; tenants own the key material (see
:mod:`repro_torch.serve.keystore`).  Requests carry deadlines and priorities for
the admission queue (:mod:`repro_torch.serve.scheduler`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.core.keys import Ciphertext

# kinds the batcher knows how to stack across requests; anything else falls
# back to per-request execution (still correct, just unbatched)
BATCHED_KINDS = frozenset(
    {"hadd", "hsub", "pmult", "hmult", "square", "rescale", "hrot"})
OP_KINDS = BATCHED_KINDS | frozenset(
    {"conjugate", "mul_const", "add_const"})

# ciphertext-source arity per kind (immediates ride ``arg``)
OP_ARITY = {
    "hadd": 2, "hsub": 2, "hmult": 2,
    "pmult": 1, "square": 1, "rescale": 1, "hrot": 1, "conjugate": 1,
    "mul_const": 1, "add_const": 1,
}

# kinds whose dispatch consumes the tenant's evaluation keys (relin/galois);
# the batcher groups these per tenant and a degraded tenant's key-consuming
# programs are rejected at admission
KEYED_KINDS = frozenset({"hmult", "square", "hrot", "conjugate"})


class RequestFailed(Exception):
    """Terminal typed failure of a request: ``reason`` is a stable string
    (``"transient_fault"``, ``"poisoned"``, ``"tenant_degraded"``, …)."""

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(f"{reason}: {detail}" if detail else reason)


class RequestTimeout(RequestFailed):
    """Deadline expired before (or during) execution."""

    def __init__(self, detail: str = ""):
        super().__init__("timeout", detail)


class RequestRejected(RequestFailed):
    """Admission-time validation rejected the request (malformed program,
    unknown tenant, unsupported rotation, queue full, …)."""


@dataclasses.dataclass(frozen=True)
class HeOp:
    """One primitive HE op: ``dst = kind(*srcs, arg)``.

    arg semantics per kind: ``hrot`` → rotation amount (int), ``pmult`` →
    plaintext key into the request's plaintext table, ``mul_const`` /
    ``add_const`` → float scalar, ``rescale`` → prime count (None = params
    default).
    """
    kind: str
    dst: str
    srcs: tuple[str, ...] = ()
    arg: Any = None

    def __post_init__(self):
        if self.kind not in OP_KINDS:
            raise ValueError(f"unknown HE op kind {self.kind!r}")
        if len(self.srcs) != OP_ARITY[self.kind]:
            raise ValueError(
                f"{self.kind} takes {OP_ARITY[self.kind]} source "
                f"register(s), got {len(self.srcs)}")


class LogicalClock:
    """Deterministic monotonic clock for bit-exact serving replay.

    Every read returns the current time and advances it by ``tick`` —
    identical control flow therefore produces identical timestamps, which
    is what makes deadlines, EDF ordering, and per-request latency
    accounting replayable by the crash-recovery path
    (:mod:`repro_torch.serve.recovery`).  Wall-clock engines
    (``clock=time.monotonic``, the default without a journal) keep their
    old behavior but cannot be recovered bit-exactly.
    """

    def __init__(self, start: float = 0.0, tick: float = 1.0):
        self.t = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        now = self.t
        self.t += self.tick
        return now

    def state(self) -> dict:
        return {"t": self.t, "tick": self.tick}

    @classmethod
    def from_state(cls, state: dict) -> "LogicalClock":
        return cls(start=state["t"], tick=state["tick"])


class _RidCounter:
    """Deterministic, snapshot-restorable request-ID source.

    Replaces the bare ``itertools.count`` so the crash-recovery path can
    persist and restore the counter position — a recovered process then
    assigns exactly the IDs the uninterrupted run would have."""

    def __init__(self, start: int = 0):
        self.next_rid = start

    def __call__(self) -> int:
        rid = self.next_rid
        self.next_rid += 1
        return rid


_rid_counter = _RidCounter()


def rid_counter_state() -> int:
    """The next request ID to be assigned (snapshot this)."""
    return _rid_counter.next_rid


def set_rid_counter(next_rid: int) -> None:
    """Restore the request-ID counter (recovery only — never rewind it in
    a live process or IDs will collide)."""
    _rid_counter.next_rid = int(next_rid)


@dataclasses.dataclass
class FheRequest:
    """One tenant request: inputs + program + requested output registers."""
    tenant: str
    program: tuple[HeOp, ...]
    inputs: dict[str, Ciphertext]
    outputs: tuple[str, ...]
    deadline: float = math.inf              # absolute engine-clock deadline
    priority: int = 0                       # higher = more urgent
    plaintexts: dict = dataclasses.field(default_factory=dict)
    rid: int = dataclasses.field(default_factory=lambda: _rid_counter())

    # -- runtime state (owned by the engine) ----------------------------------
    pc: int = 0
    env: dict = dataclasses.field(default_factory=dict)
    done: bool = False
    status: str = "queued"    # queued|active|ok|rejected|timeout|failed|shed
    error: str | None = None  # terminal reason for non-"ok" states
    attempts: int = 0         # transient-fault retries this request absorbed
    admitted_at: float = math.nan
    started_at: float = math.nan
    finished_at: float = math.nan

    def __post_init__(self):
        self.program = tuple(self.program)
        regs = set(self.inputs)
        for op in self.program:
            missing = [s for s in op.srcs if s not in regs]
            if missing:
                raise ValueError(
                    f"request {self.rid}: op {op.kind} reads undefined "
                    f"register(s) {missing}")
            regs.add(op.dst)
        missing = [o for o in self.outputs if o not in regs]
        if missing:
            raise ValueError(
                f"request {self.rid}: outputs {missing} never written")

    @property
    def next_op(self) -> HeOp | None:
        return self.program[self.pc] if self.pc < len(self.program) else None

    def result(self) -> dict[str, Ciphertext]:
        """The requested output ciphertexts, or a typed terminal error.

        A request that reached a non-"ok" terminal state raises
        :class:`RequestTimeout` / :class:`RequestFailed` — callers never see
        half-computed registers from a faulted or expired request.
        """
        assert self.done, "request not finished"
        if self.status == "timeout":
            raise RequestTimeout(f"request {self.rid}: {self.error}")
        if self.status != "ok":
            raise RequestFailed(self.status if self.error is None
                                else self.error,
                                f"request {self.rid}")
        return {name: self.env[name] for name in self.outputs}


def admission_check(req: "FheRequest", keyset, supports_rotation,
                    supports_conjugate) -> str | None:
    """Static validation of a request's program at admission time.

    Walks the straight-line program with an abstract (basis, scale) state
    per register — the same invariants the ``REPRO_GUARDS`` layer enforces
    at execution time — so malformed programs (level/basis mismatches,
    rescale past the basis floor, drifted-scale adds, missing plaintexts or
    rotation keys) are rejected with a typed reason string up front instead
    of detonating mid-wave and costing a stacked launch.

    Returns None when valid, else a stable ``"op<i>:<kind>:<why>"`` reason.
    """
    from repro_torch.core import guards
    params = keyset.params
    basis = {name: ct.basis for name, ct in req.inputs.items()}
    scale = {name: float(ct.scale) for name, ct in req.inputs.items()}
    for i, op in enumerate(req.program):
        where = f"op{i}:{op.kind}"
        bs = [basis[s] for s in op.srcs]
        sc = [scale[s] for s in op.srcs]
        if len(bs) == 2 and bs[0] != bs[1]:
            return f"{where}:level_mismatch"
        if op.kind in ("hadd", "hsub") and abs(sc[0] - sc[1]) > \
                guards.SCALE_RTOL * max(abs(sc[0]), 1e-300):
            return f"{where}:scale_drift"
        if op.kind in ("hmult", "square") and len(bs[0]) < 2:
            return f"{where}:level_underflow"
        if op.kind in ("rescale", "mul_const"):
            times = (op.arg if op.kind == "rescale" and op.arg is not None
                     else params.rescale_primes if op.kind == "rescale" else 1)
            if len(bs[0]) < times + 1:
                return f"{where}:level_underflow"
        if op.kind == "hrot":
            if not isinstance(op.arg, int):
                return f"{where}:bad_rotation_arg"
            if not supports_rotation(op.arg):
                return f"{where}:unsupported_rotation"
        if op.kind == "conjugate" and not supports_conjugate():
            return f"{where}:unsupported_conjugate"
        if op.kind == "pmult":
            if op.arg not in req.plaintexts:
                return f"{where}:missing_plaintext"
            pt, _ = req.plaintexts[op.arg]
            if tuple(pt.basis) != bs[0]:
                return f"{where}:plaintext_basis_mismatch"
        # abstract transfer: result basis/scale per kind
        if op.kind == "rescale":
            times = op.arg if op.arg is not None else params.rescale_primes
            out_b, out_s = bs[0], sc[0]
            for _ in range(times):
                out_s /= out_b[-1]
                out_b = out_b[:-1]
        elif op.kind == "mul_const":
            out_b, out_s = bs[0][:-1], sc[0]      # drift-free internal rescale
        elif op.kind == "hmult":
            out_b, out_s = bs[0], sc[0] * sc[1]
        elif op.kind == "square":
            out_b, out_s = bs[0], sc[0] * sc[0]
        elif op.kind == "pmult":
            out_b, out_s = bs[0], sc[0] * float(req.plaintexts[op.arg][1])
        else:                                      # hadd/hsub/hrot/conj/add_c
            out_b, out_s = bs[0], sc[0]
        basis[op.dst] = out_b
        scale[op.dst] = out_s
    return None


def standard_program() -> tuple[HeOp, ...]:
    """The canonical serving pipeline used by the demo/bench/tests: an
    encrypted multiply-rotate-accumulate over two input ciphertexts —
    one op of every hot family (HMult+relin, RS, HRot via fused AutoU∘KS,
    HAdd)."""
    return (
        HeOp("hmult", "prod", ("x", "y")),
        HeOp("rescale", "prod", ("prod",)),
        HeOp("hrot", "rot", ("prod",), arg=1),
        HeOp("hadd", "out", ("rot", "prod")),
    )


def standard_reference(z1, z2):
    """Expected plaintext result of :func:`standard_program` on slot
    vectors z1, z2 (the slot after the message window holds an encoded
    zero, so the rotate-left-by-1 shifts one in).  Kept next to the program
    so the demo/launcher/bench never hand-copy the formula."""
    import numpy as np
    prod = np.asarray(z1) * np.asarray(z2)
    return prod + np.append(prod[1:], 0.0)


def standard_request(params, keyset, tenant: str, seed: int,
                     slots: int = 8, device="cuda") -> tuple["FheRequest", tuple]:
    """Seeded :func:`standard_program` request under the tenant's key, its
    ciphertexts on ``device``.

    Returns ``(request, (z1, z2))`` — the plaintext inputs so callers can
    check the decrypted output against :func:`standard_reference`.
    """
    import numpy as np

    from repro_torch.core import encoding as enc
    from repro_torch.core import keys as keys_mod
    scale = float(params.q[-1])
    rng = np.random.default_rng(seed)
    z1 = rng.normal(size=slots)
    z2 = rng.normal(size=slots)
    ct = lambda z: keys_mod.encrypt(
        enc.encode(z, scale, params.q, params.N), scale, keyset.sk,
        params.q, params.N, rng=rng, device=device)
    req = FheRequest(tenant=tenant, program=standard_program(),
                     inputs={"x": ct(z1), "y": ct(z2)}, outputs=("out",))
    return req, (z1, z2)
