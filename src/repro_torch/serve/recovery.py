"""Deterministic crash recovery for the FHE serving engine (the port of
``repro.serve.recovery``).

The durability contract has three pieces that compose into bit-identical
recovery:

* the **journal** (:mod:`repro_torch.serve.journal`) — every admission, step
  boundary, and terminal status framed and flushed before the effect is
  acknowledged;
* **snapshots** (:class:`SnapshotStore`) — periodic full engine state,
  published atomically with the same tmp-dir → hash → ``COMMITTED`` →
  rename contract as the reference's ``repro.checkpoint.manager``, so a
  crash mid-save leaves the previous committed snapshot intact;
* **replay** (:func:`recover`) — load the newest committed snapshot, then
  re-execute the journal tail record-by-record against an engine that is
  deterministic by construction (:class:`~repro_torch.serve.ir.LogicalClock`
  timestamps, restorable request-ID counter, restorable retry-jitter and
  fault-injector RNG positions, FIFO-sequence-exact queue restore).

The snapshot protocol orders ``journal.rotate()`` FIRST, records the new
segment index as ``tail_from_segment`` inside the snapshot, publishes, then
drops fully-covered segments — a crash at ANY point in that sequence leaves
a consistent (snapshot, tail) pair: either the old snapshot plus a longer
tail, or the new snapshot plus a shorter one.

Ciphertexts cross the crash boundary as base64 u32 residue payloads plus
(shape, basis, domain) — exact, no float round-trip, the same bytes as the
reference writes.  Ciphertexts come back on the device a recovering engine
names (``device``; default "cuda").  Tenant *key material*
deliberately does not: the host-side keystore registry is the source of
truth and tenants re-register with the recovered process (see
``TenantKeyStore.state_dict``).
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import shutil

import numpy as np

import torch

from repro_torch.core import poly as pl
from repro_torch.core.keys import Ciphertext

from .ir import HeOp, FheRequest, LogicalClock
from .ir import rid_counter_state, set_rid_counter
from .journal import Journal, replay_directory


class RecoveryError(Exception):
    """Replay produced state inconsistent with the journal's own records
    (a terminal-status mismatch) — determinism was violated somewhere."""


# ----------------------------------------------------------------------------
# Wire serdes: exact ciphertext / request round-trip through JSON
# ----------------------------------------------------------------------------

def poly_to_wire(p: pl.RnsPoly) -> dict:
    data = pl.to_numpy(p.data)                 # the u32 bits, on the host
    return {
        "data": base64.b64encode(data.tobytes()).decode("ascii"),
        "shape": list(data.shape),
        "basis": list(p.basis),
        "domain": p.domain,
    }


def poly_from_wire(d: dict, device="cuda") -> pl.RnsPoly:
    data = np.frombuffer(base64.b64decode(d["data"]),
                         dtype=np.uint32).reshape(d["shape"])
    return pl.RnsPoly(torch.as_tensor(data.view(np.int32).copy(), device=device),
                      tuple(d["basis"]), d["domain"])


def ct_to_wire(ct: Ciphertext) -> dict:
    return {"a": poly_to_wire(ct.a), "b": poly_to_wire(ct.b),
            "scale": float(ct.scale)}


def ct_from_wire(d: dict, device="cuda") -> Ciphertext:
    return Ciphertext(poly_from_wire(d["a"], device),
                      poly_from_wire(d["b"], device), d["scale"])


def request_to_wire(req: FheRequest, env: str = "none") -> dict:
    """Serialize one request.  ``env`` scopes the register file: "none"
    (queued/failed — inputs suffice to re-execute), "full" (active —
    mid-program registers are live state), "outputs" (completed — only
    what :meth:`~repro_torch.serve.ir.FheRequest.result` can ever read)."""
    if env == "full":
        env_wire = {k: ct_to_wire(v) for k, v in req.env.items()}
    elif env == "outputs":
        env_wire = {k: ct_to_wire(req.env[k]) for k in req.outputs}
    elif env == "none":
        env_wire = None
    else:
        raise ValueError(f"unknown env scope {env!r}")
    return {
        "tenant": req.tenant,
        "program": [{"kind": op.kind, "dst": op.dst,
                     "srcs": list(op.srcs), "arg": op.arg}
                    for op in req.program],
        "inputs": {k: ct_to_wire(v) for k, v in req.inputs.items()},
        "outputs": list(req.outputs),
        "deadline": req.deadline,
        "priority": req.priority,
        # plaintext keys may be non-string (JSON object keys can't be):
        # serialize as [key, poly, scale] triples
        "plaintexts": [[k, poly_to_wire(pt), float(s)]
                       for k, (pt, s) in req.plaintexts.items()],
        "rid": req.rid,
        "pc": req.pc,
        "done": req.done,
        "status": req.status,
        "error": req.error,
        "attempts": req.attempts,
        "admitted_at": req.admitted_at,
        "started_at": req.started_at,
        "finished_at": req.finished_at,
        "env": env_wire,
    }


def request_from_wire(d: dict, device="cuda") -> FheRequest:
    """Rebuild a request EXACTLY, including its rid (no counter draw) and
    runtime state, its ciphertexts and plaintexts on ``device``."""
    req = FheRequest(
        tenant=d["tenant"],
        program=tuple(HeOp(kind=op["kind"], dst=op["dst"],
                           srcs=tuple(op["srcs"]), arg=op["arg"])
                      for op in d["program"]),
        inputs={k: ct_from_wire(v, device) for k, v in d["inputs"].items()},
        outputs=tuple(d["outputs"]),
        deadline=d["deadline"],
        priority=d["priority"],
        plaintexts={k: (poly_from_wire(pt, device), s)
                    for k, pt, s in d["plaintexts"]},
        rid=d["rid"],
    )
    req.pc = d["pc"]
    req.done = d["done"]
    req.status = d["status"]
    req.error = d["error"]
    req.attempts = d["attempts"]
    req.admitted_at = d["admitted_at"]
    req.started_at = d["started_at"]
    req.finished_at = d["finished_at"]
    req.env = ({k: ct_from_wire(v, device) for k, v in d["env"].items()}
               if d["env"] is not None else {})
    return req


# ----------------------------------------------------------------------------
# Snapshot store: atomic-publish directory of engine states
# ----------------------------------------------------------------------------

class SnapshotStore:
    """``snap_<n>/`` directories published with the checkpoint manager's
    atomicity contract: write into a tmp dir, hash the payload into a
    ``COMMITTED`` marker, ``os.replace`` into place.  A directory without
    a matching marker is an aborted save and is ignored (and a crash
    mid-save therefore falls back to the previous committed snapshot)."""

    STATE = "state.json"
    MARKER = "COMMITTED"

    def __init__(self, directory: str, keep: int = 3):
        assert keep >= 1
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, seq: int) -> str:
        return os.path.join(self.dir, f"snap_{seq:09d}")

    def sequences(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("snap_") and not name.startswith("snap_."):
                try:
                    out.append(int(name[len("snap_"):]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, state: dict) -> str:
        seq = (self.sequences()[-1] + 1) if self.sequences() else 0
        final = self._path(seq)
        tmp = os.path.join(self.dir, f".tmp_snap_{seq:09d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        payload = json.dumps(state, sort_keys=True).encode("utf-8")
        with open(os.path.join(tmp, self.STATE), "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        digest = hashlib.sha256(payload).hexdigest()
        with open(os.path.join(tmp, self.MARKER), "w") as f:
            f.write(digest + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        seqs = [s for s in self.sequences()
                if self.load(self._path(s)) is not None]
        for s in seqs[:-self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def load(self, path: str) -> dict | None:
        """The snapshot state at ``path``, or None if it is not a valid
        committed snapshot (missing/mismatched marker, unreadable)."""
        try:
            with open(os.path.join(path, self.STATE), "rb") as f:
                payload = f.read()
            with open(os.path.join(path, self.MARKER)) as f:
                digest = f.read().strip()
        except OSError:
            return None
        if hashlib.sha256(payload).hexdigest() != digest:
            return None
        try:
            return json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None

    def load_latest_valid(self) -> tuple[dict | None, str | None]:
        """Newest committed snapshot, walking backwards past aborted or
        corrupted saves.  (None, None) = cold start."""
        for seq in reversed(self.sequences()):
            path = self._path(seq)
            state = self.load(path)
            if state is not None:
                return state, path
        return None, None


# ----------------------------------------------------------------------------
# Engine state capture / restore
# ----------------------------------------------------------------------------

def engine_state(eng, tail_from_segment: int = 0) -> dict:
    """Everything a recovered process needs to resume bit-exactly (key
    material excluded — see module docstring)."""
    from repro_torch.runtime import faults
    clock = eng._clock
    inj = faults.active_injector()
    return {
        "version": 1,
        "tail_from_segment": tail_from_segment,
        "clock": clock.state() if isinstance(clock, LogicalClock) else None,
        "next_rid": rid_counter_state(),
        "retry_draws": eng._retry_draws,
        "queue": eng.queue.snapshot_state(
            lambda r: request_to_wire(r, env="none")),
        "active": [request_to_wire(r, env="full") for r in eng.active],
        "completed": [request_to_wire(r, env="outputs")
                      for r in eng.completed],
        "failed": [request_to_wire(r, env="none") for r in eng.failed],
        "keystore": eng.keystore.state_dict(),
        "plans": eng.plans.state_dict(),
        "metrics": eng.metrics.state_dict(),
        "overload": {"pressure": eng.overload.pressure,
                     "step_faults": eng.overload._step_faults},
        "injector": inj.state_dict() if inj is not None else None,
    }


def load_engine_state(eng, state: dict, restage: bool = True,
                      device="cuda") -> None:
    """Restore a captured :func:`engine_state` into a fresh engine whose
    keystore already has the tenants re-registered; ciphertexts land on
    ``device``."""
    from_wire = lambda d: request_from_wire(d, device)
    if state.get("version") != 1:
        raise RecoveryError(f"unknown snapshot version {state.get('version')}")
    if state["clock"] is not None:
        eng._clock = LogicalClock.from_state(state["clock"])
    set_rid_counter(state["next_rid"])
    eng._retry_draws = state["retry_draws"]
    eng._retry_rng = np.random.default_rng(eng.retry.seed)
    for _ in range(eng._retry_draws):
        eng._retry_rng.uniform(-1.0, 1.0)     # burn to the saved position
    eng.queue.restore_state(state["queue"], from_wire)
    eng.active = [from_wire(d) for d in state["active"]]
    eng.completed = [from_wire(d) for d in state["completed"]]
    eng.failed = [from_wire(d) for d in state["failed"]]
    eng.keystore.load_state(state["keystore"], restage=restage)
    eng.plans.load_state(state["plans"], eng.batcher.build_from_key)
    eng.metrics.load_state(state["metrics"])
    eng.overload.pressure = state["overload"]["pressure"]
    eng.overload._step_faults = state["overload"]["step_faults"]


# ----------------------------------------------------------------------------
# Recovery
# ----------------------------------------------------------------------------

def replay_records(eng, records: list[dict], device="cuda") -> dict:
    """Re-execute journal records against a restored engine.

    ``admit`` re-submits the exact request; ``step`` re-runs one engine
    step; ``terminal`` records *verify* — replay must independently
    reproduce every journaled terminal status, and a mismatch raises
    :class:`RecoveryError` rather than serving silently-divergent state.
    """
    eng._replaying = True
    admitted = steps = 0
    max_rid = -1
    terminals: list[dict] = []
    try:
        for rec in records:
            kind = rec["type"]
            if kind == "admit":
                req = request_from_wire(rec["req"], device)
                max_rid = max(max_rid, req.rid)
                eng.submit(req)
                admitted += 1
            elif kind == "step":
                eng.step()
                steps += 1
            elif kind == "terminal":
                terminals.append(rec)
            else:
                raise RecoveryError(f"unknown journal record type {kind!r}")
    finally:
        eng._replaying = False
    produced = {r.rid: r for r in eng.completed + eng.failed}
    for t in terminals:
        got = produced.get(t["rid"])
        if got is None or got.status != t["status"]:
            raise RecoveryError(
                f"replay diverged: journal says rid {t['rid']} ended "
                f"{t['status']!r}, replay produced "
                f"{got.status if got else 'nothing'!r}")
    if max_rid >= 0:
        set_rid_counter(max(rid_counter_state(), max_rid + 1))
    return {"admitted": admitted, "steps": steps,
            "terminals_verified": len(terminals)}


def recover(snapshot_dir: str, journal_dir: str, keystore,
            injector=None, restage: bool = True, device="cuda",
            **engine_kwargs):
    """Rebuild a serving engine from disk: newest committed snapshot +
    deterministic replay of the journal tail.

    ``keystore`` must already have every tenant re-registered (key material
    never crosses the crash boundary).  ``injector`` — the active
    :class:`~repro_torch.runtime.faults.FaultInjector` of the recovered process,
    fast-forwarded to the snapshot's saved RNG position so replayed chaos
    fires at exactly the original events.  ``device`` — where the recovered
    ciphertexts live (the tenants' keys must be there too).

    Returns ``(engine, report)``; the engine comes back journaling into a
    fresh segment of the same directory, ready to serve.
    """
    from .fhe import FheServeEngine

    store = SnapshotStore(snapshot_dir)
    state, snap_path = store.load_latest_valid()
    eng = FheServeEngine(keystore, clock=LogicalClock(), **engine_kwargs)
    tail_from = 0
    if state is not None:
        load_engine_state(eng, state, restage=restage, device=device)
        tail_from = state["tail_from_segment"]
        if injector is not None and state["injector"] is not None:
            injector.load_state(state["injector"])
    torn = 0
    records: list[dict] = []
    if os.path.isdir(journal_dir):
        records, torn = replay_directory(journal_dir,
                                         from_segment=tail_from)
    replayed = replay_records(eng, records, device)
    eng.journal = Journal(journal_dir)
    report = {
        "snapshot": snap_path,
        "tail_from_segment": tail_from,
        "torn_bytes": torn,
        "records": len(records),
        **replayed,
    }
    return eng, report
