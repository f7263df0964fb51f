"""The mixed served wave, for either serving package: the JAX package's
``repro.serve`` or the port's ``repro_torch.serve``.

The wave of ``tests/test_serve_fast.py`` (program A = ``standard_program``:
hmult → rescale → hrot 1 → hadd; program B: hsub → square → rescale →
pmult; the two alternate across tenants "alice" and "bob", keys
``keygen(rotations=(1,), seed=i)``) at ``make_params(N=2⁹, L=4, K=2,
dnum=2)``, served on a logical clock with the request counter set to 0,
as two runs:

* ``batched`` — ``max_batch=6`` with ``TenantKeyStore(max_resident=2)``;
* ``sequential`` — ``max_batch=1, batching=False`` with
  ``TenantKeyStore(max_resident=1)``, so the tenants evict each other.

:func:`serve` returns a record of a run: the SHA-256 of every output
ciphertext (u32 bytes of a, then b) with its scale, basis and domain, the
order the requests started in, the key store's uploads and evictions, the
plan cache's hits, misses and plans, and optionally a snapshot taken after
``snapshot_after`` steps: the SHA-256 of its whole state (the digest its
``COMMITTED`` marker holds) and of its requests' part, where the ciphertext
payloads are.  The package comes in as an :class:`Api`, so the recording
script ``tests/make_torch_serve_ref.py`` (the JAX package),
``tests/test_torch_serve.py`` and ``chip_smoke.py`` (the port) serve the
same wave.  This module imports neither package itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
from typing import Any, Callable

import numpy as np

CONFIG = {"N": 1 << 9, "L": 4, "K": 2, "dnum": 2, "tenants": ["alice", "bob"],
          "rotations": [1], "requests": 6, "base_seed": 100, "slots": 8,
          "snapshot_after": 2}
#: run → (engine kwargs, key store residency)
RUNS = {"batched": ({"max_batch": 6}, 2),
        "sequential": ({"max_batch": 1, "batching": False}, 1)}


@dataclasses.dataclass
class Api:
    """What the wave needs of one serving package: its serve and ckks
    modules, and how it encrypts and builds a coefficient-domain poly."""
    S: Any                     # the serve package
    ckks: Any                  # the CKKS ops module (engine selection)
    encode: Callable           # (z, scale, basis, N) → residues
    encrypt: Callable          # (residues, scale, sk, basis, N, rng) → ct
    coeff_poly: Callable       # (residues, basis) → RnsPoly (COEFF)
    u32: Callable              # tensor → u32 numpy array


def programs(S):
    """(program A, program B) of the mixed wave."""
    return S.standard_program(), (
        S.HeOp("hsub", "d", ("x", "y")),
        S.HeOp("square", "s", ("x",)),
        S.HeOp("rescale", "s", ("s",)),
        S.HeOp("pmult", "out", ("s",), arg="pt"),
    )


def make_request(api: Api, p, keyset, tenant, seed, program, slots=8,
                 priority=0):
    """One request: x, y encrypt normal(slots) draws of ``default_rng(seed)``
    at scale q_top; a pmult program also gets plaintext "pt", a third draw
    encoded at q[:L-1].  Returns (request, (z1, z2, zp or None))."""
    scale = float(p.q[-1])
    rng = np.random.default_rng(seed)
    z1, z2 = rng.normal(size=slots), rng.normal(size=slots)
    x = api.encrypt(api.encode(z1, scale, p.q, p.N), scale, keyset.sk, p.q,
                    p.N, rng)
    y = api.encrypt(api.encode(z2, scale, p.q, p.N), scale, keyset.sk, p.q,
                    p.N, rng)
    pts, zp = {}, None
    if any(op.kind == "pmult" for op in program):
        zp = rng.normal(size=slots)
        basis = p.q[:p.L - 1]
        pts["pt"] = (api.coeff_poly(api.encode(zp, scale, basis, p.N), basis),
                     scale)
    req = api.S.FheRequest(tenant=tenant, program=program,
                           inputs={"x": x, "y": y}, outputs=("out",),
                           plaintexts=pts, priority=priority)
    return req, (z1, z2, zp)


def expected(z):
    """The plaintext result of a request's program from its inputs."""
    z1, z2, zp = z
    if zp is None:                                   # program A
        prod = z1 * z2
        return prod + np.append(prod[1:], 0.0)
    return z1 * z1 * zp                              # program B


def wave(api: Api, p, keysets: dict, n: int, base_seed: int, slots: int = 8):
    """The mixed wave: request i runs program A (even i) or B (odd i) for
    tenant i mod 2, seed base_seed + i, priority 2i mod 3.  Returns
    [(request, z)]."""
    prog_a, prog_b = programs(api.S)
    tenants = list(keysets)
    out = []
    for i in range(n):
        tenant = tenants[i % len(tenants)]
        out.append(make_request(api, p, keysets[tenant], tenant, base_seed + i,
                                prog_a if i % 2 == 0 else prog_b, slots,
                                priority=2 * i % 3))
    return out


def ct_digest(api: Api, ct) -> str:
    """SHA-256 of the u32 bytes of a, then b."""
    h = hashlib.sha256()
    for x in (ct.a.data, ct.b.data):
        h.update(np.ascontiguousarray(api.u32(x)).tobytes())
    return h.hexdigest()


def snapshot_digests(api: Api, eng, directory: str) -> dict:
    """Publish a snapshot of ``eng`` and digest it: the whole state (what
    its COMMITTED marker holds) and the requests' part, which carries every
    ciphertext payload."""
    store = api.S.SnapshotStore(directory)
    path = eng.snapshot(store)
    with open(os.path.join(path, store.STATE), "rb") as f:
        state = json.loads(f.read())
    with open(os.path.join(path, store.MARKER)) as f:
        marker = f.read().strip()
    reqs = {k: state[k] for k in ("queue", "active", "completed", "failed")}
    return {"state_sha256": marker, "requests_sha256": hashlib.sha256(
        json.dumps(reqs, sort_keys=True).encode()).hexdigest()}


def serve(api: Api, p, keysets: dict, run: str, cfg: dict = CONFIG,
          snapshot_dir: str | None = None, during=contextlib.nullcontext):
    """Serve the wave once as ``run`` ("batched" | "sequential") on a fresh
    key store and engine, the serving (not the encryption of the requests)
    inside the context ``during()``: (record, [(request, z)], engine)."""
    S = api.S
    kwargs, resident = RUNS[run]
    store = S.TenantKeyStore(max_resident=resident)
    for t, ks in keysets.items():
        store.register(t, ks)
    S.set_rid_counter(0)
    reqs = wave(api, p, keysets, cfg["requests"], cfg["base_seed"], cfg["slots"])
    eng = S.FheServeEngine(store, clock=S.LogicalClock(), **kwargs)
    snap = None
    with during():
        for req, _ in reqs:
            assert eng.submit(req)
        if snapshot_dir is not None:
            for _ in range(cfg["snapshot_after"]):
                eng.step()
            snap = snapshot_digests(api, eng, snapshot_dir)
        eng.run_until_drained()
    record = {
        "outputs": [{"rid": r.rid, "status": r.status,
                     **({"sha256": ct_digest(api, r.result()["out"]),
                         "scale": float(r.result()["out"].scale),
                         "basis": [int(q) for q in r.result()["out"].basis],
                         "domain": r.result()["out"].a.domain}
                        if r.status == "ok" else {})} for r, _ in reqs],
        "start_order": [r.rid for r, _ in sorted(reqs,
                                                 key=lambda t: t[0].started_at)],
        "keystore": {"uploads": store.uploads, "evictions": store.evictions},
        "plans": eng.plans.stats(),
        "metrics": {k: getattr(eng.metrics, k) for k in (
            "served", "steps", "groups_dispatched", "ops_executed",
            "ops_batched")},
    }
    if snap is not None:
        record["snapshot"] = snap
    return record, reqs, eng


def port_api(device) -> Api:
    """The port's side of the wave, its tensors on ``device``."""
    from repro_torch import serve as S
    from repro_torch.core import ckks, encoding as enc, keys as K, poly as pl
    return Api(S=S, ckks=ckks, encode=enc.encode,
               encrypt=lambda m, s, sk, b, N, rng: K.encrypt(
                   m, s, sk, b, N, rng=rng, device=device),
               coeff_poly=lambda m, b: pl.RnsPoly(pl.to_tensor(m, device), b,
                                                  pl.COEFF),
               u32=pl.to_numpy)


def keysets_for(K, p, cfg: dict = CONFIG, **kw) -> dict:
    """{tenant: keygen(p, rotations, seed=i)} of the configuration."""
    return {t: K.keygen(p, rotations=tuple(cfg["rotations"]), seed=i, **kw)
            for i, t in enumerate(cfg["tenants"])}
