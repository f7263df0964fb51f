"""Ciphertext batcher: one stacked kernel dispatch per homogeneous op group.

The engine hands the batcher the *current op of every active request* each
step.  Ops are grouped by a batch key — kind, level basis, and (for
key-consuming ops) tenant, since HMult/HRot consume the tenant's evks — and
each group dispatches ONCE through the leading-dim-batched core ops
(:func:`repro_torch.core.ckks.hmult_many`, ``rescale_many``, ``hrot_many``, …):
B requests' HMults are one stacked tensor product + one stacked ModUp +
ONE ModDown, a whole group of rotations is one fused AutoU∘KS launch, and
so on.  Kinds outside ``BATCHED_KINDS`` (or groups of size 1) still execute
correctly through the same plans as singleton groups.

Key-consuming ops batch per tenant; purely arithmetic ops (eltwise, rescale,
pmult) batch ACROSS tenants — ciphertexts under different secret keys can
share a stacked dispatch because the math is component-wise and key-free.

Executors are resolved through the :class:`~repro_torch.serve.plans.PlanCache`
keyed on (kind, basis, batch size, params, tenant) — steady-state serving of
a fixed workload re-resolves nothing.

**Transactional scatter invariant**: every executor computes ALL results
before writing ANY back into request register files.  A fault or guard trip
mid-compute therefore leaves every request's ``env`` exactly as it was —
the engine's retry/replay machinery (``repro_torch.serve.fhe``) depends on this
to re-dispatch a faulted group (or its split singletons) safely even for
ops whose destination register aliases a source.
"""
from __future__ import annotations

from repro_torch.core import ckks
from repro_torch.runtime import tracing

from .ir import BATCHED_KINDS, KEYED_KINDS as _KEYED_KINDS, FheRequest, HeOp
from .keystore import TenantKeyStore
from .plans import PlanCache

Item = tuple[FheRequest, HeOp]


class Batcher:
    def __init__(self, keystore: TenantKeyStore, plans: PlanCache,
                 batching: bool = True):
        self.keystore = keystore
        self.plans = plans
        self.batching = batching

    # -- grouping -------------------------------------------------------------

    def _batch_key(self, req: FheRequest, op: HeOp):
        basis = req.env[op.srcs[0]].basis
        if op.kind in ("hadd", "hsub", "pmult"):
            return (op.kind, basis)
        if op.kind == "rescale":
            params = self.keystore.keyset(req.tenant).params
            times = op.arg if op.arg is not None else params.rescale_primes
            return ("rescale", basis, times)
        if op.kind in ("hmult", "square", "hrot"):
            return (op.kind, basis, req.tenant)
        return ("<seq>", req.rid, req.pc)       # unbatched fallback, unique

    def form_groups(self, ready: list[Item]) -> list[list[Item]]:
        """Stable grouping of the step's ops by batch key (or singletons when
        batching is off — the sequential baseline)."""
        if not self.batching:
            return [[item] for item in ready]
        groups: dict = {}
        for req, op in ready:
            key = self._batch_key(req, op)
            if op.kind not in BATCHED_KINDS:
                key = key + (req.rid,)
            groups.setdefault(key, []).append((req, op))
        return list(groups.values())

    # -- execution ------------------------------------------------------------

    def execute(self, group: list[Item]) -> None:
        """Dispatch one group through its (cached) plan and write results
        back into each request's register file."""
        req, op = group[0]
        with tracing.span("plan", kind=op.kind):
            plan = self.plans.get(self.plan_key(group),
                                  lambda: self._build(req, op))
        plan(group)

    def plan_key(self, group: list[Item]):
        """(kind, basis, batch, tenant, build-arg).  The build-arg slot
        carries ``op.arg`` for rescale — two rescale depths at the same
        basis/batch must never share an executor — and None elsewhere."""
        req, op = group[0]
        basis = req.env[op.srcs[0]].basis
        return (op.kind, basis, len(group),
                req.tenant if op.kind in _KEYED_KINDS else None,
                op.arg if op.kind == "rescale" else None)

    def _build(self, req: FheRequest, op: HeOp):
        return self._build_kind(op.kind, req.tenant, op.arg)

    def build_from_key(self, key):
        """Rebuild the executor for a snapshotted plan key (crash
        recovery).  Everything the executor needs lives in the key except
        the params owner for a default-depth rescale, which falls back to
        any registered tenant; returns None when a key cannot be rebuilt
        statically (it will lazily rebuild on first use instead)."""
        kind, _basis, _size, tenant, arg = key
        if tenant is None:
            tenants = self.keystore.tenants()
            if kind == "rescale" and arg is None and not tenants:
                return None
            tenant = tenants[0] if tenants else None
        try:
            return self._build_kind(kind, tenant, arg)
        except Exception:       # unknown tenant after re-registration drift
            return None

    def _build_kind(self, kind: str, tenant: str | None, arg):
        """Resolve everything static for one plan key ONCE: the dispatch
        function, the owning tenant (key-consuming kinds), the params and
        rescale depth.  The returned executor only stacks operands, touches
        keystore residency (so eviction/re-staging stays counted by the
        keystore, never silently inside a plan), dispatches the batched core
        op, and scatters results."""
        if kind in ("hadd", "hsub"):
            sub = kind == "hsub"

            def ex(items: list[Item]) -> None:
                c1s = [r.env[o.srcs[0]] for r, o in items]
                c2s = [r.env[o.srcs[1]] for r, o in items]
                self._scatter(items, ckks.hadd_many(c1s, c2s, sub=sub))
            return ex
        if kind == "pmult":
            return self._exec_pmult
        if kind == "rescale":
            params = self.keystore.keyset(tenant).params
            times = arg if arg is not None else params.rescale_primes

            def ex(items: list[Item]) -> None:
                cts = [r.env[o.srcs[0]] for r, o in items]
                self._scatter(items, ckks.rescale_many(cts, params,
                                                       times=times))
            return ex
        if kind in ("hmult", "square"):
            many = ckks.hmult_many if kind == "hmult" else None

            def ex(items: list[Item]) -> None:
                keys = self.keystore.acquire(tenant)
                cts = [r.env[o.srcs[0]] for r, o in items]
                if many is not None:
                    c2s = [r.env[o.srcs[1]] for r, o in items]
                    outs = many(cts, c2s, keys)
                else:
                    outs = ckks.square_many(cts, keys)
                self._scatter(items, outs)
            return ex
        if kind == "hrot":
            def ex(items: list[Item]) -> None:
                keys = self.keystore.acquire(tenant)
                cts = [r.env[o.srcs[0]] for r, o in items]
                rots = [o.arg for _, o in items]
                self._scatter(items, ckks.hrot_many(cts, rots, keys))
            return ex
        return getattr(self, f"_exec_{kind}")

    @staticmethod
    def _scatter(items: list[Item], outs) -> None:
        """Publish a dispatch's results into the request register files.

        Under a watchdog-bounded dispatch, publication goes through the
        token's commit gate: an abandoned worker's late results are
        discarded (it unwinds as HungLaunch) instead of racing the retry
        that replaced it — the transactional-scatter invariant holds even
        across abandonment."""
        from repro_torch.runtime import faults
        token = faults.current_dispatch_token()
        with tracing.span("scatter", batch=len(items)):
            if token is None:
                for (req, op), out in zip(items, outs):
                    req.env[op.dst] = out
                return
            with token.commit():
                for (req, op), out in zip(items, outs):
                    req.env[op.dst] = out

    def _exec_pmult(self, items: list[Item]) -> None:
        cts = [req.env[op.srcs[0]] for req, op in items]
        pts, scales = [], []
        for req, op in items:
            pt, pt_scale = req.plaintexts[op.arg]
            pts.append(pt)
            scales.append(pt_scale)
        self._scatter(items, ckks.pmult_many(cts, pts, scales))

    # -- unbatched fallbacks (singleton groups) --------------------------------

    def _exec_conjugate(self, items: list[Item]) -> None:
        outs = [ckks.conjugate(req.env[op.srcs[0]],
                               self.keystore.acquire(req.tenant))
                for req, op in items]
        self._scatter(items, outs)

    def _exec_mul_const(self, items: list[Item]) -> None:
        outs = [ckks.mul_const(req.env[op.srcs[0]], float(op.arg),
                               self.keystore.keyset(req.tenant).params)
                for req, op in items]
        self._scatter(items, outs)

    def _exec_add_const(self, items: list[Item]) -> None:
        outs = [ckks.add_const(req.env[op.srcs[0]], float(op.arg))
                for req, op in items]
        self._scatter(items, outs)
