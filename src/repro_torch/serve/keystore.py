"""Per-tenant key store with LRU residency and an upload-count budget.

Each tenant registers a :class:`~repro_torch.core.keys.KeySet` once.  Making a
tenant *resident* stages its evaluation keys for the kernel paths — the
relin digit keys via ``EvalKey.at_level`` and the galois stacks via
``KeySet.galois_stacked`` — and every staging transfer is reported to
:func:`repro_torch.core.const_cache.record_stage`, so the serve layer's
zero-steady-state-uploads gate reads the same counter as every other check.
Residency stages onto the device the tenant's keys were generated on.

Residency is LRU-bounded (``max_resident`` tenants); evicting a tenant drops
its device-resident evk slices/stacks (the host-side key material stays
registered, so re-admission just re-stages).  A per-step **upload budget**
caps how many staging transfers admission may trigger in one engine step —
the thrash guard: when a step's budget is spent, requests from non-resident
tenants wait in the queue rather than evicting a hot tenant's keys.
"""
from __future__ import annotations

import collections

from repro_torch.core import const_cache
from repro_torch.core import poly as pl
from repro_torch.core.keys import KeySet
from repro_torch.runtime.faults import FaultError


class UnknownTenant(KeyError):
    pass


class TenantDegraded(KeyError):
    """The tenant's evaluation keys could not be staged (upload faulted and
    the one bounded retry faulted too).  Key-consuming requests from this
    tenant are rejected until :meth:`TenantKeyStore.heal` — other tenants
    are unaffected, and no resident tenant was evicted for the failed
    upload."""


class TenantKeyStore:
    def __init__(self, max_resident: int = 8,
                 step_upload_budget: int | None = None):
        assert max_resident >= 1
        self.max_resident = max_resident
        self.step_upload_budget = step_upload_budget
        self._registered: dict[str, KeySet] = {}
        self._resident: collections.OrderedDict[str, int] = \
            collections.OrderedDict()          # tenant → staged buffer count
        self.uploads = 0                       # total staging transfers
        self.evictions = 0
        self._step_uploads = 0
        self.degraded: set[str] = set()        # tenants with failed staging
        self.staging_retries = 0               # upload faults absorbed
        self.degrade_events = 0                # tenants marked degraded
        # per-tenant fault history: {"staging_retries": n, "degrade_events": n}
        self.tenant_faults: dict[str, dict] = {}
        self._metrics = None                   # attached ServeMetrics (opt.)

    def attach_metrics(self, metrics) -> None:
        """Link a :class:`~repro_torch.serve.metrics.ServeMetrics` so per-tenant
        staging-fault history lands in the serving metrics and
        :meth:`heal` can clear it (a healed tenant must not inherit stale
        fault-pressure accounting)."""
        self._metrics = metrics

    def _record_tenant_fault(self, tenant: str, kind: str) -> None:
        hist = self.tenant_faults.setdefault(
            tenant, {"staging_retries": 0, "degrade_events": 0})
        hist[kind] += 1
        if self._metrics is not None:
            self._metrics.record_tenant(tenant, **{kind: 1})

    # -- registration ---------------------------------------------------------

    def register(self, tenant: str, keyset: KeySet) -> None:
        self._registered[tenant] = keyset

    def keyset(self, tenant: str) -> KeySet:
        """The registered key material WITHOUT touching residency (metadata
        reads: params, available rotations)."""
        try:
            return self._registered[tenant]
        except KeyError:
            raise UnknownTenant(tenant) from None

    def tenants(self) -> list[str]:
        return list(self._registered)

    def is_resident(self, tenant: str) -> bool:
        return tenant in self._resident

    # -- residency / staging --------------------------------------------------

    def begin_step(self) -> None:
        """Reset the per-step upload budget (called once per engine step)."""
        self._step_uploads = 0

    def can_admit(self, tenant: str) -> bool:
        """True if serving this tenant now fits the step's upload budget."""
        if tenant in self._resident:
            return True
        if self.step_upload_budget is None:
            return True
        return self._step_uploads < self.step_upload_budget

    def acquire(self, tenant: str) -> KeySet:
        """The tenant's KeySet, staged and LRU-touched.

        First acquisition (or first after eviction) stages the evk material
        and counts the transfers; steady-state acquisitions are free.
        """
        ks = self.keyset(tenant)
        if tenant in self.degraded:
            raise TenantDegraded(tenant)
        if tenant in self._resident:
            self._resident.move_to_end(tenant)
            return ks
        n = self._stage_with_retry(tenant, ks)
        # residency / budgets / eviction mutate ONLY after staging succeeded:
        # a failed upload must never evict a healthy resident tenant.
        self.uploads += n
        self._step_uploads += n
        self._resident[tenant] = n
        while len(self._resident) > self.max_resident:
            victim, _ = self._resident.popitem(last=False)
            self._registered[victim].drop_device_caches()
            self.evictions += 1
        return ks

    def _stage_with_retry(self, tenant: str, ks: KeySet) -> int:
        """One staging attempt plus one bounded retry on a transient fault.

        A first fault drops the half-staged device forms and retries from a
        clean slate; a second marks the tenant degraded (non-fatal to the
        engine — the serving layer rejects only this tenant's key-consuming
        work until :meth:`heal`)."""
        try:
            n = self._stage(ks)
            const_cache.record_stage(n)
            return n
        except FaultError:
            self.staging_retries += 1
            self._record_tenant_fault(tenant, "staging_retries")
            ks.drop_device_caches()
            try:
                n = self._stage(ks)
                const_cache.record_stage(n)
                return n
            except FaultError as e:
                ks.drop_device_caches()
                self.degraded.add(tenant)
                self.degrade_events += 1
                self._record_tenant_fault(tenant, "degrade_events")
                raise TenantDegraded(tenant) from e

    def is_degraded(self, tenant: str) -> bool:
        return tenant in self.degraded

    def heal(self, tenant: str) -> None:
        """Clear the degraded mark AND the tenant's fault history; the next
        acquire re-attempts staging.

        Healing is an operator statement that the fault condition is gone
        (key material replaced, link repaired), so the tenant's
        retry/backoff accounting resets with it — in both the keystore's
        per-tenant history and any attached
        :class:`~repro_torch.serve.metrics.ServeMetrics` — instead of leaving
        stale fault pressure that would bias future overload/debugging
        decisions against a now-healthy tenant."""
        self.degraded.discard(tenant)
        self.tenant_faults.pop(tenant, None)
        if self._metrics is not None:
            self._metrics.reset_tenant(tenant)

    def _stage(self, ks: KeySet) -> int:
        """Warm the device-resident evk forms used by the serving hot path:
        the full-rotation-set galois stack and the relin key's top-level
        slice.  Returns the number of staging transfers performed."""
        params = ks.params
        ell = params.L
        idx = tuple(range(ell)) + tuple(params.L + k for k in range(params.K))
        basis = params.q[:ell] + params.p
        ndig = len(params.digit_bases(ell))
        n = 0
        gelts = tuple(sorted(ks.galois))
        if gelts:
            ks.galois_stacked(gelts, idx, basis, ndig)
            # one stacked (A, B) pair per rotation key
            n += 2 * len(gelts)
        ks.relin.at_level(idx, basis, ndig)
        n += 2 * ndig                          # (a_j, b_j) per digit
        return n

    # -- crash-safe serving (repro_torch.serve.recovery) ----------------------------

    def state_dict(self) -> dict:
        """Residency order, degradation state, and fault accounting.  Key
        material itself is NOT serialized — tenants re-register their keys
        with the recovered process (the host-side registry is the source
        of truth; device-resident forms are gone after a crash anyway)."""
        return {
            "resident": list(self._resident),       # LRU order, oldest first
            "degraded": sorted(self.degraded),
            "uploads": self.uploads,
            "evictions": self.evictions,
            "staging_retries": self.staging_retries,
            "degrade_events": self.degrade_events,
            "tenant_faults": {t: dict(h)
                              for t, h in self.tenant_faults.items()},
        }

    def load_state(self, state: dict, restage: bool = True) -> None:
        """Restore accounting + degradation, then re-stage the previously
        resident tenants in LRU order (their device-side evk forms died
        with the crashed process).  Re-staging transfers count as fresh
        uploads — they ARE fresh uploads."""
        self.degraded = set(state["degraded"])
        self.uploads = state["uploads"]
        self.evictions = state["evictions"]
        self.staging_retries = state["staging_retries"]
        self.degrade_events = state["degrade_events"]
        self.tenant_faults = {t: dict(h)
                              for t, h in state["tenant_faults"].items()}
        if restage:
            for tenant in state["resident"]:
                if tenant in self._registered and tenant not in self.degraded:
                    self.acquire(tenant)

    # -- convenience ----------------------------------------------------------

    def galois_elements(self, tenant: str) -> set[int]:
        return set(self.keyset(tenant).galois)

    def supports_rotation(self, tenant: str, r: int) -> bool:
        ks = self.keyset(tenant)
        N = ks.params.N
        return r % (N // 2) == 0 or pl.galois_elt(r, N) in ks.galois

    def supports_conjugate(self, tenant: str) -> bool:
        ks = self.keyset(tenant)
        return 2 * ks.params.N - 1 in ks.galois
