"""Per-shape launch-config autotuner for the port's kernels, with a JSON cache.

The counterpart of the reference's ``repro.kernels.autotune``, with knobs that
the Hopper kernels really take:

* ``ntt``: ``R``, the paper's recomposition knob (the R×C four-step split),
  and ``cluster``, the CTAs of the thread-block cluster that holds one limb
  (``kernels/ntt/ops.py:cluster_ok`` says which sizes a split allows);
* ``automorphism``: ``rows_per_cta``, the rows of the single-permutation
  kernel's CTA that share one read of the index vector;
* ``eltwise``, ``bconv``, ``auto_ks``: fixed launches today, so a one-entry
  grid (the CLI still times them).

:func:`candidates` enumerates a deterministic sweep grid per (family, N, ℓ),
every entry valid for the shape; :func:`autotune` times each candidate on the
device (CUDA events on a card) and records the winner in a JSON cache keyed
``family/N=../L=../backend`` (path: ``REPRO_AUTOTUNE_CACHE``, else
``~/.cache/repro-cifher-torch/autotune.json``); :func:`best_config` is the
lookup every wrapper makes when its caller pins no knob — a cold cache gives
:data:`DEFAULTS`, and for ``ntt`` the balanced R = √N (the NTT wrapper then
takes its cluster size from ``ntt.ops.cluster_plan``).

CLI, on the card::

    PYTHONPATH=src python -m repro_torch.kernels.autotune \\
        --families ntt automorphism --N 65536 --L 48 --quick --out /tmp/at.json
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import ntt as nttm
from repro_torch.kernels import config as kconfig

CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
CACHE_VERSION = 1
SMEM_MAX = 232_448          # bytes of shared memory a CTA may opt into (H100)

# Cold-cache launch configs.  The NTT's R resolves to balanced_submodules(N)
# in best_config, its cluster size to ntt.ops.cluster_plan in the wrapper.
DEFAULTS: dict[str, dict] = {
    "ntt": {},
    "automorphism": {"rows_per_cta": 4},
    "eltwise": {},
    "bconv": {},
    "auto_ks": {},
}
FAMILIES = tuple(DEFAULTS)

_path_override: Path | None = None
_entries: dict | None = None
_memo: dict = {}


def cache_path() -> Path:
    """set_cache_path() > $REPRO_AUTOTUNE_CACHE > ~/.cache/repro-cifher-torch."""
    if _path_override is not None:
        return _path_override
    env = os.environ.get(CACHE_ENV)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro-cifher-torch" / "autotune.json"


def set_cache_path(path: Path | str | None) -> None:
    """Point the cache at ``path`` (None restores the default chain) and drop
    every loaded entry and memoized lookup."""
    global _path_override, _entries
    _path_override = Path(path) if path is not None else None
    _entries = None
    _memo.clear()


def _load() -> dict:
    global _entries
    if _entries is None:
        _entries = {}
        p = cache_path()
        if p.exists():
            try:
                _entries = dict(json.loads(p.read_text()).get("entries", {}))
            except (json.JSONDecodeError, OSError):
                _entries = {}
    return _entries


def save() -> Path:
    """Write the entries to :func:`cache_path`."""
    p = cache_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    entries = _load()
    doc = {"version": CACHE_VERSION, "entries": {k: entries[k] for k in sorted(entries)}}
    p.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    return p


def cache_key(family: str, N: int, ell: int, backend: str | None = None) -> str:
    return f"{family}/N={N}/L={ell}/{backend or kconfig.backend()}"


def record(family: str, N: int, ell: int, entry: dict, *,
           backend: str | None = None, persist: bool = True) -> str:
    """Store a tuned entry ({"config": ..., "us": ..., ...})."""
    key = cache_key(family, N, ell, backend)
    _load()[key] = entry
    _memo.clear()
    if persist:
        save()
    return key


def entries() -> dict:
    return dict(_load())


def best_config(family: str, N: int, ell: int, backend: str | None = None) -> dict:
    """The launch config a wrapper uses when its caller pins nothing: the
    cached winner for (family, N, ℓ, backend), else :data:`DEFAULTS`; an
    ``ntt`` config always carries a valid R (√N when none is cached)."""
    if family not in DEFAULTS:
        raise ValueError(f"unknown kernel family {family!r} — one of {FAMILIES}")
    backend = backend or kconfig.backend()
    mk = (family, N, ell, backend)
    hit = _memo.get(mk)
    if hit is None:
        hit = dict(DEFAULTS[family])
        entry = _load().get(cache_key(family, N, ell, backend))
        if entry and isinstance(entry.get("config"), dict):
            hit.update(entry["config"])
        if family == "ntt" and not nttm.valid_submodules(N, hit.get("R")):
            hit["R"] = nttm.balanced_submodules(N)
        _memo[mk] = hit
    return dict(hit)


# ----------------------------------------------------------------------------
# Sweep grids (deterministic) and timed measurement
# ----------------------------------------------------------------------------

def _pow2s(lo: int, hi: int):
    v = 1
    while v < lo:
        v *= 2
    while v <= hi:
        yield v
        v *= 2


def _ntt_Rs(N: int) -> list[int]:
    base = nttm.balanced_submodules(N)
    lo, hi = max(2, base // 4), min(N // 2, base * 4)
    return [R for R in _pow2s(lo, hi) if N // R >= 2]


def candidates(family: str, N: int, ell: int) -> list[dict]:
    """The deterministic sweep grid for one (family, N, ℓ) shape: sorted by
    knob values, duplicate-free, every entry valid."""
    if family == "ntt":
        from repro_torch.kernels.ntt import ops as ntt_ops
        return [{"R": R, "cluster": c} for c in ntt_ops.CLUSTER_SIZES
                for R in _ntt_Rs(N) if ntt_ops.cluster_ok(N, R, c)]
    if family == "automorphism":
        return [{"rows_per_cta": w} for w in (1, 2, 4, 8, 16, 32)
                if w <= max(2 * ell, 1)]
    if family in DEFAULTS:
        return [{}]
    raise ValueError(f"unknown kernel family {family!r} — one of {FAMILIES}")


def _residues(basis, lead, N, seed, device):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, q, (*lead, N)) for q in basis], axis=-2)
    return torch.as_tensor(x.astype(np.int32), device=device)


def _build_runner(family: str, N: int, ell: int, device):
    """``run(cfg)``: one call of the family's wrapper with the candidate's
    knobs pinned, on operands made once from a seed."""
    from repro_torch.core import poly as pl, rns
    basis = tuple(rns.gen_ntt_primes(ell, N))
    if family == "ntt":
        from repro_torch.kernels.ntt import ops as ntt_ops
        x = _residues(basis, (2,), N, 0, device)
        return lambda cfg: ntt_ops.ntt_fwd(x, basis, R=cfg["R"],
                                           cluster=cfg["cluster"])
    if family == "automorphism":
        from repro_torch.kernels.automorphism import ops as auto_ops
        x = _residues(basis, (2,), N, 4, device)
        return lambda cfg: auto_ops.apply_galois(
            x, N, pl.galois_elt(1, N), rows_per_cta=cfg["rows_per_cta"])
    if family == "eltwise":
        from repro_torch.kernels.eltwise import ops as elt_ops
        a = _residues(basis, (2,), N, 2, device)
        b = _residues(basis, (2,), N, 3, device)
        return lambda cfg: elt_ops.eltwise("mac", basis, a, b, b, a)
    if family == "bconv":
        from repro_torch.kernels.bconv import ops as bconv_ops
        primes = rns.gen_ntt_primes(2 * ell, N)
        src, dst = tuple(primes[:ell]), tuple(primes[ell:])
        x = _residues(src, (4,), N, 1, device)
        return lambda cfg: bconv_ops.bconv(x, src, dst)
    if family == "auto_ks":
        from repro_torch.kernels.automorphism import ops as auto_ops
        J, R = 2, 4
        exts = _residues(basis, (J, 1), N, 5, device)
        evk_a = _residues(basis, (R, J), N, 6, device)
        evk_b = _residues(basis, (R, J), N, 7, device)
        gs = tuple(pl.galois_elt(r + 1, N) for r in range(R))
        return lambda cfg: auto_ops.auto_ks(exts, evk_a, evk_b, N, gs, basis)
    raise ValueError(f"unknown kernel family {family!r} — one of {FAMILIES}")


def measure(run, cfg: dict, reps: int = 3, device="cuda") -> float:
    """Median time (µs) of one ``run(cfg)`` after a warm-up call: CUDA events
    around each call on a card, the host clock on the CPU (where the call is
    synchronous)."""
    run(cfg)
    times = []
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(cfg)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            run(cfg)
            times.append((time.perf_counter() - t0) * 1e6)
    return float(statistics.median(times))


def autotune(family: str, N: int, ell: int, *, reps: int = 3,
             persist: bool = True, max_candidates: int | None = None,
             device="cuda") -> dict:
    """Time the (family, N, ℓ) grid on ``device`` and record the winner under
    that device's backend; ties go to the earlier candidate."""
    cands = candidates(family, N, ell)
    if max_candidates:
        cands = cands[:max_candidates]
    run = _build_runner(family, N, ell, device)
    timed = [(measure(run, cfg, reps, device), i, cfg) for i, cfg in enumerate(cands)]
    us, _, winner = min(timed, key=lambda t: (t[0], t[1]))
    backend = torch.device(device).type
    entry = {"config": winner, "us": us, "swept": len(cands), "reps": reps,
             "backend": backend,
             "sweep": [{"config": cfg, "us": t} for t, _, cfg in timed]}
    record(family, N, ell, entry, backend=backend, persist=persist)
    return entry


def sweep(families=FAMILIES, Ns=(65536,), ells=(48,), *, reps: int = 3,
          persist: bool = True, max_candidates: int | None = None,
          device="cuda") -> dict:
    """Autotune every (family, N, ℓ); returns {cache key: entry}."""
    out = {}
    backend = torch.device(device).type
    for family in families:
        for N in Ns:
            for ell in ells:
                entry = autotune(family, N, ell, reps=reps, persist=persist,
                                 max_candidates=max_candidates, device=device)
                key = cache_key(family, N, ell, backend)
                out[key] = entry
                print(f"autotune {key}: {entry['config']} ({entry['us']:.1f} us, "
                      f"{entry['swept']} candidates)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--families", nargs="+", default=list(FAMILIES),
                    choices=list(FAMILIES))
    ap.add_argument("--N", type=int, nargs="+", default=[65536])
    ap.add_argument("--L", type=int, nargs="+", default=[48])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="cap each sweep at 6 candidates")
    ap.add_argument("--out", type=Path, default=None,
                    help="config-cache path (default: env / cache-dir chain)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("autotune: no CUDA card (pass --device cpu to time "
                         "the plain versions)")
    if args.out is not None:
        set_cache_path(args.out)
    sweep(tuple(args.families), tuple(args.N), tuple(args.L), reps=args.reps,
          max_candidates=6 if args.quick else None, device=args.device)
    print(f"config cache -> {cache_path()} ({len(entries())} entries, "
          f"backend={torch.device(args.device).type})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
