"""FHE dry-run: paper-scale CKKS key-switching (the paper's dominant op) on
the CiFHER cluster meshes, executed (the port of ``repro.launch.dryrun_fhe``).

    python -m repro_torch.launch.dryrun_fhe [--mesh pod|multipod] \\
        [--policy ark|limbdup] [--ell 48] [--limb-clusters 4] \\
        [--device cuda|cpu] [--out experiments/dryrun_fhe]

One cell is hybrid key-switching at N = 2¹⁶, ℓ = 48, K = 12, dnum = 4 (paper
Table I) of a batch — one polynomial on the single-pod mesh, two on the
multi-pod one, one per pod — under one BConv mapping policy (ARK
redistribution or limb duplication, ``bconv.mapping_scope``) on 256 cores,
``limb_clusters`` limb clusters of 256 / ``limb_clusters`` cores each (the
default 4 is 16x16-BK-8x8).  The reference compiles the cell for XLA's
forced host devices; the port runs it on the card (``--device cpu`` for the
CPU): every BConv executes on the mesh's logical shards through the mesh's
collectives, the rest of the key-switch (NTT, EFU, the evk product) stays
global on the device.  The record keeps the reference's keys (``collectives``
are the bytes the mesh moved between blocks, per kind) and adds the
executed collectives against ``cost_model.predict_collectives``, those
bytes against ``cost_model.nop_traffic``'s BConv term, the collectives each
pod's mesh ran (equal for every pod: none crosses "pod"), the launches per
kernel, the outputs' digests and their equality with the plain
single-device key-switch's on the same device, and the warm milliseconds
(host clock ending in a sync, median of ``warm_reps``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import bconv as bc
from repro_torch.core import ckks
from repro_torch.core import cost_model
from repro_torch.core import distributed as D
from repro_torch.core import params as prm
from repro_torch.core import poly as pl
from repro_torch.core import trace
from repro_torch.core.keys import EvalKey
from repro_torch.kernels import config as kcfg
from repro_torch.launch import require_device
from repro_torch.launch.mesh import PodMesh, make_fhe_mesh

#: the reference's core count per pod (its 512 forced devices over two pods)
N_CORES = 256

POLICIES = {"ark": D.ARK_POLICY, "limbdup": D.LIMBDUP_POLICY}


def ks_inputs(params: prm.CkksParams, ell: int, batch: int, seed: int = 0):
    """Seeded numpy inputs of a cell: ``d`` (batch, ℓ, N) NTT-domain residues
    over Q_ℓ and the evk halves ``a``, ``b`` (digits, L + K, N) over Q ∪ P,
    each residue uniform below its prime."""
    rng = np.random.default_rng(seed)
    ndig = len(params.digit_bases(ell))
    ext = params.q + params.p

    def residues(basis, lead):
        q = np.array(basis, dtype=np.int64)[:, None]
        return (rng.integers(0, 2**62, size=(*lead, len(basis), params.N),
                             dtype=np.int64) % q).astype(np.uint32)
    return residues(params.q[:ell], (batch,)), residues(ext, (ndig,)), residues(ext, (ndig,))


def digest(t) -> str:
    """SHA-256 of a residue tensor's u32 bits, shape and dtype bound (the
    reference's ``_dist_selftest.digest``)."""
    a = np.ascontiguousarray(pl.to_numpy(t) if isinstance(t, torch.Tensor) else t)
    h = hashlib.sha256()
    h.update(str((a.shape, a.dtype.str)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def build_ks_fn(params: prm.CkksParams, ell: int, mesh, policy):
    """The batched key-switch over explicit evk arrays, one batch member per
    pod: ``fn(d, a, b)`` with per-pod lists of device tensors (d (ℓ, N); a, b
    (digits, L + K, N)) → [(ka, kb)] per pod.  ``policy`` None: the plain
    single-device key-switch (the yardstick)."""
    basis_q = params.q[:ell]
    basis_ext = params.q + params.p
    meshes = mesh.pods if isinstance(mesh, PodMesh) else [mesh]
    keys: dict = {}     # one EvalKey per evk pair, so its level slices persist

    def evk_of(a_stk, b_stk) -> EvalKey:
        k = (id(a_stk), id(b_stk))
        if k not in keys:
            keys[k] = (a_stk, b_stk, EvalKey(
                seed=0, basis=basis_ext,
                b=[pl.RnsPoly(b_stk[j], basis_ext, pl.NTT) for j in range(b_stk.shape[0])],
                _a_cache=[pl.RnsPoly(a_stk[j], basis_ext, pl.NTT)
                          for j in range(a_stk.shape[0])]))
        return keys[k][2]

    def fn(d_data, evk_a, evk_b):
        outs = []
        for m, d_one, a_stk, b_stk in zip(meshes, d_data, evk_a, evk_b):
            d = pl.RnsPoly(d_one, basis_q, pl.NTT)
            evk = evk_of(a_stk, b_stk)
            if policy is None:
                ka, kb = ckks.key_switch(d, evk, params)
            else:
                with bc.mapping_scope(m, policy):
                    ka, kb = ckks.key_switch(d, evk, params)
            outs.append((ka.data, kb.data))
        return outs
    return fn


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_cell(mesh_kind: str, policy_name: str, ell: int, limb_clusters: int = 4,
             device="cuda", params: prm.CkksParams | None = None,
             n_cores: int = N_CORES, devices=None, warm_reps: int = 3) -> dict:
    """One cell on ``device`` (or, multi-pod, one pod per entry of
    ``devices``), executed: the record described in the module docstring.
    ``ok`` is true only if the key-switch ran, its outputs equal the plain
    single-device key-switch's, its executed collectives equal the
    prediction, its bytes the closed form, and every pod ran the same
    collectives; else ``error`` names what failed."""
    params = params or prm.paper_full()
    require_device(device)
    multi = mesh_kind == "multipod"
    mesh = make_fhe_mesh(multi_pod=multi, limb_clusters=limb_clusters,
                         n_cores=n_cores, device=device, devices=devices)
    meshes = mesh.pods if multi else [mesh]
    batch = len(meshes)
    policy = POLICIES[policy_name]
    cm = D.mesh_cluster_map(meshes[0])
    rec = {"cell": "cifher_ks", "mesh": mesh_kind, "policy": policy_name,
           "ell": ell, "N": params.N, "dnum": params.dnum,
           "limb_clusters": limb_clusters, "batch": batch,
           "cluster_map": cm.name, "device": str(meshes[0].device)}
    try:
        d_np, a_np, b_np = ks_inputs(params, ell, batch)
        devs = [m.device for m in meshes]
        d = [pl.to_tensor(d_np[i], dev) for i, dev in enumerate(devs)]
        a = [pl.to_tensor(a_np, dev) for dev in devs]
        b = [pl.to_tensor(b_np, dev) for dev in devs]
        want = build_ks_fn(params, ell, mesh, None)(d, a, b)
        fn = build_ks_fn(params, ell, mesh, policy)
        snaps = [m.snapshot() for m in meshes]
        pred0 = kcfg.collective_counts()
        kcfg.reset_launches()
        _sync(devs)
        for dev in devs:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
        base = [torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
                for dev in devs]
        with trace.trace_ops() as t:
            outs = fn(d, a, b)
        _sync(devs)
        launches = kcfg.kernel_launch_counts()
        executed, moved, by_pod = {}, {}, []
        for m, snap in zip(meshes, snaps):
            c, by = m.since(snap)
            by_pod.append(c)
            for k, v in c.items():
                executed[k] = executed.get(k, 0) + v
            for k, v in by.items():
                moved[k] = moved.get(k, 0) + v
        predicted = {k: n - pred0.get(k, 0)
                     for k, n in kcfg.collective_counts().items() if n - pred0.get(k, 0)}
        rec["executed"] = executed
        rec["predicted"] = predicted
        rec["collectives_match"] = executed == predicted
        rec["collectives"] = {k.replace("_", "-"): float(v) for k, v in moved.items()}
        rec["collectives"]["total"] = float(sum(moved.values()))
        rec["bconv_bytes_closed_form"] = cost_model.nop_traffic(
            t, cm, limb_dup=policy.limb_dup)["bconv"]
        rec["bytes_match"] = rec["collectives"]["total"] == rec["bconv_bytes_closed_form"]
        # each pod's mesh ran its own member's exchanges, the same for all
        rec["executed_by_pod"] = by_pod
        rec["launches"] = launches
        rec["digests"] = [[digest(ka), digest(kb)] for ka, kb in outs]
        rec["equal_to_single_device"] = all(
            torch.equal(x, y) for pair, ref in zip(outs, want) for x, y in zip(pair, ref))
        arg = sum(x.numel() * x.element_size() for x in d + a + b)
        out_b = sum(x.numel() * x.element_size() for pair in outs for x in pair)
        rec["memory"] = {
            "argument_bytes": arg, "output_bytes": out_b,
            "temp_bytes": (max(torch.cuda.max_memory_allocated(dev) - b0
                               for dev, b0 in zip(devs, base)) - out_b // batch
                           if devs[0].type == "cuda" else None),
            "code_bytes": 0}
        times = []
        for _ in range(warm_reps):
            t0 = time.perf_counter()
            fn(d, a, b)
            _sync(devs)
            times.append((time.perf_counter() - t0) * 1e3)
        rec["warm_ms"] = float(np.median(times)) if times else None
        failed = [k for k, good in (
            ("collectives_match", rec["collectives_match"]),
            ("bytes_match", rec["bytes_match"]),
            ("equal_to_single_device", rec["equal_to_single_device"]),
            ("executed_by_pod", all(c == by_pod[0] for c in by_pod))) if not good]
        rec["ok"] = not failed
        if failed:
            rec["error"] = f"check failed: {', '.join(failed)}"
    except Exception as e:  # a failure here is a bug in the system
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--policy", default="limbdup", choices=["ark", "limbdup"])
    ap.add_argument("--ell", type=int, default=48)
    ap.add_argument("--limb-clusters", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="experiments/dryrun_fhe")
    args = ap.parse_args()
    rec = run_cell(args.mesh, args.policy, args.ell, args.limb_clusters, args.device)
    os.makedirs(args.out, exist_ok=True)
    name = (f"ks__{args.mesh}__{args.policy}__l{args.ell}"
            f"__lc{args.limb_clusters}.json")
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(rec, f, indent=1)
    if rec.get("ok"):
        print(f"OK fhe-ks {args.mesh} {args.policy} ell={args.ell} "
              f"lc={args.limb_clusters} on {rec['device']}: "
              f"executed={rec['executed']} predicted={rec['predicted']} "
              f"coll={rec['collectives']['total']/2**20:.1f}MiB "
              f"(closed form {rec['bconv_bytes_closed_form']/2**20:.1f}MiB) "
              f"warm={rec['warm_ms']:.2f}ms")
    else:
        print(f"FAIL fhe-ks: {rec.get('error')}")
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
