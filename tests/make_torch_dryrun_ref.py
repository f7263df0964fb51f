"""Record the JAX package's dry-run spec layer and key-switch digests for
``tests/test_torch_dryrun.py``.

    PYTHONPATH=src python tests/make_torch_dryrun_ref.py   # ~1 min on a CPU

The spec layer runs in a subprocess with 512 forced XLA host devices (as
``tests/test_specs.py`` runs it).  For each of the ten archs: every
parameter leaf's shape, dtype and PartitionSpec in the layouts 2d,
replicated and fsdp_all on the (2, 4) ("data", "model") mesh, the (16, 16)
pod and the (2, 16, 16) ("pod", "data", "model") pair of pods; on the same
meshes the cache leaves' shapes, dtypes and specs for ``decode_32k``, and
``long_500k`` where the arch takes it, with ``seq_shard`` off and on; the
token and frontend specs of every shape; ``get_cell`` and
``shape_applicable``.  A spec is a list with one entry per dim: null, an
axis name, or a list of axis names.  Then, at ``make_params(N=256, L=8,
K=2, dnum=4)``, the SHA-256 digests of ``ckks.key_switch`` at ℓ = 8 on the
seeded inputs of ``repro_torch.launch.dryrun_fhe.ks_inputs``, for a batch
of one and of two.  Everything goes into ``tests/torch_dryrun_ref.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "torch_dryrun_ref.json"

MESHES = {"host": ((2, 4), ("data", "model")),
          "pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
LAYOUTS = {"2d": dict(fsdp=True, layout="2d"),
           "replicated": dict(fsdp=False, layout="2d"),
           "fsdp_all": dict(fsdp=True, layout="fsdp_all")}


def _spec(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def record_specs() -> dict:
    import jax
    from repro.launch import specs as S
    from repro.models import registry, sharding as shd
    from repro.models.config import SHAPES

    devs = np.array(jax.devices())
    assert devs.size == 512, "needs the 512 forced host devices"
    meshes = {k: jax.sharding.Mesh(devs[:int(np.prod(shape))].reshape(shape), names)
              for k, (shape, names) in MESHES.items()}

    def leaves(tree, shardings=None):
        out = {}
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        shd_flat = (jax.tree_util.tree_leaves(
            shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
            if shardings is not None else [None] * len(flat))
        for (path, leaf), s in zip(flat, shd_flat):
            entry = {"shape": list(leaf.shape), "dtype": str(leaf.dtype)}
            if s is not None:
                entry["spec"] = _spec(s.spec)
            out[shd._path_str(path)] = entry
        return out

    doc = {"meshes": {k: [list(s), list(n)] for k, (s, n) in MESHES.items()},
           "archs": {}, "cells": {}}
    for arch in registry.ARCHS:
        cfg = registry.get_config(arch)
        ps = S.param_shapes(cfg)
        rec = {"params": leaves(ps), "param_specs": {}, "cache": {},
               "tokens": {}, "frontend": {}}
        for mk, mesh in meshes.items():
            rec["param_specs"][mk] = {
                lk: {p: e["spec"] for p, e in leaves(
                    ps, S.param_shardings(cfg, mesh, ps, **kw)).items()}
                for lk, kw in LAYOUTS.items()}
            rec["cache"][mk] = {}
            for shape in ("decode_32k", "long_500k"):
                if not registry.shape_applicable(cfg, shape)[0]:
                    continue
                cell = S.get_cell(arch, shape)
                cshape = S.cache_shapes(cfg, cell.global_batch, cell.seq_len)
                rec["cache"][mk][shape] = {
                    str(seq): leaves(cshape, S.cache_shardings(
                        cfg, mesh, cshape, cell.global_batch, seq_shard=seq))
                    for seq in (False, True)}
            rec["tokens"][mk] = {}
            rec["frontend"][mk] = {}
            for shape, sh in SHAPES.items():
                sds, sh_ = S.token_specs(cfg, mesh, sh["global_batch"], sh["seq_len"])
                rec["tokens"][mk][shape] = {"shape": list(sds.shape),
                                            "spec": _spec(sh_.spec)}
                fe, fe_shd = S.frontend_specs(cfg, mesh, sh["global_batch"])
                rec["frontend"][mk][shape] = (None if fe is None else
                                              {"shape": list(fe.shape),
                                               "spec": _spec(fe_shd.spec)})
        doc["archs"][arch] = rec
        for shape in SHAPES:
            c = S.get_cell(arch, shape)
            ok, why = registry.shape_applicable(cfg, shape)
            doc["cells"][f"{arch}__{shape}"] = {
                "arch": c.arch, "shape": c.shape, "kind": c.kind, "seq_len": c.seq_len,
                "global_batch": c.global_batch, "name": c.name,
                "applicable": ok, "why": why}
    return doc


def record_key_switch() -> dict:
    import jax.numpy as jnp
    from repro.core import ckks, params as prm, poly as jpl
    from repro.core.keys import EvalKey
    from repro_torch.launch.dryrun_fhe import digest, ks_inputs

    p = prm.make_params(N=256, L=8, K=2, dnum=4)
    ell = 8
    ext = p.q + p.p
    out = {"params": "make_params(N=256, L=8, K=2, dnum=4)", "ell": ell}
    for batch in (1, 2):
        d, a, b = ks_inputs(p, ell, batch)
        digests = []
        for i in range(batch):
            evk = EvalKey(seed=0, basis=ext,
                          b=[jpl.RnsPoly(jnp.asarray(b[j]), ext, jpl.NTT)
                             for j in range(b.shape[0])],
                          _a_cache=[jpl.RnsPoly(jnp.asarray(a[j]), ext, jpl.NTT)
                                    for j in range(a.shape[0])])
            ka, kb = ckks.key_switch(jpl.RnsPoly(jnp.asarray(d[i]), p.q[:ell], jpl.NTT),
                                     evk, p)
            digests.append([digest(np.asarray(ka.data)), digest(np.asarray(kb.data))])
        out[f"batch{batch}"] = digests
    return out


def main() -> int:
    if "--child" in sys.argv:
        doc = record_specs()
        doc["key_switch"] = record_key_switch()
        print(json.dumps(doc))
        return 0
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, __file__, "--child"], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=1800)
    if proc.returncode:
        sys.stderr.write(proc.stderr[-4000:])
        return proc.returncode
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    OUT.write_text(json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n")
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
