"""The port's FHE examples (``examples/torch/``) run at their own parameters
and held to the JAX package's record, ``tests/torch_examples_ref.json``
(written by ``tests/make_torch_examples_ref.py``).

:func:`port_record` runs one example on a device and engine and returns a
record in the recorder's terms; :func:`compare` holds it to the JAX one and
returns ``{check: bool}``.  ``tests/test_torch_examples.py`` (the CPU) and
``chip_smoke.py`` (the card, and that machine's CPU for the bootstrap) both
use them.  This module imports the port only inside its functions, and never
JAX.

What is held equal, per example:

* every ciphertext the example decrypts (SHA-256 of the u32 bytes of a then
  b, scale, basis, level, domain), in order, and every decoded value;
* the HE-op counts, and for HELR and the bootstrap the whole op trace;
* HELR: the decrypted weights, the accuracy, the weights' level;
* the bootstrap: its error and level;
* the serving demo: no constant upload and no plan build in the steady
  state, as in the JAX run, and the traced wave's ``span_summary()`` with
  its launch counts left out (the port's plain versions on the CPU launch
  nothing, its kernels on the card launch what the fused path needs; the
  JAX package counts its interpret-mode launches);
* the distributed demo: the port's own byte counts, pinned in
  :data:`PORT_TRAFFIC`, and their relation to the JAX demo's (see
  :func:`traffic_relation`).
"""
from __future__ import annotations

import functools
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "tests" / "torch_examples_ref.json"
EXAMPLES = ROOT / "examples" / "torch"
MODULES = {"quickstart": "quickstart", "helr": "helr_training",
           "bootstrapping": "bootstrapping_demo", "serving": "serving_demo",
           "distributed": "distributed_mapping_demo", "lm": "lm_train_demo"}
#: example → the engines it is held on
ENGINES = {"quickstart": ("fused", "eager"), "helr": ("fused", "eager"),
           "bootstrapping": ("fused",), "serving": ("fused",),
           "distributed": ("fused",)}
#: the port's bytes between distinct blocks in the distributed demo
#: (``_dist_selftest.run_traffic(8, 12, 48, 2048)``, map 4x2-BK-1x2)
PORT_TRAFFIC = {"bconv_ark": 368640, "bconv_limbdup": 294912,
                "ntt_baseline": 131072, "ntt_fourstep": 65536}


def reference() -> dict:
    return json.loads(REF.read_text())["examples"]


@functools.lru_cache(maxsize=None)
def load(part: str):
    """The example's module, imported from ``examples/torch`` by path."""
    name = MODULES[part]
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def ct_record(ct) -> dict:
    """SHA-256 of the u32 bytes of a, then b, with scale, basis, level and
    domain (as the recorder's)."""
    from repro_torch.core import poly as pl
    h = hashlib.sha256()
    for x in (ct.a.data, ct.b.data):
        h.update(pl.to_numpy(x).tobytes())
    return {"sha256": h.hexdigest(), "scale": float(ct.scale),
            "basis": [int(q) for q in ct.basis], "level": int(ct.level),
            "domain": ct.a.domain}


def pairs(z) -> list:
    z = np.asarray(z, dtype=np.complex128).ravel()
    return [[float(v.real), float(v.imag)] for v in z]


def trace_record(t) -> dict:
    return {"counts": sorted([f, int(ell), int(n), int(c)]
                             for (f, ell, n), c in t.counts.items()),
            "calls": dict(sorted(t.calls.items())),
            "he_ops": dict(sorted(t.he_ops.items()))}


def without_launches(summary: dict) -> dict:
    """A ``span_summary()`` with its launch counts left out: the total and
    each span's."""
    s = json.loads(json.dumps(summary, sort_keys=True))
    s.pop("launches", None)
    for span in s["spans"].values():
        span.pop("launches", None)
    return s


def port_record(part: str, device, engine: str = "fused", out_dir=None) -> dict:
    """Run the example at its own parameters on ``device`` (``engine`` for
    the examples held on both engines, :data:`ENGINES`); its record."""
    mod = load(part)
    if part == "quickstart":
        checked, tr = mod.run_quickstart(device, engine)
        return {"decrypted": [ct_record(c) for _, c, _, _ in checked],
                "decoded": [pairs(got) for _, _, got, _ in checked],
                "he_ops": dict(sorted(tr.he_ops.items()))}
    if part == "helr":
        cfg = mod.PRESETS["example"]
        p = cfg["params"]()
        run = mod.run_helr(p, cfg["features"], cfg["batch"], cfg["iters"],
                           device=device, engine=engine)
        return {"decrypted": [ct_record(c) for c in run.ct_w],
                "decoded": [pairs(d) for d in run.decoded],
                "he_ops": dict(sorted(run.trace.he_ops.items())),
                "trace": trace_record(run.trace),
                "w_dec": [float(w) for w in run.w_dec], "acc": run.acc,
                "weight_level": min(c.level for c in run.ct_w), "run": run}
    if part == "bootstrapping":
        out, got, err, tr, seconds = mod.run_bootstrap_demo(device)
        return {"decrypted": [ct_record(out)], "decoded": [pairs(got)],
                "max_error": err,
                "level": out.level, "he_ops": dict(sorted(tr.he_ops.items())),
                "trace": trace_record(tr), "seconds": seconds}
    if part == "serving":
        res = mod.run_serving_demo(device, out_dir)
        return {"decrypted": [ct_record(c) for c in res["outputs"]],
                "decoded": [pairs(z) for z in res["decoded"]],
                "uploads": res["uploads"], "plan_builds": res["plan_builds"],
                "span_summary": res["span_summary"],
                "served": len(res["outputs"])}
    if part == "distributed":
        return mod.run_distributed_demo(device)
    raise ValueError(part)


def traffic_relation(port: dict, jax: dict, shards: int = 8) -> dict:
    """How the port's byte counts follow from the JAX demo's.

    The JAX demo sums, for ONE device, each compiled collective's wire bytes
    ((g − 1)/g of an all-to-all's operand, of an all-gather's output).  Its
    two BConv programs also hold two all-gathers that XLA inserts around the
    q̂⁻¹ pre-scale, which runs outside the shard_map on the sharded input:
    the whole (ℓ, N) input to every device, ``prescale`` bytes per device.
    The port sums the words every block sends to other blocks, over all
    ``shards`` blocks, and pre-scales inside the BConv kernel on local
    limbs.  So each port count is ``shards`` × (the JAX count, less the
    pre-scale gathers for BConv)."""
    ell, N = jax["ell"], jax["N"]
    prescale = ell * N * 4 * (shards - 1) // shards
    want = {"bconv_ark": shards * (jax["bconv_ark"]["total"] - prescale),
            "bconv_limbdup": shards * (jax["bconv_limbdup"]["total"] - prescale),
            "ntt_baseline": shards * jax["ntt_baseline"]["total"],
            "ntt_fourstep": shards * jax["ntt_fourstep"]["total"]}
    return {k: port[k]["total"] == want[k] for k in want}


def compare(part: str, got: dict, want: dict) -> dict:
    """{check: bool} of the port's record against the JAX one."""
    if part == "distributed":
        t, j = got["traffic"], want["traffic"]
        checks = {f"port_{k}": t[k]["total"] == v for k, v in PORT_TRAFFIC.items()}
        checks.update({f"jax_relation_{k}": v
                       for k, v in traffic_relation(t, j).items()})
        checks["correctness"] = got["correctness"]["ok"] and want["correctness"]["ok"]
        checks["same_map"] = (t["map"], t["ntt_ell"], t["eq3_beneficial"]) == (
            j["map"], j["ntt_ell"], j["eq3_beneficial"])
        return checks
    checks = {"decrypted": got["decrypted"] == want["decrypted"]}
    if "decoded" in got:
        checks["decoded"] = got["decoded"] == want["decoded"]
    checks["he_ops"] = got["he_ops"] == want["he_ops"] if "he_ops" in got else True
    for key in ("trace", "w_dec", "acc", "weight_level", "max_error", "level",
                "uploads", "plan_builds", "served"):
        if key in want and key in got:
            checks[key] = got[key] == want[key]
    if part == "serving":
        checks["span_summary"] = (without_launches(got["span_summary"])
                                  == without_launches(want["span_summary"]))
    return checks
