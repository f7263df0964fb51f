"""Record the JAX package's LM families for ``tests/test_torch_lm_families.py``.

    PYTHONPATH=src python tests/make_torch_lm_families_ref.py   # ~1 min on a CPU

For each case of ``tests/torch_lm_families.py`` (reduced, float32, the
parameters made by ``numpy_tree`` from a seed in the tree layout of
``jax.eval_shape(init_params)``): forward logits and aux, ``loss_fn``,
``prefill``, and 12 ``decode_step`` logits (seamless after ``start_decode``);
per arch the parameter dtypes of the same config in bfloat16, two train
steps' loss, grad norm and lr, the served tokens of the LM decode engine,
and for two archs the int8 compression of seeded gradients (two rounds, the
residual carried: SHA-256 of each layer's int8 values and residual, each
leaf's scale).  Also ``gla_reference`` on seeded inputs, and the
activations the families use (``jax.nn.gelu``'s default, ``softplus``,
``log_sigmoid``) on a grid.  Everything goes
into ``tests/torch_lm_families_ref.npz`` (arrays, and a JSON string under
``meta``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch_lm_families as F  # noqa: E402


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a)).tobytes()).hexdigest()[:16]


def spec_of(jax, mod, cfg) -> list:
    shapes = jax.eval_shape(lambda: mod.init_params(jax.random.PRNGKey(0), cfg))
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [str(k.key) if hasattr(k, "key") else str(k.idx) for k in path]
        out.append((keys, list(leaf.shape), str(leaf.dtype)))
    return out


def main() -> int:
    import jax
    import jax.numpy as jnp
    from repro import optim as jopt
    from repro.data import TokenPipeline
    from repro.models import gla as jgla, registry as JR
    from repro.serve import ServeEngine
    from repro.serve.engine import Request
    from repro.train import TrainStepConfig, make_train_step

    jax.config.update("jax_enable_x64", False)
    arrays, meta = {}, {"specs": {}, "bf16_dtypes": {}, "aux": {}, "loss": {},
                        "train": {}, "serve": {}, "compress": {}}
    for case in F.CASES:
        cfg = F.config(case, JR)
        mod = JR.get_module(cfg)
        spec = spec_of(jax, mod, cfg)
        meta["specs"][case] = spec
        params = jax.tree.map(jnp.asarray, F.numpy_tree(spec, F.stable_seed(case, "params")))
        x = F.inputs(case, cfg)
        batch = {"tokens": jnp.asarray(x["tokens"]), "labels": jnp.asarray(x["labels"])}
        if cfg.family == "audio":
            batch["prefix_embeds"] = jnp.asarray(x["frames"])
            fwd = jax.jit(lambda p, b: mod.forward(p, cfg, b["tokens"], b["prefix_embeds"]))
        else:
            fwd = jax.jit(lambda p, b: mod.forward(p, cfg, b["tokens"]))
        logits, aux = fwd(params, batch)
        arrays[f"{case}/forward"] = np.asarray(logits)
        meta["aux"][case] = float(aux)
        meta["loss"][case] = float(jax.jit(lambda p, b: mod.loss_fn(p, cfg, b))(params, batch))
        if cfg.family != "audio":
            arrays[f"{case}/prefill"] = np.asarray(
                jax.jit(lambda p, t: mod.prefill(p, cfg, t))(params, batch["tokens"]))
        cache = mod.init_cache(cfg, F.B, F.S)
        if cfg.family == "audio":
            cache = jax.jit(lambda p, f, c: mod.start_decode(p, cfg, f, c))(
                params, batch["prefix_embeds"], cache)
        dec = jax.jit(lambda p, t, c, pos: mod.decode_step(p, cfg, t, c, pos))
        steps = []
        for t in range(F.DECODE):
            lg, cache = dec(params, batch["tokens"][:, t:t + 1], cache, jnp.int32(t))
            steps.append(np.asarray(lg)[:, 0])
        arrays[f"{case}/decode"] = np.stack(steps, axis=1)
        print(f"recorded {case}", flush=True)

    for arch in F.ARCHS:
        cfg = F.config(arch, JR)
        mod = JR.get_module(cfg)
        bf16 = dataclasses.replace(cfg, dtype="bfloat16")
        meta["bf16_dtypes"][arch] = {".".join(p): d for p, _, d in spec_of(jax, mod, bf16)}
        spec = meta["specs"][arch]
        params = jax.tree.map(jnp.asarray, F.numpy_tree(spec, F.stable_seed(arch, "params")))
        tcfg = TrainStepConfig(base_lr=F.TRAIN["base_lr"],
                               warmup_steps=F.TRAIN["warmup_steps"],
                               total_steps=F.TRAIN["steps"])
        step_fn = jax.jit(make_train_step(lambda p, b: mod.loss_fn(p, cfg, b), tcfg))
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=F.TRAIN["seq"],
                             global_batch=F.TRAIN["batch"], seed=F.SEED)
        opt = jopt.adamw_init(params)
        rows = []
        for step in range(F.TRAIN["steps"]):
            b = {k: jnp.asarray(v) for k, v in pipe.batch_slice(step, 0, 1).items()}
            if cfg.family == "audio":
                b["prefix_embeds"] = jnp.asarray(F.train_frames(cfg, step))
            params, opt, _, m = step_fn(params, opt, (), b, jnp.int32(step))
            rows.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        meta["train"][arch] = rows

        if arch in F.SERVED:
            params = jax.tree.map(jnp.asarray,
                                  F.numpy_tree(spec, F.stable_seed(arch, "params")))
            eng = ServeEngine(cfg, params, batch_slots=F.SERVE["slots"],
                              max_seq=F.SERVE["max_seq"], eos_id=-1)
            reqs = [Request(rid=i, prompt=p, max_new_tokens=F.SERVE["new"])
                    for i, p in enumerate(F.prompts())]
            for r in reqs:
                eng.submit(r)
            eng.run_until_drained(max_iters=64)
            assert all(r.done for r in reqs)
            meta["serve"][arch] = [r.generated for r in reqs]

        if arch in F.COMPRESSED:
            grads = jax.tree.map(jnp.asarray, F.numpy_tree(
                spec, F.stable_seed(arch, "grads"), grads=True))
            res = jopt.residuals_init(grads)
            rounds = []
            for _ in range(2):
                q, scales, res = jopt.compress_grads_int8(grads, res)
                qs = F.port_leaves(spec, jax.tree.map(np.asarray, q))
                rs = F.port_leaves(spec, jax.tree.map(np.asarray, res))
                flat = jax.tree_util.tree_flatten_with_path(scales)[0]
                rounds.append({
                    "int8": {n: digest(a) for n, a in qs.items()},
                    "residual": {n: digest(a) for n, a in rs.items()},
                    "scale": {"/".join(str(k.key) if hasattr(k, "key") else str(k.idx)
                                       for k in path): float(s) for path, s in flat}})
            meta["compress"][arch] = rounds
        print(f"recorded {arch}: train, serve, compress", flush=True)

    x = F.activation_inputs()
    arrays["act/gelu"] = np.asarray(jax.nn.gelu(x))
    arrays["act/softplus"] = np.asarray(jax.nn.softplus(x))
    arrays["act/log_sigmoid"] = np.asarray(jax.nn.log_sigmoid(x))

    q, k, v, la = F.gla_inputs()
    y, state = jgla.gla_reference(*(jnp.asarray(a) for a in (q, k, v, la)))
    arrays["gla/y"], arrays["gla/state"] = np.asarray(y), np.asarray(state)

    np.savez(F.REF, meta=np.array(json.dumps(meta, sort_keys=True)),
             **{k: v.astype(np.float32) for k, v in arrays.items()})
    print(f"wrote {F.REF} ({F.REF.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
