"""The port's LM decoder (``repro_torch.models``, ``optim``, ``train``,
``serve.engine``) on the CPU, held to the JAX package's.

Reduced configs in float32; the parameters are the JAX package's
``init_params`` carried across by ``interop.lm_params_from_numpy``, and the
inputs come from seeded numpy generators, so both sides compute the same
thing.  Tolerances: logits, losses and decode/prefill logits within 1e-4
abs; per train step loss, grad norm and lr within 1e-4 relative, parameters
within 1e-6 abs on 99.9 % of entries and within 2·lr·steps everywhere
(Adam's update is ±lr wherever a gradient's sign is at the rounding
level); int8 compression equal; served tokens equal.

Three tests, each looping over its cases and naming every failing one
(a file of at most three tests joins the end of ``--dist loadfile``'s
queue).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import interop, optim
from repro_torch.data import TokenPipeline
from repro_torch.models import encdec, layers as L, registry, transformer as T
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import Request
from repro_torch.train import TrainStepConfig, make_train_step

ATOL = 1e-4
CPU = "cpu"


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread, as the other port test files at the end of the queue."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    jax = pytest.importorskip("jax")
    from repro.models import layers as JL, registry as JR, transformer as JT
    return jax, JL, JR, JT


def _port_model(jax, JT, cfg, seed=0):
    """(the JAX package's params, the port's model holding them)."""
    jparams = JT.init_params(jax.random.PRNGKey(seed), cfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, interop.lm_params_from_numpy(tree, cfg, CPU)


def _close(bad, label, got, want, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        bad[label] = f"shape {got.shape} vs {want.shape}"
    elif not np.allclose(got, want, rtol=0, atol=atol):
        bad[label] = float(np.max(np.abs(got - want)))


def test_models_equal_jax():
    """Forward logits, ``loss_fn``, a 12-token ``decode_step`` sequence and
    ``prefill``: reduced qwen3-4b; reduced llava-next-34b with
    ``prefix_embeds``; qwen3-4b with ``sliding_window=8`` (the decode cache's
    ring buffer wraps); the chunked online-softmax path
    (``set_chunked_threshold(8)``).  Also: the ten configs equal the JAX
    package's, full and reduced, and activation checkpointing gives the
    same gradients under each policy (full, dots, outs)."""
    jax, JL, JR, JT = _jax()
    import jax.numpy as jnp
    bad = {}
    for arch in registry.ARCHS:
        for full in (True, False):
            c = registry.get_config(arch)
            j = JR.get_config(arch)
            c, j = (c, j) if full else (c.reduced(), j.reduced())
            if dataclasses.asdict(c) != dataclasses.asdict(j):
                bad[f"config/{arch}/{'full' if full else 'reduced'}"] = "differs"
    if registry.all_cells() != JR.all_cells():
        bad["all_cells"] = "differs"

    qwen = registry.get_config("qwen3_4b").reduced()
    cases = {
        "qwen3_4b": (qwen, False),
        "llava_next_34b": (registry.get_config("llava_next_34b").reduced(), False),
        "qwen3_4b/window8": (dataclasses.replace(qwen, sliding_window=8), False),
        "qwen3_4b/chunked": (qwen, True),
    }
    B, S, STEPS = 2, 16, 12
    for name, (cfg, chunked) in cases.items():
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        labels[0, :3] = -1                              # masked labels
        prefix = (rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model))
                  .astype(np.float32) if cfg.frontend else None)
        jparams, model = _port_model(jax, JT, cfg)
        jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
        tbatch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
        if prefix is not None:
            jbatch["prefix_embeds"] = jnp.asarray(prefix)
            tbatch["prefix_embeds"] = torch.from_numpy(prefix)
        old = (JL.CHUNKED_THRESHOLD, L.CHUNKED_THRESHOLD)
        if chunked:
            JL.set_chunked_threshold(8)
            L.set_chunked_threshold(8)
        try:
            want_logits, want_loss, want_pre = jax.jit(lambda p, b: (
                JT.forward(p, cfg, b["tokens"], b.get("prefix_embeds"))[0],
                JT.loss_fn(p, cfg, b),
                JT.prefill(p, cfg, b["tokens"], b.get("prefix_embeds"))))(jparams, jbatch)
            with torch.no_grad():
                got_logits, _ = T.forward(model, cfg, tbatch["tokens"],
                                          tbatch.get("prefix_embeds"))
                got_loss = T.loss_fn(model, cfg, tbatch)
                got_pre = T.prefill(model, cfg, tbatch["tokens"],
                                    tbatch.get("prefix_embeds"))
        finally:
            JL.set_chunked_threshold(old[0])
            L.set_chunked_threshold(old[1])
        _close(bad, f"{name}/forward", got_logits, want_logits)
        _close(bad, f"{name}/loss", got_loss, want_loss)
        _close(bad, f"{name}/prefill", got_pre, want_pre)

        jdec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, cfg, t, c, pos))
        jcache = JT.init_cache(cfg, B, S)
        cache = T.init_cache(cfg, B, S, device=CPU)
        for t in range(STEPS):
            want, jcache = jdec(jparams, jnp.asarray(tokens[:, t:t + 1]), jcache,
                                jnp.int32(t))
            with torch.no_grad():
                got, cache = T.decode_step(model, cfg, torch.from_numpy(tokens[:, t:t + 1]),
                                           cache, t)
            _close(bad, f"{name}/decode[{t}]", got, want)
        for key in ("k", "v", "slot_pos"):
            _close(bad, f"{name}/cache/{key}", cache[key], jcache[key])
        if cfg.sliding_window and cache["k"].shape[2] != cfg.sliding_window:
            bad[f"{name}/ring"] = f"cache length {cache['k'].shape[2]}"

    # remat recomputes and gives the same gradients, under each of the
    # reference's policies
    _, model = _port_model(jax, JT, qwen)
    batch = {"tokens": torch.from_numpy(tokens[:, :8]),
             "labels": torch.from_numpy(labels[:, :8].clip(0))}
    grads = {}
    for policy in (None, "full", "dots", "outs"):
        c = dataclasses.replace(qwen, remat=policy is not None,
                                remat_policy=policy or "full")
        loss = T.loss_fn(model, c, batch)
        grads[policy] = torch.autograd.grad(loss, list(model.parameters()))
    for policy in ("full", "dots", "outs"):
        if not all(torch.allclose(a, b, rtol=0, atol=1e-6)
                   for a, b in zip(grads[policy], grads[None])):
            bad[f"remat/{policy}/grads"] = "differ"
    assert not bad, bad


def test_train_steps_equal_jax():
    """Three ``make_train_step`` steps on the same ``TokenPipeline``
    batches, plain, with ``microbatches=2`` and with ``compress_dp_grads``:
    loss, grad norm, lr and the parameters after each step; and
    ``compress_grads_int8`` on identical numpy gradients (twice, the
    residual carried)."""
    jax, JL, JR, JT = _jax()
    import jax.numpy as jnp
    from repro import optim as jopt
    from repro.data import TokenPipeline as JPipe
    from repro.train import TrainStepConfig as JCfg, make_train_step as jmake

    cfg = registry.get_config("qwen3_4b").reduced()
    pipe, jpipe = (TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=2),
                   JPipe(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=2))
    cases = {"plain": {}, "microbatches2": {"microbatches": 2},
             "compress": {"compress_dp_grads": True}}
    bad = {}
    for name, kw in cases.items():
        knobs = dict(base_lr=1e-3, warmup_steps=2, total_steps=3, **kw)
        tcfg, jtcfg = TrainStepConfig(**knobs), JCfg(**knobs)
        jparams, model = _port_model(jax, JT, cfg, seed=3)
        jopt_state = jopt.adamw_init(jparams)
        jres = jopt.residuals_init(jparams) if tcfg.compress_dp_grads else ()
        opt = optim.adamw_init(model)
        res = optim.residuals_init(model) if tcfg.compress_dp_grads else ()
        jstep = jax.jit(jmake(lambda p, b: JT.loss_fn(p, cfg, b), jtcfg))
        step_fn = make_train_step(lambda p, b: T.loss_fn(p, cfg, b), tcfg)
        lr_sum = 0.0
        for step in range(3):
            b = pipe.batch_slice(step, 0, 1)
            jb = jpipe.batch_slice(step, 0, 1)
            if any(not np.array_equal(b[k], jb[k]) for k in jb):
                bad[f"{name}/batch[{step}]"] = "differs"
            jparams, jopt_state, jres, jm = jstep(
                jparams, jopt_state, jres, {k: jnp.asarray(v) for k, v in jb.items()},
                jnp.int32(step))
            model, opt, res, m = step_fn(
                model, opt, res, {k: torch.from_numpy(v) for k, v in b.items()}, step)
            for key in ("loss", "grad_norm", "lr"):
                got, want = float(m[key]), float(jm[key])
                if abs(got - want) > 1e-4 * abs(want):
                    bad[f"{name}/{key}[{step}]"] = (got, want)
            lr_sum += float(jm["lr"])
            flat = {}
            for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
                keys = [k.key for k in path]
                flat[tuple(keys)] = np.asarray(leaf)
            worst, off, total = 0.0, 0, 0
            for pname, p in model.named_parameters():
                parts = pname.split(".")
                want = (flat[("layers", *parts[2:])][int(parts[1])]
                        if parts[0] == "layers" else flat[tuple(parts)])
                d = np.abs(p.detach().numpy() - want)
                worst, off, total = max(worst, float(d.max())), off + int((d > 1e-6).sum()), total + d.size
            if off > 1e-3 * total or worst > 2 * lr_sum:
                bad[f"{name}/params[{step}]"] = {"off": off, "of": total, "worst": worst}

    # the port's gradients are per layer; the reference's leaf (one scale)
    # is the weight stacked over the layers
    rng = np.random.default_rng(4)
    jgrads = {"a": rng.normal(size=(64,)).astype(np.float32),
              "layers": {"w": (1e-3 * rng.normal(size=(2, 8, 16))).astype(np.float32)}}
    grads = {"a": jgrads["a"], "layers.0.w": jgrads["layers"]["w"][0],
             "layers.1.w": jgrads["layers"]["w"][1]}
    where = {"a": ("a",), "layers.0.w": ("layers", "w", 0), "layers.1.w": ("layers", "w", 1)}

    def pick(tree, path):
        """The entry at ``path``; a stacked leaf has one scale for all its
        layers."""
        for k in path:
            if isinstance(k, int) and np.ndim(tree) == 0:
                break
            tree = tree[k]
        return np.asarray(tree)

    jres = jopt.residuals_init(jax.tree.map(jnp.asarray, jgrads))
    res = optim.residuals_init({k: torch.from_numpy(v) for k, v in grads.items()})
    for r in range(2):
        jq, js, jres = jopt.compress_grads_int8(jax.tree.map(jnp.asarray, jgrads), jres)
        q, s, res = optim.compress_grads_int8(
            {k: torch.from_numpy(v) for k, v in grads.items()}, res)
        jdeq = jopt.decompress_grads_int8(jq, js)
        deq = optim.decompress_grads_int8(q, s)
        for k, path in where.items():
            for label, got, want in (("int8", q[k], pick(jq, path)),
                                     ("scale", s[k], pick(js, path)),
                                     ("residual", res[k], pick(jres, path)),
                                     ("decompressed", deq[k], pick(jdeq, path))):
                if not np.array_equal(np.asarray(got), want):
                    bad[f"compress[{r}]/{k}/{label}"] = "differs"
    assert not bad, bad


def test_serve_engine_equals_jax():
    """``ServeEngine`` with 2 slots and 3 requests (one waits for a refill;
    the prefill writes token 0 into the other slot's cache, as the
    reference's): the JAX engine's tokens.  The registry gives every arch
    the module the JAX registry gives it, and each family's model and
    caches build."""
    jax, JL, JR, JT = _jax()
    from repro.serve import ServeEngine as JEngine
    from repro.serve.engine import Request as JRequest

    bad = {}
    for arch in ("qwen3_4b", "llava_next_34b"):
        cfg = registry.get_config(arch).reduced()
        jparams, model = _port_model(jax, JT, cfg)
        prompts = [np.array([1 + i, 2, 3]) for i in range(3)]
        jeng = JEngine(cfg, jparams, batch_slots=2, max_seq=32, eos_id=-1)
        eng = ServeEngine(cfg, model, batch_slots=2, max_seq=32, eos_id=-1)
        jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
        reqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
        for e, rs in ((jeng, jreqs), (eng, reqs)):
            for r in rs:
                e.submit(r)
            e.run_until_drained(max_iters=64)
        for r, jr in zip(reqs, jreqs):
            if not (r.done and jr.done and r.generated == jr.generated):
                bad[f"{arch}/req{r.rid}"] = (r.generated, jr.generated)
            if not all(0 <= t < cfg.padded_vocab for t in r.generated):
                bad[f"{arch}/req{r.rid}/range"] = r.generated

    for arch in registry.ARCHS:
        cfg = registry.get_config(arch).reduced()
        jmod = JR.get_module(JR.get_config(arch).reduced())
        mod = registry.get_module(cfg)
        if mod.__name__.rsplit(".", 1)[-1] != jmod.__name__.rsplit(".", 1)[-1]:
            bad[f"{arch}/module"] = (mod.__name__, jmod.__name__)
        try:
            mod.init_cache(cfg, 1, 4, CPU)
            (encdec.EncDec if cfg.family == "audio" else T.Transformer)(cfg, "meta")
        except Exception as e:          # every family builds
            bad[f"{arch}/build"] = f"{type(e).__name__}: {e}"
    assert not bad, bad
