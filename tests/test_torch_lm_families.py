"""The port's LM families (moe, hybrid, ssm, audio) on the CPU, held to the
JAX package's outputs recorded in ``tests/torch_lm_families_ref.npz`` by
``tests/make_torch_lm_families_ref.py`` (no JAX here).

Reduced configs in float32 (the cases are ``tests/torch_lm_families.py``'s);
the parameters are made from a seed with numpy in the reference's tree
layout and reach the port through ``interop.lm_params_from_numpy``.
Tolerances: logits, aux, losses and decode/prefill logits within 1e-4 abs;
train-step loss, grad norm and lr within 1e-4 relative; remat gradients
within 1e-6 of those without remat; int8 compression equal; served tokens
equal.

Three tests, each looping over its cases and naming every failing one
(a file of at most three tests joins the end of ``--dist loadfile``'s
queue).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_lm_families as F
from repro_torch import interop, optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenPipeline
from repro_torch.models import encdec, gla, registry, transformer as T, xlstm
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import Request
from repro_torch.train import TrainStepConfig, make_train_step

ATOL = 1e-4
RTOL = 1e-4
CPU = "cpu"


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread, as the other port test files at the end of the queue."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    with np.load(F.REF) as data:
        arrays = {k: data[k] for k in data.files if k != "meta"}
        meta = json.loads(str(data["meta"]))
    return arrays, meta


def _model(meta, case, cfg, seed_case=None):
    spec = meta["specs"][case]
    tree = F.numpy_tree(spec, F.stable_seed(seed_case or case, "params"))
    return interop.lm_params_from_numpy(tree, cfg, CPU)


def _close(bad, label, got, want, atol=ATOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        bad[label] = f"shape {got.shape} vs {want.shape}"
    elif not np.allclose(got, want, rtol=0, atol=atol):
        bad[label] = float(np.max(np.abs(got - want)))


def _leaf_path(name: str) -> str:
    """The reference's leaf of a port parameter name, '.'-joined."""
    parts = name.split(".")
    if parts[0] in F.STACKS:
        parts = [parts[0], *parts[2:]]
    return ".".join(parts)


def test_models_equal_jax(ref):
    """Per case: ``forward`` logits and aux, ``loss_fn``, ``prefill`` and 12
    ``decode_step`` logits (seamless after ``start_decode``); mixtral's ring
    buffer (window 8) wraps; the hybrid and ssm decodes equal ``forward``.
    Each arch's parameters in bfloat16 have the reference's dtypes (the
    router, Mamba's A_log/dt_bias/D_skip, the xLSTM gates in float32);
    ``gla_chunked`` at chunks 4 and 8 and ``gla_reference`` equal the JAX
    ``gla_reference``; GELU (tanh), softplus and log-sigmoid equal JAX's on
    a grid within 1e-6."""
    arrays, meta = ref
    bad = {}
    for case in F.CASES:
        cfg = F.config(case, registry)
        mod = registry.get_module(cfg)
        model = _model(meta, case, cfg)
        x = {k: torch.from_numpy(v) for k, v in F.inputs(case, cfg).items()}
        batch = {"tokens": x["tokens"], "labels": x["labels"]}
        with torch.no_grad():
            if cfg.family == "audio":
                batch["prefix_embeds"] = x["frames"]
                logits, aux = mod.forward(model, cfg, x["tokens"], x["frames"])
                cache = mod.start_decode(model, cfg, x["frames"],
                                         mod.init_cache(cfg, F.B, F.S, CPU))
            else:
                logits, aux = mod.forward(model, cfg, x["tokens"])
                _close(bad, f"{case}/prefill", mod.prefill(model, cfg, x["tokens"]),
                       arrays[f"{case}/prefill"])
                cache = mod.init_cache(cfg, F.B, F.S, CPU)
            _close(bad, f"{case}/forward", logits, arrays[f"{case}/forward"])
            _close(bad, f"{case}/aux", aux, meta["aux"][case])
            _close(bad, f"{case}/loss", mod.loss_fn(model, cfg, batch), meta["loss"][case])
            steps = []
            for t in range(F.DECODE):
                lg, cache = mod.decode_step(model, cfg, x["tokens"][:, t:t + 1], cache, t)
                steps.append(lg[:, 0])
        dec = torch.stack(steps, dim=1)
        _close(bad, f"{case}/decode", dec, arrays[f"{case}/decode"])
        if cfg.family in ("hybrid", "ssm"):
            _close(bad, f"{case}/decode=forward", dec, logits[:, :F.DECODE])
        if cfg.sliding_window and cache["k"].shape[2] != min(cfg.sliding_window, F.S):
            bad[f"{case}/ring"] = f"cache length {cache['k'].shape[2]}"

    for arch in F.ARCHS:
        cfg = dataclasses.replace(F.config(arch, registry), dtype="bfloat16")
        cls = encdec.EncDec if cfg.family == "audio" else T.Transformer
        got = {}
        for name, p in cls(cfg, "meta").named_parameters():
            got.setdefault(_leaf_path(name), str(p.dtype).removeprefix("torch."))
        if got != meta["bf16_dtypes"][arch]:
            bad[f"{arch}/dtypes"] = {k: (got.get(k), v) for k, v in
                                     meta["bf16_dtypes"][arch].items() if got.get(k) != v}

    x = torch.from_numpy(F.activation_inputs())
    for name, fn in (("gelu", xlstm._gelu), ("softplus", torch.nn.functional.softplus),
                     ("log_sigmoid", torch.nn.functional.logsigmoid)):
        _close(bad, f"act/{name}", fn(x), arrays[f"act/{name}"], atol=1e-6)

    q, k, v, la = (torch.from_numpy(a) for a in F.gla_inputs())
    want_y, want_state = arrays["gla/y"], arrays["gla/state"]
    y, state = gla.gla_reference(q, k, v, la)
    _close(bad, "gla/reference", y, want_y)
    _close(bad, "gla/reference/state", state, want_state)
    for chunk in F.GLA["chunks"]:
        y, state = gla.gla_chunked(q, k, v, la, chunk=chunk)
        _close(bad, f"gla/chunk{chunk}", y, want_y)
        _close(bad, f"gla/chunk{chunk}/state", state, want_state)
    assert not bad, bad


def _train_batch(cfg, pipe, step):
    b = {k: torch.from_numpy(v) for k, v in pipe.batch_slice(step, 0, 1).items()}
    if cfg.family == "audio":
        b["prefix_embeds"] = torch.from_numpy(F.train_frames(cfg, step))
    return b


class _OpCount(TorchDispatchMode):
    """Counts the aten (and custom) ops dispatched while it is open."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _digest(t) -> str:
    return hashlib.sha256(np.ascontiguousarray(t.numpy()).tobytes()).hexdigest()[:16]


def test_train_steps_equal_jax(ref, tmp_path):
    """Per arch: two ``make_train_step`` steps (loss, grad norm, lr), and
    the gradients under remat with the ``full``, ``dots`` and ``outs``
    policies equal to those without remat, each policy keeping what it
    names (the backward recomputes every ``aten.mm`` under ``full``, none
    under ``dots``, no ``checkpoint_name`` value under ``outs``).  ``compress_grads_int8`` of a moe
    and an audio model (two rounds, the residual carried): int8 values,
    residuals and scales the reference's, one scale per stacked leaf.  A moe
    model in bfloat16 (its router float32) restored from a checkpoint byte
    for byte."""
    arrays, meta = ref
    bad = {}
    for arch in F.ARCHS:
        cfg = F.config(arch, registry)
        mod = registry.get_module(cfg)
        model = _model(meta, arch, cfg)
        tcfg = TrainStepConfig(base_lr=F.TRAIN["base_lr"],
                               warmup_steps=F.TRAIN["warmup_steps"],
                               total_steps=F.TRAIN["steps"])
        step_fn = make_train_step(lambda p, b: mod.loss_fn(p, cfg, b), tcfg)
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=F.TRAIN["seq"],
                             global_batch=F.TRAIN["batch"], seed=F.SEED)
        opt = optim.adamw_init(model)
        for step, want in enumerate(meta["train"][arch]):
            model, opt, _, m = step_fn(model, opt, (), _train_batch(cfg, pipe, step), step)
            for key, w in want.items():
                if abs(float(m[key]) - w) > RTOL * abs(w):
                    bad[f"{arch}/{key}[{step}]"] = (float(m[key]), w)

        batch = _train_batch(cfg, pipe, 0)
        grads, counts = {}, {}
        for policy in (None, "full", "dots", "outs"):
            c = dataclasses.replace(cfg, remat=policy is not None,
                                    remat_policy=policy or "full")
            with _OpCount() as fwd:
                loss = mod.loss_fn(model, c, batch)
            with _OpCount() as bwd:
                grads[policy] = torch.autograd.grad(
                    loss, list(model.parameters()), allow_unused=True,
                    materialize_grads=True)
            counts[policy] = (fwd.n, bwd.n)
        for policy in ("full", "dots", "outs"):
            worst = max(float((a - b).abs().max()) for a, b in zip(grads[policy], grads[None]))
            if worst > 1e-6:
                bad[f"{arch}/remat/{policy}"] = worst
        # what each policy keeps shows in what the backward recomputes:
        # "full" every product, "dots" none, "outs" no named value
        mm = {p: counts[p][1]["aten.mm.default"] for p in counts}
        named = "repro_torch.checkpoint_name.default"
        kept = (mm["full"] > mm[None] and mm["dots"] == mm[None]
                and counts["outs"][1][named] == 0
                and (counts["outs"][0][named] > 0) == (cfg.family in ("moe", "hybrid")))
        if not kept:
            bad[f"{arch}/remat/recomputed"] = (mm, counts["outs"][0][named],
                                               counts["outs"][1][named])

    for arch in F.COMPRESSED:
        spec = meta["specs"][arch]
        grads = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in F.port_leaves(
            spec, F.numpy_tree(spec, F.stable_seed(arch, "grads"), grads=True)).items()}
        res = optim.residuals_init(grads)
        for r, want in enumerate(meta["compress"][arch]):
            q, scales, res = optim.compress_grads_int8(grads, res)
            for n in grads:
                leaf = "/".join(_leaf_path(n).split("."))
                if (_digest(q[n]) != want["int8"][n]
                        or _digest(res[n]) != want["residual"][n]
                        or float(scales[n]) != want["scale"][leaf]):
                    bad[f"{arch}/compress[{r}]/{n}"] = "differs"

    cfg = dataclasses.replace(F.config("deepseek_moe_16b", registry), dtype="bfloat16")
    model = T.init_params(torch.Generator(CPU).manual_seed(0), cfg, CPU)
    fresh = T.init_params(torch.Generator(CPU).manual_seed(1), cfg, CPU)
    cm = CheckpointManager(str(tmp_path / "moe"))
    cm.save(3, {"model": model})
    got, step = cm.restore({"model": fresh})
    want = model.state_dict()
    same = step == 3 and all(
        t.dtype == want[k].dtype and torch.equal(t.view(torch.uint8), want[k].view(torch.uint8))
        for k, t in got["model"].state_dict().items())
    f32 = {k for k, t in fresh.state_dict().items() if t.dtype == torch.float32}
    if not (same and "layers.0.moe.router" in f32 and "layers.0.attn.wq" not in f32):
        bad["checkpoint/moe_bf16"] = (same, sorted(f32)[:4])
    assert not bad, bad


def test_serve_engine_equals_jax(ref):
    """``ServeEngine`` with 2 slots and 3 requests (one waits for a refill;
    the prefill writes token 0 into the other slot's caches, recurrent
    states included, as the reference's) serves the JAX engine's tokens for
    the moe, hybrid and ssm archs, and refuses audio.  The registry gives a
    module for every arch: encdec for audio, transformer for the rest."""
    arrays, meta = ref
    bad = {}
    for arch in F.SERVED:
        cfg = F.config(arch, registry)
        eng = ServeEngine(cfg, _model(meta, arch, cfg), batch_slots=F.SERVE["slots"],
                          max_seq=F.SERVE["max_seq"], eos_id=-1)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=F.SERVE["new"])
                for i, p in enumerate(F.prompts())]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained(max_iters=64)
        got = [r.generated if r.done else None for r in reqs]
        if got != meta["serve"][arch]:
            bad[f"{arch}/tokens"] = (got, meta["serve"][arch])

    cfg = F.config("seamless_m4t_medium", registry)
    try:
        ServeEngine(cfg, encdec.init_params(torch.Generator(CPU).manual_seed(0), cfg),
                    batch_slots=1, max_seq=8)
        bad["audio"] = "served"
    except ValueError:
        pass
    for arch in registry.ARCHS:
        cfg = registry.get_config(arch)
        want = encdec if cfg.family == "audio" else T
        if registry.get_module(cfg) is not want:
            bad[f"{arch}/module"] = registry.get_module(cfg).__name__
    assert not bad, bad
