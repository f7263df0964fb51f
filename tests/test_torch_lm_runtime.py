"""The port's LM runtime on the CPU: ``repro_torch.checkpoint``,
``runtime.driver``, ``data.TokenPipeline`` and the LM entry points.

Held to the behaviours the JAX package's ``tests/test_checkpoint.py`` and
``tests/test_runtime.py`` pin (atomic publish, hashes, GC, verified
fallback, a pinned restore that never falls back; resume, NaN quarantine,
straggler watchdog, preemption; a stateless, elastic pipeline), plus what
is the port's own: bf16 leaves stored as their bits, modules restored in
place, the LM train step's quarantine, the pipeline's bytes equal to the
JAX package's, and the three LM command lines on the CPU.

Three tests, each looping over its cases and naming every failing one.
"""
from __future__ import annotations

import json
import os
import signal
import time

import numpy as np
import pytest
import torch

import torch_examples as TE
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenPipeline
from repro_torch.models import registry, transformer as T
from repro_torch.runtime import DriverConfig, StepDriver
from repro_torch.train import TrainStepConfig, make_train_step

CPU = "cpu"


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread, as the other port test files at the end of the queue."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def sigterm_kept():
    """The entry points install a SIGTERM handler; put the old one back."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


def _tree(v: float):
    return {"w": torch.full((4, 3), v, dtype=torch.float32),
            "b": torch.full((3,), v, dtype=torch.float32)}


def _bad_shard(mgr, step, fill=0.0):
    """Overwrite a step's shard with other bytes of the same shapes."""
    np.savez(os.path.join(mgr.dir, f"step_{step:09d}", "shard_0.npz"),
             leaf_0=np.full((3,), fill, np.float32),
             leaf_1=np.full((4, 3), fill, np.float32))


def _two_steps(path):
    m = CheckpointManager(str(path), keep=3)
    m.save(1, _tree(1.0))
    m.save(2, _tree(2.0))
    return m


def _raises(fn, exc, match=None):
    try:
        fn()
    except exc as e:
        return match is None or match in str(e)
    return False


def _ck_roundtrip(path):
    """Every kind of leaf: nested dicts, a module (loaded in place), a named
    tuple, bf16 (stored as uint16 bits, dtype in the manifest), int, numpy."""
    cfg = registry.get_config("qwen3_4b").reduced()
    gen = torch.Generator(CPU).manual_seed(0)
    model = T.init_params(gen, cfg, CPU)
    state = {"model": model, "opt": optim.adamw_init(model),
             "half": {"x": torch.randn(5, 7, generator=gen).to(torch.bfloat16)},
             "count": torch.arange(8, dtype=torch.int32), "host": np.arange(3.0)}
    cm = CheckpointManager(str(path))
    cm.save(7, state)
    fresh = T.init_params(torch.Generator(CPU).manual_seed(1), cfg, CPU)
    template = {"model": fresh, "opt": optim.adamw_init(fresh),
                "half": {"x": torch.zeros(5, 7, dtype=torch.bfloat16)},
                "count": torch.zeros(8, dtype=torch.int32), "host": np.zeros(3)}
    got, step = cm.restore(template)
    with open(path / "step_000000007" / "manifest.json") as f:
        manifest = json.load(f)
    half = manifest["names"].index("['half']['x']")
    with np.load(path / "step_000000007" / "shard_0.npz") as data:
        stored = data[f"leaf_{half}"]
    want = dict(state["model"].state_dict())
    return (step == 7 and got["model"] is fresh
            and all(torch.equal(v, want[k]) for k, v in fresh.state_dict().items())
            and torch.equal(got["opt"].step, state["opt"].step)
            and all(torch.equal(got["opt"].mu[k], v) for k, v in state["opt"].mu.items())
            and got["half"]["x"].dtype == torch.bfloat16
            and torch.equal(got["half"]["x"].view(torch.int16),
                            state["half"]["x"].view(torch.int16))
            and manifest["dtypes"][half] == "bfloat16" and stored.dtype == np.uint16
            and torch.equal(got["count"], state["count"])
            and np.array_equal(got["host"], state["host"])
            and "['model']['layers.0.attn.wq']" in manifest["names"])


def _ck_gc_and_latest(path):
    cm = CheckpointManager(str(path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save(s, _tree(float(s)))
    return cm.list_steps() == [3, 4] and cm.latest_step() == 4


def _ck_async_save(path):
    cm = CheckpointManager(str(path))
    state = _tree(3.0)
    cm.save(5, state, blocking=False)
    state["w"] += 1.0                   # the snapshot was taken before
    cm.wait()
    got, step = cm.restore(_tree(0.0))
    return step == 5 and float(got["w"][0, 0]) == 3.0


def _ck_ignores_uncommitted(path):
    cm = CheckpointManager(str(path))
    cm.save(1, _tree(1.0))
    os.makedirs(path / "step_000000009")       # a torn save
    return cm.latest_step() == 1


def _ck_latest_committed(path):
    tree, step = _two_steps(path).restore(_tree(0.0))
    return step == 2 and float(tree["w"][0, 0]) == 2.0


def _ck_hash_mismatch(path):
    mgr = _two_steps(path)
    _bad_shard(mgr, 2)
    tree, step = mgr.restore(_tree(0.0))
    return step == 1 and float(tree["w"][0, 0]) == 1.0


def _ck_torn_shard(path):
    mgr = _two_steps(path)
    shard = path / "step_000000002" / "shard_0.npz"
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) // 2)
    return mgr.restore(_tree(0.0))[1] == 1


def _ck_missing_committed(path):
    mgr = _two_steps(path)
    os.unlink(path / "step_000000002" / "COMMITTED")
    return (mgr.list_steps() == [1] and mgr.latest_step() == 1
            and mgr.restore(_tree(0.0))[1] == 1)


def _ck_tree_drift(path):
    mgr = _two_steps(path)
    mpath = path / "step_000000002" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["names"] = ["['stale']"] * len(manifest["names"])
    mpath.write_text(json.dumps(manifest))
    drifted = dict(_tree(0.0), extra=torch.zeros(1))
    return (mgr.restore(_tree(0.0))[1] == 1
            and _raises(lambda: mgr.restore(drifted), FileNotFoundError, "tree mismatch"))


def _ck_dtype_drift(path):
    mgr = _two_steps(path)
    half = {k: v.to(torch.bfloat16) for k, v in _tree(0.0).items()}
    return _raises(lambda: mgr.restore(half, step=2), AssertionError, "dtype mismatch")


def _ck_all_bad(path):
    mgr = _two_steps(path)
    for s in (1, 2):
        _bad_shard(mgr, s)
    return _raises(lambda: mgr.restore(_tree(0.0)), FileNotFoundError, "step 1: hash mismatch")


def _ck_pinned(path):
    mgr = _two_steps(path)
    _bad_shard(mgr, 2)
    ok = _raises(lambda: mgr.restore(_tree(0.0), step=2), AssertionError, "hash mismatch")
    os.unlink(path / "step_000000002" / "COMMITTED")
    ok &= _raises(lambda: mgr.restore(_tree(0.0), step=2), FileNotFoundError, "COMMITTED")
    return ok and mgr.restore(_tree(0.0), step=1)[1] == 1


def _ck_fallback_disabled(path):
    mgr = _two_steps(path)
    _bad_shard(mgr, 2)
    return _raises(lambda: mgr.restore(_tree(0.0), fallback=False), AssertionError)


def _ck_skip_verify(path):
    mgr = _two_steps(path)
    _bad_shard(mgr, 2, fill=9.0)
    tree, step = mgr.restore(_tree(0.0), verify=False)
    return step == 2 and float(tree["w"][0, 0]) == 9.0


def test_checkpoint_contract(tmp_path):
    """The reference's checkpoint contract on the port's trees."""
    pytest.importorskip("jax")
    cases = {name[4:]: fn for name, fn in globals().items() if name.startswith("_ck_")}
    bad = {}
    for name, fn in cases.items():
        path = tmp_path / name
        try:
            ok = fn(path)
        except Exception as e:        # a case that raises is named, not fatal
            ok = f"{type(e).__name__}: {e}"
        if ok is not True:
            bad[name] = ok
    assert len(cases) == 14 and not bad, bad


def test_driver_and_pipeline(tmp_path):
    """Run, resume, quarantine, straggler, preemption (a flag and a real
    SIGTERM); the LM train step discards a non-finite step; the pipeline is
    stateless, elastic and the JAX package's bytes."""
    pytest.importorskip("jax")
    from repro.data import TokenPipeline as JPipe
    bad = {}

    def step_fn(state, batch, step):
        loss = float("nan") if step == 3 else 1.0 / (step + 1)
        return {"w": state["w"] + 1}, {"loss": torch.tensor(loss)}

    cfg = DriverConfig(total_steps=6, checkpoint_every=2,
                       checkpoint_dir=str(tmp_path / "run"))
    drv = StepDriver(cfg, step_fn, lambda s: {}, {"w": torch.zeros(2)})
    end = drv.run()
    if not (end == 6 and float(drv.state["w"][0]) == 5.0 and drv.bad_steps == 1):
        bad["quarantine"] = (end, drv.state, drv.bad_steps)
    drv2 = StepDriver(DriverConfig(total_steps=8, checkpoint_every=2,
                                   checkpoint_dir=str(tmp_path / "run")),
                      step_fn, lambda s: {}, {"w": torch.zeros(2)})
    end2 = drv2.run()
    if not (end2 == 8 and drv2.ckpt.latest_step() == 7
            and float(drv2.state["w"][0]) == 7.0):
        bad["resume"] = (end2, drv2.ckpt.latest_step(), drv2.state)

    def slow(state, batch, step):
        if step == 5:
            time.sleep(0.25)
        return state, {"loss": torch.tensor(1.0)}

    drv = StepDriver(DriverConfig(total_steps=8, checkpoint_every=100,
                                  checkpoint_dir=str(tmp_path / "slow"),
                                  straggler_factor=5.0),
                     slow, lambda s: {}, {"w": torch.zeros(1)})
    drv.run()
    if 5 not in drv.straggler_events:
        bad["straggler"] = drv.straggler_events

    for how in ("flag", "sigterm"):
        def preempt(state, batch, step):
            if step == 2:
                if how == "flag":
                    drv.preempted = True
                else:
                    os.kill(os.getpid(), signal.SIGTERM)
            return {"w": state["w"] + 1}, {"loss": torch.tensor(0.5)}

        old = signal.getsignal(signal.SIGTERM)
        try:
            drv = StepDriver(DriverConfig(total_steps=100, checkpoint_every=1000,
                                          checkpoint_dir=str(tmp_path / how)),
                             preempt, lambda s: {}, {"w": torch.zeros(1)})
            drv.install_signal_handler()
            end = drv.run()
        finally:
            signal.signal(signal.SIGTERM, old)
        if not (end < 100 and drv.ckpt.latest_step() == end - 1):
            bad[f"preempt/{how}"] = (end, drv.ckpt.latest_step())

    # the LM train step leaves the state alone on a non-finite step
    lm = registry.get_config("qwen3_4b").reduced()
    model = T.init_params(torch.Generator(CPU).manual_seed(0), lm, CPU)
    pipe = TokenPipeline(vocab=lm.vocab, seq_len=8, global_batch=2)
    ts = make_train_step(lambda p, b: T.loss_fn(p, lm, b) + b["poison"],
                         TrainStepConfig(base_lr=1e-3, warmup_steps=1, total_steps=4))

    def lm_step(state, batch, step):
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        b["poison"] = torch.tensor(float("nan") if step == 2 else 0.0)
        params, opt, _, m = ts(*state, (), b, step)
        return (params, opt), m

    drv = StepDriver(DriverConfig(total_steps=4, checkpoint_every=100,
                                  checkpoint_dir=str(tmp_path / "lm")),
                     lm_step, lambda s: pipe.batch_slice(s, 0, 1),
                     (model, optim.adamw_init(model)))
    drv.run()
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    if not (drv.bad_steps == 1 and int(drv.state[1].step) == 3 and finite):
        bad["lm_quarantine"] = (drv.bad_steps, int(drv.state[1].step), finite)

    tp = TokenPipeline(vocab=1000, seq_len=16, global_batch=8, seed=3)
    full = tp.global_batch_at(5)
    for n_shards in (1, 2, 4, 8):
        got = np.concatenate([tp.batch_slice(5, s, n_shards)["tokens"]
                              for s in range(n_shards)])
        if not np.array_equal(got, full["tokens"]):
            bad[f"pipeline/elastic/{n_shards}"] = "differs"
    raw = tp.batch_slice(2, 0, 1)
    if not np.array_equal(raw["tokens"][:, 1:], raw["labels"][:, :-1]):
        bad["pipeline/shift"] = "labels are not the next tokens"
    for vocab, seq, gb, seed, step, shard, n in ((1000, 16, 8, 3, 5, 1, 4),
                                                 (151936, 64, 8, 0, 9, 0, 1),
                                                 (512, 33, 6, 7, 123456, 2, 3)):
        a = TokenPipeline(vocab, seq, gb, seed).batch_slice(step, shard, n)
        b = JPipe(vocab, seq, gb, seed).batch_slice(step, shard, n)
        for k in ("tokens", "labels"):
            if not (a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])):
                bad[f"pipeline/jax/{vocab}/{k}"] = "differs"
    assert not bad, bad


def test_lm_command_lines_on_the_cpu(tmp_path, capsys, sigterm_kept):
    """``launch.serve --mode lm``, ``launch.train`` and
    ``examples/torch/lm_train_demo.py``, each with ``--device cpu``."""
    pytest.importorskip("jax")
    from repro_torch.launch import serve, train
    bad = {}
    serve.main(["--mode", "lm", "--device", "cpu", "--requests", "3",
                "--slots", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    if "served 3 requests, 12 tokens" not in out:
        bad["serve"] = out[-400:]
    ckpt = tmp_path / "train"
    train.main(["--arch", "qwen3_4b", "--device", "cpu", "--steps", "4",
                "--batch", "4", "--seq", "16", "--ckpt-dir", str(ckpt),
                "--ckpt-every", "2"])
    out = capsys.readouterr().out
    if not ("finished at step 4" in out
            and CheckpointManager(str(ckpt)).list_steps() == [1, 3]):
        bad["train"] = out[-400:]
    if TE.load("lm").main(["--device", "cpu"]) != 0 \
            or "LM train demo OK" not in capsys.readouterr().out:
        bad["demo"] = "failed"
    assert not bad, bad
