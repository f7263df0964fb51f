"""The cases of ``tests/test_torch_lm_families.py`` and its recorder,
``tests/make_torch_lm_families_ref.py``: the LM families moe (deepseek-moe-16b,
mixtral-8x7b), hybrid (zamba2-7b), ssm (xlstm-1.3b) and audio
(seamless-m4t-medium), reduced, in float32.

Both sides compute on the same numbers: :func:`numpy_tree` makes a
parameter tree in the reference's layout (its paths, shapes and dtypes
recorded by the recorder from ``jax.eval_shape`` of the JAX package's
``init_params``) from a seed with numpy; :func:`inputs` makes the tokens,
labels and frames.  :func:`port_leaves` splits a tree into the port's
per-layer parameter names.  This module imports neither JAX nor the port.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "tests" / "torch_lm_families_ref.npz"

ARCHS = ("deepseek_moe_16b", "mixtral_8x7b", "zamba2_7b", "xlstm_1_3b",
         "seamless_m4t_medium")
#: the model cases: each arch reduced, and mixtral with a window of 8, so the
#: decode cache's ring buffer wraps within the decode
CASES = (*ARCHS, "mixtral_8x7b/window8")
STACKS = ("layers", "enc_layers", "dec_layers")
B, S, DECODE = 2, 16, 12
TRAIN = {"batch": 4, "seq": 16, "steps": 2, "base_lr": 1e-3, "warmup_steps": 1}
#: served by the LM decode engine (audio is refused, as by the reference's)
SERVED = ("deepseek_moe_16b", "mixtral_8x7b", "zamba2_7b", "xlstm_1_3b")
SERVE = {"slots": 2, "max_seq": 32, "requests": 3, "new": 4}
#: int8 gradient compression, held leaf by leaf
COMPRESSED = ("deepseek_moe_16b", "seamless_m4t_medium")
GLA = {"B": 2, "S": 16, "H": 2, "dk": 4, "dv": 3, "chunks": (4, 8)}
SEED = 7


def config(case: str, registry):
    """The reduced config of a case, from ``registry`` (either package's)."""
    arch, _, variant = case.partition("/")
    cfg = registry.get_config(arch).reduced()
    if variant == "window8":
        cfg = dataclasses.replace(cfg, sliding_window=8)
    return cfg


def stable_seed(case: str, what: str) -> int:
    return SEED * 1_000_003 + sum((i + 1) * ord(ch) for i, ch in enumerate(case + what))


def _leaf(rng, path: tuple, shape: tuple):
    """One leaf's values: norm scales near 1, Mamba's A_log near log(1 … H),
    the forget biases near 3, the embedding N(0, 1), other weights
    N(0, 1/fan_in) (fan_in: the second-to-last axis)."""
    name = path[-1]
    noise = rng.normal(size=shape)
    if name == "scale":
        return 1.0 + 0.1 * noise
    if name == "A_log":
        return np.log(np.linspace(1.0, shape[-1], shape[-1])) + 0.1 * noise
    if name in ("dt_bias",):
        return 0.1 * noise
    if name == "D_skip":
        return 1.0 + 0.1 * noise
    if name == "fbias":
        return 3.0 + 0.1 * noise
    if name == "bias":                                  # sLSTM: i, f, z, o
        D = shape[-1] // 4
        return np.concatenate([np.zeros(D), np.full(D, 3.0), np.zeros(2 * D)]) \
            + 0.1 * noise
    if name == "table":
        return noise
    return noise / np.sqrt(shape[-2])


def numpy_tree(spec: list, seed: int, grads: bool = False):
    """The tree of ``spec`` ([(path, shape, dtype)], path a list of dict keys
    and list indices as digit strings) with values from ``seed``; with
    ``grads``, 1e-3·N(0, 1) for every leaf instead (gradients to
    compress)."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for path, shape, dtype in spec:
        path, shape = tuple(path), tuple(shape)
        value = (1e-3 * rng.normal(size=shape) if grads
                 else _leaf(rng, path, shape)).astype(dtype)
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if nxt.isdigit():
                node = node.setdefault(key, [])
            elif key.isdigit():
                while len(node) <= int(key):
                    node.append({})
                node = node[int(key)]
            else:
                node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def port_leaves(spec: list, tree) -> dict:
    """{the port's parameter name: array} of a tree in the reference's
    layout: a stacked leaf ``layers/attn/wq`` gives ``layers.<i>.attn.wq``
    for each layer i."""
    out = {}
    for path, shape, _ in spec:
        node = tree
        for key in path:
            node = node[int(key)] if key.isdigit() else node[key]
        node = np.asarray(node)
        if path[0] in STACKS:
            for i in range(shape[0]):
                out[".".join([path[0], str(i), *path[1:]])] = node[i]
        else:
            out[".".join(path)] = node
    return out


def inputs(case: str, cfg) -> dict:
    """tokens and labels (B, S) (three labels masked), and frames
    (B, frontend_tokens, D) for audio."""
    rng = np.random.default_rng(stable_seed(case, "inputs"))
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    out["labels"][0, :3] = -1
    if cfg.family == "audio":
        out["frames"] = rng.normal(size=(B, cfg.frontend_tokens, cfg.d_model)) \
            .astype(np.float32)
    return out


def train_frames(cfg, step: int):
    """The frames of an audio model's train batch at ``step``."""
    rng = np.random.default_rng(stable_seed(cfg.name, f"frames{step}"))
    return rng.normal(size=(TRAIN["batch"], cfg.frontend_tokens, cfg.d_model)) \
        .astype(np.float32)


def gla_inputs():
    g = GLA
    rng = np.random.default_rng(SEED)
    q = rng.normal(size=(g["B"], g["S"], g["H"], g["dk"])).astype(np.float32)
    k = rng.normal(size=(g["B"], g["S"], g["H"], g["dk"])).astype(np.float32)
    v = rng.normal(size=(g["B"], g["S"], g["H"], g["dv"])).astype(np.float32)
    la = -np.abs(rng.normal(size=(g["B"], g["S"], g["H"]))).astype(np.float32)
    return q, k, v, la


def activation_inputs():
    """A grid of 97 points over [−6, 6]."""
    return np.linspace(-6.0, 6.0, 97, dtype=np.float32)


def prompts():
    return [np.array([1 + i, 2, 3]) for i in range(SERVE["requests"])]
