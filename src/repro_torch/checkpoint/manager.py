"""Checkpoints with async save, atomic publish and verified restore: the port
of ``repro.checkpoint.manager``, with its layout and contract.

Layout:
    <dir>/step_000000123/
        manifest.json        — step, leaf names, shapes, dtypes, hashes
        shard_0.npz          — every leaf as a full array (one host)
        COMMITTED            — written last: presence marks a valid checkpoint

Fault-tolerance contract:
  * save is atomic (tmp dir + rename; COMMITTED last) — a crash mid-save can
    never corrupt the latest good checkpoint;
  * restore picks the newest COMMITTED step and verifies content hashes; a
    step that fails verification (bit rot, torn shard, tree drift) FALLS
    BACK to the next older committed step, unless the caller pinned an
    explicit ``step=`` (a pinned restore never loads another step);
  * leaves are named by their path in the state (dict keys ``['k']``,
    sequence items ``[i]``, named-tuple fields ``.f``, a module's state-dict
    entries ``['layers.0.attn.wq']``), so a state whose tree changed restores
    nothing from a checkpoint of the old tree.

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bits, with
``bfloat16`` as its dtype in the manifest.  Restored tensors land on the
template leaf's device; a module in the template is loaded in place.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch import nn


class CheckpointMismatch(AssertionError):
    """A step's content differs from its manifest or from the template: a
    hash, the tree of names, a shape or a dtype."""


def _flatten(tree, prefix: str = "") -> list:
    """[(name, leaf)] in the order restore consumes them."""
    if tree is None:
        return []
    if isinstance(tree, nn.Module):
        return [(f"{prefix}[{k!r}]", v)
                for k, v in tree.state_dict(keep_vars=True).items()]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in _flatten(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _rebuild(template, leaves):
    """``template``'s structure with its leaves taken in order from the
    iterator ``leaves``; modules are loaded in place."""
    if template is None:
        return None
    if isinstance(template, nn.Module):
        with torch.no_grad():
            for t in template.state_dict(keep_vars=True).values():
                t.copy_(next(leaves))
        return template
    if isinstance(template, dict):
        got = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: got[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[_rebuild(getattr(template, f), leaves)
                                for f in template._fields])
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(x, leaves) for x in template)
    return next(leaves)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A copy of the leaf on the host as numpy, and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()[:16]


def _digests(arrays: list) -> list[str]:
    """The leaves' digests, hashed side by side (``hashlib`` releases the
    interpreter lock on large buffers)."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(_digest, arrays))


def _from_host(a: np.ndarray, dtype: str, like):
    """A stored array as the template leaf's kind: a tensor on its device,
    else numpy."""
    if not isinstance(like, torch.Tensor):
        return a
    t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
        if dtype == "bfloat16" else torch.from_numpy(a)
    return t.to(like.device)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save -------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = True):
        """Snapshot to host memory synchronously, write asynchronously."""
        named = _flatten(tree)
        names = [n for n, _ in named]
        host = [_to_host(leaf) for _, leaf in named]
        if self._thread is not None:
            self._thread.join()

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step:09d}")
            final = os.path.join(self.dir, f"step_{step:09d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "shard_0.npz"),
                     **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
            manifest = {
                "step": step,
                "names": names,
                "shapes": [list(a.shape) for a, _ in host],
                "dtypes": [d for _, d in host],
                "hashes": _digests([a for a, _ in host]),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "COMMITTED")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None,
                verify: bool = True, fallback: bool = True):
        """Restore into the structure of ``template`` (names, shapes and
        dtypes must match); returns (state, step).

        With ``fallback`` (default), a step whose content fails
        verification — hash mismatch, unreadable shard or manifest, tree,
        shape or dtype drift — is skipped and the next older committed step
        is tried.  An explicit ``step=`` disables the fallback: a pinned
        restore either loads THAT step or raises.
        """
        pinned = step is not None
        candidates = [step] if pinned else list(reversed(self.list_steps()))
        if not candidates:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        errors = []
        for s in candidates:
            try:
                return self._restore_step(template, s, verify), s
            except (AssertionError, OSError, KeyError, ValueError, EOFError,
                    zipfile.BadZipFile) as e:
                if pinned or not fallback:
                    raise
                errors.append(f"step {s}: {e}")
        raise FileNotFoundError(
            "no committed checkpoint in "
            f"{self.dir} passed verification: {'; '.join(errors)}")

    def _restore_step(self, template, step: int, verify: bool):
        d = os.path.join(self.dir, f"step_{step:09d}")
        if not os.path.exists(os.path.join(d, "COMMITTED")):
            raise FileNotFoundError(f"step {step} has no COMMITTED marker")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        named = _flatten(template)
        names = [n for n, _ in named]
        if names != manifest["names"]:
            raise CheckpointMismatch("checkpoint tree mismatch")
        # every leaf is read and checked before the template is touched
        with np.load(os.path.join(d, "shard_0.npz")) as data:
            arrays = [data[f"leaf_{i}"] for i in range(len(named))]
        if verify:
            for i, h in enumerate(_digests(arrays)):
                if h != manifest["hashes"][i]:
                    raise CheckpointMismatch(f"hash mismatch leaf {i}")
        for i, ((name, leaf), a) in enumerate(zip(named, arrays)):
            if list(a.shape) != list(np.shape(leaf)):
                raise CheckpointMismatch(
                    f"shape mismatch {name}: {a.shape} vs {tuple(np.shape(leaf))}")
            if manifest["dtypes"][i] != _dtype_name(leaf):
                raise CheckpointMismatch(
                    f"dtype mismatch {name}: {manifest['dtypes'][i]} vs "
                    f"{_dtype_name(leaf)}")
        leaves = (_from_host(a, dtype, leaf) for a, dtype, (_, leaf)
                  in zip(arrays, manifest["dtypes"], named))
        return _rebuild(template, leaves)
