"""Per-device cost, memory and collective analysis of one lowered step (the
port of ``repro.launch.hlo``).

The reference parses XLA's optimized HLO text.  The port lowers to no HLO:
:func:`analyze` runs the step on DTensors whose local shards are fake
tensors (``FakeTensorMode``: shapes only, nothing allocated) and watches,
through one ``TorchDispatchMode``, the ops rank 0 would run on its own
shard — the local ops DTensor issues after choosing its sharding, and each
``c10d_functional`` collective (plus DTensor's all-to-all) with its local
in/out bytes and its group size.  Collective wire bytes use the reference's
ring/all-pairs formulas:

    all-gather         out_bytes · (g−1)/g
    reduce-scatter     in_bytes  · (g−1)/g
    all-reduce         2 · in_bytes · (g−1)/g
    all-to-all         in_bytes  · (g−1)/g
    collective-permute in_bytes

(g = group size, the size of the mesh dim the collective runs over.)
"""
from __future__ import annotations

import dataclasses
import os
import sys
import weakref

import torch
import torch.distributed
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes


@dataclasses.dataclass
class Collective:
    kind: str
    in_bytes: int
    out_bytes: int
    group_size: int

    @property
    def wire_bytes(self) -> float:
        g = max(self.group_size, 1)
        f = (g - 1) / g
        if self.kind == "all-gather":
            return self.out_bytes * f
        if self.kind == "reduce-scatter":
            return self.in_bytes * f
        if self.kind == "all-reduce":
            return 2 * self.in_bytes * f
        if self.kind == "all-to-all":
            return self.in_bytes * f
        if self.kind == "collective-permute":
            return self.in_bytes
        return 0.0


def collective_bytes(colls: list[Collective]) -> float:
    """Total per-device wire bytes across all collectives."""
    return sum(c.wire_bytes for c in colls)


def collective_instruction_counts(colls: list[Collective]) -> dict[str, int]:
    """Number of collectives issued per kind (not bytes)."""
    counts: dict[str, int] = {}
    for c in colls:
        counts[c.kind] = counts.get(c.kind, 0) + 1
    return counts


def collective_summary(colls: list[Collective]) -> dict[str, float]:
    summary: dict[str, float] = {}
    for c in colls:
        summary[c.kind] = summary.get(c.kind, 0.0) + c.wire_bytes
    summary["total"] = sum(summary.values())
    return summary


# -- the dispatch-level counter ----------------------------------------------

#: collective op name → (kind, index of the group-size argument or None)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 1),
    "all_gather_into_tensor_coalesced": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 2),
    "all_reduce": ("all-reduce", None),
    "all_reduce_": ("all-reduce", None),
    "all_reduce_coalesced": ("all-reduce", None),
    "all_reduce_coalesced_": ("all-reduce", None),
    "all_to_all_single": ("all-to-all", None),
    "shard_dim_alltoall": ("all-to-all", None),
}
_NAMESPACES = ("_c10d_functional", "_dtensor")

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log2", "log1p", "sin", "cos",
                   "tanh", "sigmoid", "rsqrt", "sqrt", "erf", "pow", "logit",
                   "silu", "gelu", "softplus"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "norm",
               "linalg_vector_norm", "var", "std", "any", "all", "argmax",
               "argmin", "logsumexp", "cumsum"}
_SOFTMAX = {"_softmax", "_log_softmax", "_softmax_backward_data",
            "_log_softmax_backward_data"}
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "_unsafe_view", "alias", "detach",
             "lift_fresh", "device", "set_", "wait_tensor"}


_DTENSOR_DIR = os.path.join(os.path.dirname(torch.distributed.__file__), "tensor")
#: DTensor's files whose tensor arithmetic is bookkeeping (shard sizes)
_BOOKKEEPING = ("placement_types.py", "_redistribute.py", "_utils.py",
                "_collective_utils.py")


_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the DTensor function whose frames mark its own shape propagation
_PROPAGATION = "_propagate_tensor_meta_non_cached"


def _check_dtensor_internals() -> None:
    """Raise if torch no longer has the DTensor files and function that
    :func:`_caller_role` tells its callers by, so that a torch that renamed
    them fails here instead of moving ops between counted and not."""
    from torch.distributed.tensor import _sharding_prop
    missing = [f for f in _BOOKKEEPING
               if not os.path.exists(os.path.join(_DTENSOR_DIR, f))]
    if not hasattr(_sharding_prop.ShardingPropagator, _PROPAGATION):
        missing.append(f"ShardingPropagator.{_PROPAGATION}")
    if missing:
        raise RuntimeError(f"torch {torch.__version__}: DTensor lacks {missing}, "
                           "which the dry-run's op attribution reads")


def _caller_role() -> str:
    """Who issued a factory call: "bookkeeping" (DTensor sizing a shard),
    "propagation" (DTensor making the global stand-ins it runs an op on, in
    a fake mode of its own, to learn its output's shape) or "op" (the
    model).  Read from the frames up to the first of this package's."""
    f = sys._getframe(2)
    innermost = None
    while f is not None and not f.f_code.co_filename.startswith(_PACKAGE_DIR):
        name = f.f_code.co_filename
        if innermost is None and name.startswith(_DTENSOR_DIR):
            innermost = os.path.basename(name)
        if f.f_code.co_name == _PROPAGATION:
            return "bookkeeping" if innermost in _BOOKKEEPING else "propagation"
        f = f.f_back
    return "bookkeeping" if innermost in _BOOKKEEPING else "op"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors of a tree of tuples, lists, dicts and modules (their
    parameters and buffers)."""
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif isinstance(x, torch.nn.Module):
            stack.extend(reversed([*x.parameters(), *x.buffers()]))
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


class _Counter(TorchDispatchMode):
    """Rank 0's ops under one fake mode: FLOPs, bytes, transcendentals,
    collectives, and every storage's birth and death (for the peak)."""

    def __init__(self, fake_mode):
        super().__init__()
        self.fake_mode = fake_mode
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.collectives: list[Collective] = []
        self.events: list[tuple[int, int]] = []    # (storage id, ±bytes)
        self.known: set[int] = set()

    def _ours(self, t) -> bool:
        return getattr(t, "fake_mode", None) is self.fake_mode

    def register(self, t: torch.Tensor, event: bool = True) -> int:
        """Note ``t``'s storage (an event of its birth, and its death when it
        is freed, unless ``event`` is false); returns its id."""
        st = t.untyped_storage()
        sid = st._cdata
        if sid not in self.known:
            self.known.add(sid)
            if event:
                nb = st.nbytes()
                self.events.append((sid, nb))
                weakref.finalize(st, self._freed, sid, nb)
        return sid

    def _freed(self, sid: int, nb: int) -> None:
        self.known.discard(sid)
        self.events.append((sid, -nb))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor desugar into local ops first
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        role = "op" if ins else _caller_role()
        if any(isinstance(t, FakeTensor) for t in ins) or role == "propagation":
            out = func(*args, **kwargs)         # the tensors' own fake mode
        elif ins or role == "bookkeeping":
            # DTensor's own bookkeeping (shard sizes of a strided split read
            # back with .tolist()): small real tensors, outside every mode
            with _disable_current_modes():
                return func(*args, **kwargs)
        else:
            with self.fake_mode:                # the model's own factories
                out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs or not all(self._ours(t) for t in outs):
            return out                  # DTensor's shape propagation (its own mode)
        for t in outs:
            self.register(t)
        name = func._schema.name
        ns, _, op = name.partition("::")
        if ns in _NAMESPACES:
            self._collective(op, args, ins, outs)
            return out
        packet = func._overloadpacket
        from torch.utils.flop_counter import flop_registry
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        elif op in _SOFTMAX:
            self.flops += 4 * outs[0].numel()
            self.transcendentals += outs[0].numel()
        elif op.rstrip("_") in _REDUCTIONS and ins:
            self.flops += ins[0].numel()
        elif torch.Tag.pointwise in func.tags:
            if op.rstrip("_") in _TRANSCENDENTAL:
                self.transcendentals += outs[0].numel()
            else:
                self.flops += outs[0].numel()
        if not func.is_view and op not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        return out

    def _collective(self, op: str, args, ins, outs) -> None:
        if op in ("wait_tensor", "_wrap_tensor_autograd"):   # no data moves
            return
        if op not in _COLLECTIVES:
            raise NotImplementedError(f"collective {op!r} has no wire-byte formula")
        kind, gi = _COLLECTIVES[op]
        if gi is not None:
            g = int(args[gi])
        else:
            from torch.distributed.distributed_c10d import _resolve_process_group
            g = _resolve_process_group(args[-1]).size()
        self.collectives.append(Collective(kind, sum(_nbytes(t) for t in ins),
                                           sum(_nbytes(t) for t in outs), g))

    def temp_peak(self, exclude: set[int]) -> int:
        """The peak of live bytes born during the run, storages in
        ``exclude`` (the outputs) left out."""
        live = peak = 0
        for sid, nb in self.events:
            if sid not in exclude:
                live += nb
                peak = max(peak, live)
        return peak


def _fake_mode_of(args):
    for t in _tensors(args):
        mode = getattr(_local(t), "fake_mode", None)
        if mode is not None:
            return mode
    raise ValueError("analyze needs fake tensors (or DTensors of them) among its args")


def analyze(fn, args) -> dict:
    """Run ``fn(*args)`` (DTensors of fake shards; the model's own factory
    calls made fake in the shards' mode) and return rank 0's per-device figures, with the reference's keys:

    * ``flops`` — 2·M·N·K per matrix product (torch's flop formulas), one
      per output element of each arithmetic pointwise op, one per input
      element of each reduction, four per element of a softmax;
      ``transcendentals`` — one per output element of exp, log, tanh, the
      sigmoid family, sqrt/rsqrt, pow and a softmax;
    * ``bytes_accessed`` — every local op's input and output bytes, unfused
      (views, collectives and uninitialised allocations move none);
    * ``collectives`` — wire bytes per kind and their ``total``
      (:func:`collective_summary`); ``collective_counts`` per kind;
    * ``memory`` — ``argument_bytes``: the distinct storages of rank 0's
      shards of ``args`` (DTensor puts the larger chunk of an uneven split
      on rank 0, as XLA pads every shard to it); ``output_bytes``: the
      distinct storages of the result's local tensors; ``temp_bytes``: the
      peak of the bytes born during the run and still alive, outputs and
      arguments left out; ``code_bytes``: 0 (nothing is compiled).
    """
    _check_dtensor_internals()
    mode = _fake_mode_of(args)
    counter = _Counter(mode)
    arg_ids: dict[int, int] = {}
    for t in _tensors(args):
        lt = _local(t)
        arg_ids[counter.register(lt, event=False)] = lt.untyped_storage().nbytes()
    # the fake mode stays off the stack, so that DTensor's shape propagation
    # (which joins a fake mode it finds there) runs in a mode of its own
    with counter:
        out = fn(*args)
    out_ids: dict[int, int] = {}
    for t in _tensors(out):
        st = _local(t).untyped_storage()
        out_ids[st._cdata] = st.nbytes()
    return {
        "flops": float(counter.flops),
        "bytes_accessed": float(counter.bytes),
        "transcendentals": float(counter.transcendentals),
        "collectives": collective_summary(counter.collectives),
        "collective_counts": collective_instruction_counts(counter.collectives),
        "memory": {
            "argument_bytes": sum(arg_ids.values()),
            "output_bytes": sum(out_ids.values()),
            "temp_bytes": counter.temp_peak(set(out_ids) | set(arg_ids)),
            "code_bytes": 0,
        },
    }
