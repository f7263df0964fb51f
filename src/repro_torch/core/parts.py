"""A residue tensor of the distributed engine held as parts on several devices.

A :class:`~repro_torch.core.distributed.Mesh` may span ``D`` devices (cards,
or repeats of one card or of the CPU).  Its coefficient axis is split over
them: device k holds cores ``k·cs/D … (k+1)·cs/D − 1`` of every limb cluster,
which in both of the scope's four-step layouts are the layout positions
``[k·N/D, (k+1)·N/D)`` of every limb.  A global (…, ℓ, N) tensor is then
``D`` per-device tensors of shape (…, ℓ, N/D), its **parts**, held by
:class:`Parts`.  With one device a value is a plain tensor, as it always was.

:class:`Parts` is an explicit class, not a ``torch.Tensor`` subclass.  It
offers the few tensor operations the CKKS path applies to ``RnsPoly.data``
and that act position by position: indexing and ``index_select`` over the
leading and limb dims, ``expand``, a dtype change, and ``torch.stack`` /
``torch.cat`` along any dim but the last (through ``__torch_function__``).
Each maps over the parts.  Every other torch function, any index or
reshape of the last dim, a move to another device and the ``device``
attribute raise :class:`PartsError`: such an op would mix coefficients that
lie in different parts, and only the mesh's sharded primitives (the NTT, the
BConv, the automorphism) may do that.  Kernel wrappers read ``.device``
first, so a multi-part value handed to one outside the engine raises there.

:func:`zip_parts` runs a function part by part over several operands, which
must agree on their parts and devices; :func:`on_each` maps one operand.
Both call the function once on plain tensors.
"""
from __future__ import annotations

from typing import Callable

import torch


class PartsError(ValueError):
    """An operation that would mix coefficients across the parts of a
    multi-part value, or operands whose parts do not line up."""


class _MissingOp(PartsError, AttributeError):
    """A tensor method :class:`Parts` does not offer (``hasattr`` reads it
    as absent)."""


class Parts:
    """A global (…, ℓ, N) tensor as D ≥ 2 parts (…, ℓ, N/D), part k the
    positions [k·N/D, (k+1)·N/D), each on its own device."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        parts = tuple(parts)
        if len(parts) < 2:
            raise PartsError(f"a multi-part value needs ≥ 2 parts, got {len(parts)}")
        p0 = parts[0]
        for p in parts[1:]:
            if p.shape != p0.shape or p.dtype != p0.dtype:
                raise PartsError(f"parts disagree: {tuple(p0.shape)} {p0.dtype} "
                                 f"against {tuple(p.shape)} {p.dtype}")
        self.parts = parts

    # -- what a tensor would say -------------------------------------------------
    @property
    def shape(self) -> torch.Size:
        s = self.parts[0].shape
        return torch.Size((*s[:-1], s[-1] * len(self.parts)))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def dim(self) -> int:
        return self.parts[0].dim()

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(p.device for p in self.parts)

    @property
    def device(self):
        raise PartsError(
            f"a value in {len(self.parts)} parts lies on {list(map(str, self.devices))}: "
            "it has no single device; ops that mix coefficients take the "
            "mesh's sharded primitives (under dist_scope)")

    def __repr__(self) -> str:
        return (f"Parts({len(self.parts)} × {tuple(self.parts[0].shape)}, "
                f"{self.dtype}, on {[str(d) for d in self.devices]})")

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        raise _MissingOp(f"{name} on a multi-part value: only position-wise "
                         "ops map over the parts; ops that mix coefficients "
                         "take the mesh's sharded primitives")

    # -- position-wise operations ------------------------------------------------
    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Parts":
        return Parts(fn(p) for p in self.parts)

    def __getitem__(self, idx) -> "Parts":
        items = idx if isinstance(idx, tuple) else (idx,)
        if any(i is Ellipsis for i in items):
            after = items[items.index(Ellipsis) + 1:]
            keeps_last = bool(after) and after[-1] == slice(None)
        else:
            keeps_last = sum(i is not None for i in items) < self.dim()
        if not keeps_last:
            raise PartsError(f"index {idx!r} reaches the coefficient axis of {self!r}")
        return self.map(lambda p: p[idx])

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in (torch.stack, torch.cat):
            tensors, *rest = args
            dim = kwargs.pop("dim", rest[0] if rest else 0)
            if kwargs:
                raise PartsError(f"{func.__name__}: unsupported arguments {sorted(kwargs)}")
            first = next(t for t in tensors if isinstance(t, Parts))
            nd = first.dim() + (func is torch.stack)
            d = dim + nd if dim < 0 else dim
            if d >= nd - 1:
                raise PartsError(f"{func.__name__} along dim {dim} reaches the "
                                 f"coefficient axis of {first!r}")
            return zip_parts(lambda *ts: func(list(ts), d), *tensors)
        raise PartsError(f"torch.{getattr(func, '__name__', func)} on a multi-part "
                         "value: only position-wise ops map over the parts; ops "
                         "that mix coefficients take the mesh's sharded primitives")


def parts_of(x) -> tuple[torch.Tensor, ...]:
    """The tensors a value is held in: its parts, or the tensor itself."""
    return x.parts if isinstance(x, Parts) else (x,)


def devices_of(x) -> tuple[torch.device, ...]:
    """The devices of a value's parts, in order."""
    return tuple(p.device for p in parts_of(x))


def on_each(x, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``fn`` on every part of ``x`` (once on a plain tensor)."""
    return x.map(fn) if isinstance(x, Parts) else fn(x)


def zip_parts(fn: Callable[..., torch.Tensor], *xs):
    """``fn`` part by part over operands that agree on their parts: the
    same count, and part k of each on the same device.  Plain tensors: one
    call.  A plain tensor against a multi-part value raises."""
    multi = [x for x in xs if isinstance(x, Parts)]
    if not multi:
        return fn(*xs)
    if len(multi) != len(xs):
        raise PartsError(f"a tensor on one device against {multi[0]!r}: operands "
                         "of the distributed engine share its mesh's parts")
    devs = multi[0].devices
    for x in multi[1:]:
        if x.devices != devs:
            raise PartsError(f"operands on different parts: {multi[0]!r} and {x!r}")
    return Parts(fn(*ps) for ps in zip(*(x.parts for x in multi)))


def join(x, device) -> torch.Tensor:
    """The global tensor of a value on ``device``: its parts concatenated
    along the coefficient axis (a plain tensor is moved)."""
    if not isinstance(x, Parts):
        return x.to(device)
    return torch.cat([p.to(device) for p in x.parts], dim=-1)


def split(x: torch.Tensor, devices) -> "Parts | torch.Tensor":
    """A global (…, ℓ, N) tensor as one part per device (contiguous copies);
    one device: the tensor on it."""
    devices = tuple(devices)
    if len(devices) == 1:
        return x.to(devices[0])
    if x.shape[-1] % len(devices):
        raise PartsError(f"N = {x.shape[-1]} does not split into {len(devices)} parts")
    return Parts(c.to(d).contiguous() for c, d in zip(x.chunk(len(devices), dim=-1),
                                                      devices))
