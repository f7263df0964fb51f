"""A residue tensor of the distributed engine held as parts on several devices.

A :class:`~repro_torch.core.distributed.Mesh` may span a grid of ``Dl × Dc``
devices (cards, or repeats of one card or of the CPU): ``Dl`` rows along the
"limb" axis, ``Dc`` columns along "coef".  Device (a, k) holds limb clusters
``a·lc/Dl … (a+1)·lc/Dl − 1`` and cores ``k·cs/Dc … (k+1)·cs/Dc − 1`` of each,
which in both of the scope's four-step layouts are the layout positions
``[k·N/Dc, (k+1)·N/Dc)``.  A global (…, ℓ, N) tensor is then ``Dl·Dc``
per-device tensors, its **parts**, in row-major order, held by
:class:`Parts`:

* **split** over the rows (ℓ a multiple of lc): part (a, k) is (…, ℓ/Dl,
  N/Dc), the limbs ``[a·ℓ/Dl, (a+1)·ℓ/Dl)`` — its row's limb clusters';
* **replicated** over the rows (any ℓ): part (a, k) is (…, ℓ, N/Dc), every
  row the same words.

With one row (a flat sequence of ``Dc`` devices) only the coefficient axis is
split, and the two forms are one.  With one device a value is a plain
tensor, as it always was.

:class:`Parts` is an explicit class, not a ``torch.Tensor`` subclass.  It
offers the few tensor operations the CKKS path applies to ``RnsPoly.data``
and that act position by position: indexing and ``index_select`` over the
leading dims (and over the limb dim of a value that is not split over rows),
``expand``, a dtype change, and ``torch.stack`` / ``torch.cat`` along the
leading dims (through ``__torch_function__``).  Each maps over the parts.
Every other torch function, any index or reshape of the last dim, an index
of the limb dim of a row-split value, a move to another device and the
``device`` attribute raise :class:`PartsError`: such an op would mix
coefficients that lie in different parts, or read limbs another row holds,
and only the mesh's sharded primitives (the NTT, the BConv, the
automorphism) and its limb regroup (``Mesh.regroup``) may do that.  Kernel
wrappers read ``.device`` first, so a multi-part value handed to one outside
the engine raises there.

:func:`zip_parts` runs a function part by part over several operands, which
must agree on their grid and devices (a replicated operand beside a
row-split one is sliced to its row's limbs first, on its own part);
:func:`zip_limbs` also hands the function each part's limb slice, so ring
ops read their own row's moduli; :func:`on_each` maps one operand.  All call
the function once on plain tensors.
"""
from __future__ import annotations

from typing import Callable

import torch


class PartsError(ValueError):
    """An operation that would mix coefficients across the parts of a
    multi-part value, read limbs another row holds, or operands whose parts
    do not line up."""


class _MissingOp(PartsError, AttributeError):
    """A tensor method :class:`Parts` does not offer (``hasattr`` reads it
    as absent)."""


class Parts:
    """A global (…, ℓ, N) tensor as the ≥ 2 parts of a ``rows × cols`` grid,
    part (a, k) the positions [k·N/cols, (k+1)·N/cols) of its row's limbs
    (``split``: [a·ℓ/rows, (a+1)·ℓ/rows); else all ℓ), each on its own
    device."""

    __slots__ = ("parts", "rows", "split")

    def __init__(self, parts, rows: int = 1, split: bool = False):
        parts = tuple(parts)
        if len(parts) < 2:
            raise PartsError(f"a multi-part value needs ≥ 2 parts, got {len(parts)}")
        if rows < 1 or len(parts) % rows:
            raise PartsError(f"{len(parts)} parts do not form {rows} rows")
        p0 = parts[0]
        for p in parts[1:]:
            if p.shape != p0.shape or p.dtype != p0.dtype:
                raise PartsError(f"parts disagree: {tuple(p0.shape)} {p0.dtype} "
                                 f"against {tuple(p.shape)} {p.dtype}")
        self.parts = parts
        self.rows = int(rows)
        self.split = bool(split) and rows > 1

    # -- what a tensor would say -------------------------------------------------
    @property
    def cols(self) -> int:
        return len(self.parts) // self.rows

    @property
    def shape(self) -> torch.Size:
        s = self.parts[0].shape
        ell = s[-2] * self.rows if self.split else s[-2]
        return torch.Size((*s[:-2], ell, s[-1] * self.cols))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def dim(self) -> int:
        return self.parts[0].dim()

    def numel(self) -> int:
        """Words of the global tensor (a replicated row counted once)."""
        return sum(p.numel() for p in self.parts[:self.cols]) * (
            self.rows if self.split else 1)

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
        grid = (f"{self.rows}×{self.cols} {'split' if self.split else 'replicated'}, "
                if self.rows > 1 else "")
        return (f"Parts({len(self.parts)} × {tuple(self.parts[0].shape)}, {grid}"
                f"{self.dtype}, on {[str(d) for d in self.devices]})")

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        raise _MissingOp(f"{name} on a multi-part value: only position-wise "
                         "ops map over the parts; ops that mix coefficients "
                         "take the mesh's sharded primitives")

    # -- position-wise operations ------------------------------------------------
    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Parts":
        return Parts((fn(p) for p in self.parts), self.rows, self.split)

    def limb_slices(self) -> list[slice]:
        """Each part's slice of the global limbs, in part order."""
        per = self.parts[0].shape[-2]
        return [slice(i // self.cols * per, (i // self.cols + 1) * per)
                if self.split else slice(None) for i in range(len(self.parts))]

    def row_split(self) -> "Parts":
        """A replicated value held split over its rows: each part keeps its
        row's limbs (a local slice, no copy)."""
        if self.split or self.rows == 1:
            return self
        ell = self.parts[0].shape[-2]
        if ell % self.rows:
            raise PartsError(f"{ell} limbs do not split over {self.rows} rows")
        per = ell // self.rows
        return Parts((p[..., i // self.cols * per:(i // self.cols + 1) * per, :]
                      for i, p in enumerate(self.parts)), self.rows, True)

    def __getitem__(self, idx) -> "Parts":
        items = idx if isinstance(idx, tuple) else (idx,)
        full = lambda i: isinstance(i, slice) and i == slice(None)
        if any(i is Ellipsis for i in items):
            after = items[items.index(Ellipsis) + 1:]
            keeps_last = bool(after) and full(after[-1])
            keeps_limbs = len(after) < 2 or full(after[-2])
        else:
            used = [i for i in items if i is not None]
            keeps_last = len(used) < self.dim()
            keeps_limbs = len(used) < self.dim() - 1 or full(used[-1])
        if not keeps_last:
            raise PartsError(f"index {idx!r} reaches the coefficient axis of {self!r}")
        if self.split and not keeps_limbs:
            raise PartsError(f"index {idx!r} of the limb axis leaves the rows of "
                             f"{self!r}: regroup the limbs through the mesh")
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
            if d >= nd - 1 or (func is torch.cat and d == nd - 2 and first.rows > 1):
                raise PartsError(f"{func.__name__} along dim {dim} reaches the "
                                 f"{'coefficient' if d >= nd - 1 else 'limb'} axis "
                                 f"of {first!r}")
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


def rows_of(x) -> int:
    """The grid rows a value spans (1 for a tensor or a one-row value)."""
    return x.rows if isinstance(x, Parts) else 1


def on_each(x, fn: Callable[[torch.Tensor], torch.Tensor]):
    """``fn`` on every part of ``x`` (once on a plain tensor)."""
    return x.map(fn) if isinstance(x, Parts) else fn(x)


def _aligned(xs) -> tuple[list, int, bool]:
    """Operands that agree on their grid: the same parts on the same devices
    and rows; a replicated operand beside a row-split one is split (its own
    part's slice).  Returns (operands, rows, split)."""
    multi = [x for x in xs if isinstance(x, Parts)]
    if len(multi) != len(xs):
        raise PartsError(f"a tensor on one device against {multi[0]!r}: operands "
                         "of the distributed engine share its mesh's parts")
    devs, rows = multi[0].devices, multi[0].rows
    for x in multi[1:]:
        if x.devices != devs or x.rows != rows:
            raise PartsError(f"operands on different parts: {multi[0]!r} and {x!r}")
    split = any(x.split for x in multi)
    if split:
        xs = [x.row_split() for x in xs]
    return xs, rows, split


def zip_parts(fn: Callable[..., torch.Tensor], *xs):
    """``fn`` part by part over operands that agree on their parts: the
    same count, rows, and part k of each on the same device.  Plain tensors:
    one call.  A plain tensor against a multi-part value raises."""
    if not any(isinstance(x, Parts) for x in xs):
        return fn(*xs)
    xs, rows, split = _aligned(xs)
    return Parts((fn(*ps) for ps in zip(*(x.parts for x in xs))), rows, split)


def zip_limbs(fn: Callable[..., torch.Tensor], *xs):
    """:func:`zip_parts` where ``fn(limbs, *tensors)`` also receives the slice
    of the global limbs each part holds (``slice(None)`` for a plain tensor
    or a part that holds them all), so a ring op reads its row's moduli."""
    if not any(isinstance(x, Parts) for x in xs):
        return fn(slice(None), *xs)
    xs, rows, split = _aligned(xs)
    slices = xs[0].limb_slices()
    return Parts((fn(sl, *ps) for sl, *ps in zip(slices, *(x.parts for x in xs))),
                 rows, split)


def join(x, device) -> torch.Tensor:
    """The global tensor of a value on ``device``: each row's parts
    concatenated along the coefficient axis, and the rows along the limb
    axis when the value is split over them (a plain tensor is moved)."""
    if not isinstance(x, Parts):
        return x.to(device)
    c = x.cols
    rows = [torch.cat([p.to(device) for p in x.parts[a * c:(a + 1) * c]], dim=-1)
            for a in range(x.rows if x.split else 1)]
    return torch.cat(rows, dim=-2) if len(rows) > 1 else rows[0]


def split(x: torch.Tensor, devices, rows: int = 1,
          limbs: bool = False) -> "Parts | torch.Tensor":
    """A global (…, ℓ, N) tensor as one part per device (contiguous copies)
    of a ``rows × len(devices)/rows`` grid, split over the rows when
    ``limbs``, else replicated over them; one device: the tensor on it."""
    devices = tuple(devices)
    if len(devices) == 1:
        return x.to(devices[0])
    cols = len(devices) // rows
    limbs = limbs and rows > 1
    if x.shape[-1] % cols:
        raise PartsError(f"N = {x.shape[-1]} does not split into {cols} parts")
    if limbs and x.shape[-2] % rows:
        raise PartsError(f"{x.shape[-2]} limbs do not split over {rows} rows")
    row_t = x.chunk(rows, dim=-2) if limbs else (x,) * rows
    return Parts((c.to(d).contiguous()
                  for r, t in enumerate(row_t)
                  for c, d in zip(t.chunk(cols, dim=-1),
                                  devices[r * cols:(r + 1) * cols])),
                 rows, limbs)
