"""Distributed FHE primitives under a ClusterMap (paper §IV–§V), executed.

A **mesh** here is one process holding ``lc × cs`` logical shards: ``lc``
limb clusters (the "limb" axis) of ``cs`` cores each (the "coef" axis), on
one device or on a grid of ``Dl × Dc`` devices (:class:`Mesh`).  A sharded
:class:`~repro_torch.core.poly.RnsPoly` keeps one global (…, ℓ, N) tensor in
the scope's layout (on a grid, its :class:`~repro_torch.core.parts.Parts`);
shard (i, j) is the block of ℓ/lc contiguous limbs by N/cs contiguous
coefficients, the block ``P("limb", "coef")`` gives a JAX array.  Where ℓ
does not split over the limb clusters, every cluster reads all ℓ limbs (the
operand is replicated along "limb", and over the grid's rows).  Ring ops
outside the shard bodies run on the global tensor, part by part; an op that
changes which limbs a row holds (rescale's limb drop, ModUp's digits and
extension, ModDown's split, the level-sliced evks) regroups them between
the rows (:meth:`Mesh.regroup`, a counted copy).

The shard bodies are written against one block's local shape, with every
block of the mesh as a batch dimension ((lc, cs, B, ℓ_loc, n_loc) tensors),
and read other blocks only through the mesh's collectives:

* the four-step NTT's column and row phases (``kernels.ntt.ops.ntt_phase``),
  ONE ``all_to_all`` along "coef" between them (the §III-B shuffle);
* the BConv table product (``kernels.bconv.ops.bconv``): ARK's method
  (§V-A) — an ``all_to_all`` along "limb" into coefficient scattering, the
  full table, an ``all_to_all`` back — or limb duplication — an
  ``all_gather`` of the inputs along "limb", each limb cluster its own
  destination rows (one grouped launch over every cluster of a part,
  ``bconv_ops.bconv_grouped``), no output collective — or "local" (no
  collective: every core already holds all limbs of its coefficients; on a
  grid a row-split input is regrouped into replication first), chosen per
  Eq. 3 by ``cost_model.bconv_method``;
* the AutoU gather of the slot-parallel automorphism
  (``kernels.automorphism.ops.automorphism_blocks``) after ONE
  ``all_gather`` along "coef".

Each collective materialises its result in a new buffer, so an exchange that
put a chunk in the wrong place gives wrong bytes, and the mesh tallies what it
executed: the kind, the count and the bytes moved between distinct blocks
(:meth:`Mesh.executed`, :meth:`Mesh.bytes_moved`), and on several devices
the bytes copied between parts per kind and axis, regroups included
(:meth:`Mesh.bytes_between_parts`).  Independently, each
dispatch records the model's prediction (``cost_model.predict_collectives``)
with ``kernels.config.count_collective``, as the reference does; tests
compare the two tallies.

The standalone programs (:func:`run_dist_ntt`, :func:`run_dist_ntt_fourstep`,
:func:`dist_bconv_ark`, :func:`dist_bconv_limbdup`) run one primitive on a
mesh (the Fig. 7 traffic and the correctness self-test); :class:`dist_scope`
turns the batched CKKS path into the sharded engine: under it
``RnsPoly.to_ntt``/``to_coeff``/``automorphism_by_gelt`` and ``bconv_raw``
dispatch to :func:`sharded_ntt`, :func:`sharded_galois` and
:func:`sharded_bconv`, the CKKS ops take the eager decomposition, and data
lives in the four-step layouts (coefficient domain :func:`coef_layout_perm`,
NTT domain :func:`ntt_layout_perm`); ciphertexts and keys cross the boundary
through :func:`shard_ciphertext`/:func:`shard_keyset` and
:func:`unshard_ciphertext`.  Results equal the single-device eager engine's
bytes.

The reference's XLA mapping policies are :class:`MappingPolicy`
(:data:`ARK_POLICY`, :data:`LIMBDUP_POLICY`) and :func:`mapped_bconv`:
under ``bconv.mapping_scope(mesh, policy)`` every BConv of the global,
single-device dataflow runs on the mesh's shards under the policy, the rest
(NTT, EFU, the evk product) stays global on the device.  The port of
``repro.core.distributed`` without its jax version shims.
"""
from __future__ import annotations

import collections
import contextvars
import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import config as _kcfg
from repro_torch.kernels.automorphism import ops as auto_ops
from repro_torch.kernels.bconv import ops as bconv_ops
from repro_torch.kernels.ntt import ops as ntt_ops

from . import const_cache
from . import parts as _parts
from . import cost_model as _cost
from . import ntt as nttm
from .mapping import ClusterMap

AXES = ("limb", "coef")


# ----------------------------------------------------------------------------
# The mesh of logical shards and its collectives
# ----------------------------------------------------------------------------

class Mesh:
    """``lc × cs`` logical shards, axes ("limb", "coef"), on one device or
    split over a grid of devices.

    On one device sharded values are (lc, cs, …) tensors, dim 0 the limb
    cluster i and dim 1 the core j of the cluster; the rest is one block's
    local shape.  ``device`` may also be a sequence of ``Dc`` devices (the
    coefficient axis split over them, ``Dc`` | ``cs``) or a grid, a sequence
    of ``Dl`` rows of ``Dc`` devices each (``Dl`` | ``lc`` as well); repeats
    are allowed: ``["cuda:0"] * 4`` is four parts of one card, ``[["cpu"] *
    2] * 2`` a 2 × 2 grid of CPU parts.  Part (a, k) holds the limb clusters
    a·lc/Dl … (a+1)·lc/Dl − 1 and of each the cores k·cs/Dc … (k+1)·cs/Dc − 1;
    the blocks are then a list of ``Dl·Dc`` (lc/Dl, cs/Dc, …) tensors, one per
    part on its device, in row-major order.  The collectives along "coef"
    copy chunks between the parts of a grid row, those along "limb" between
    the parts of a grid column (``Tensor.to``: a peer copy between distinct
    cards, ordered against both cards' current streams).  Values between the
    shard bodies are held as :class:`~repro_torch.core.parts.Parts`: split
    over the rows when their limbs split over the limb clusters, else
    replicated over them; :meth:`regroup` moves limbs between rows.
    """

    def __init__(self, limb: int, coef: int, device="cuda"):
        if limb < 1 or coef < 1:
            raise ValueError(f"mesh axes must be ≥ 1, got limb={limb}, coef={coef}")
        if isinstance(device, (str, torch.device)):
            grid = [[device]]
        else:
            grid = list(device)
            if grid and not all(isinstance(r, (str, torch.device)) for r in grid):
                grid = [list(r) for r in grid]
            else:
                grid = [grid]
        if not grid or not grid[0] or any(len(r) != len(grid[0]) for r in grid):
            raise ValueError(f"mesh devices {device!r}: not a grid of equal rows")
        rows, cols = len(grid), len(grid[0])
        if coef % cols:
            raise ValueError(f"{cols} parts do not split the coef axis of "
                             f"{coef} cores")
        if limb % rows:
            raise ValueError(f"{rows} rows do not split the limb axis of "
                             f"{limb} clusters")
        self.shape = {"limb": int(limb), "coef": int(coef)}
        self.rows, self.cols = rows, cols
        self.devices = tuple(torch.device(d) for r in grid for d in r)
        for d in self.devices:
            if d.type == "cuda" and not (torch.cuda.is_available() and (
                    d.index is None or d.index < torch.cuda.device_count())):
                raise RuntimeError(f"mesh device {d}: no such CUDA card here")
        self._count: collections.Counter = collections.Counter()
        self._bytes: collections.Counter = collections.Counter()
        self._part_bytes: collections.Counter = collections.Counter()
        self._regroups = 0

    @property
    def lc(self) -> int:
        return self.shape["limb"]

    @property
    def cs(self) -> int:
        return self.shape["coef"]

    @property
    def n_parts(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device of a one-part mesh (a multi-part mesh has ``devices``)."""
        if self.n_parts > 1:
            raise _parts.PartsError(f"{self} spans {self.n_parts} parts: read devices")
        return self.devices[0]

    def __repr__(self) -> str:
        if self.n_parts == 1:
            where = self.devices[0]
        elif self.rows == 1:
            where = [str(d) for d in self.devices]
        else:
            where = [[str(d) for d in self.devices[a * self.cols:(a + 1) * self.cols]]
                     for a in range(self.rows)]
        return f"Mesh(limb={self.lc}, coef={self.cs}, device={where})"

    # -- placement ------------------------------------------------------------
    def check_device(self, t: torch.Tensor, part: int = 0) -> None:
        d = self.devices[part]
        if t.device.type != d.type or (d.index is not None
                                       and t.device.index != d.index):
            raise ValueError(f"operand on {t.device}, mesh part {part} on {d}")

    def part_devices(self, x) -> tuple[torch.device, ...]:
        """The devices of ``x``'s parts, checked against the mesh's: a plain
        tensor on a one-part mesh, ``n_parts`` parts of its grid on a
        multi-part one."""
        ps = _parts.parts_of(x)
        if len(ps) != self.n_parts or _parts.rows_of(x) != self.rows:
            raise _parts.PartsError(f"a value in {len(ps)} part(s) of "
                                    f"{_parts.rows_of(x)} row(s) on {self}")
        for k, p in enumerate(ps):
            self.check_device(p, k)
        return tuple(p.device for p in ps)

    def split_rows(self, ell: int) -> bool:
        """Whether an ℓ-limb value is held split over the grid's rows (its
        limbs split over the limb clusters), not replicated."""
        return self.rows > 1 and ell % self.lc == 0

    def split(self, x: torch.Tensor):
        """A global tensor as the mesh's parts (on a one-part mesh, on its
        device): split over the rows when its limbs split over the limb
        clusters, else replicated over them."""
        return _parts.split(x, self.devices, self.rows,
                            self.split_rows(int(x.shape[-2])))

    def join(self, x) -> torch.Tensor:
        """The global tensor of a value on the mesh's first device."""
        return _parts.join(x, self.devices[0])

    def row_of(self, part: int) -> int:
        return part // self.cols

    def each(self, fn, blocks, *per_part):
        """``fn(blocks, *args)`` on every part: ``per_part`` are lists of one
        argument per part."""
        if isinstance(blocks, list):
            return [fn(b, *a) for b, *a in zip(blocks, *per_part)]
        return fn(blocks, *(a[0] for a in per_part))

    @staticmethod
    def _place(x: torch.Tensor, limb_sharded: bool, lc: int, cs: int) -> torch.Tensor:
        ell, N = x.shape[-2:]
        xv = x.reshape(-1, ell, N)
        B = xv.shape[0]
        if limb_sharded:
            return xv.reshape(B, lc, ell // lc, cs, N // cs).permute(1, 3, 0, 2, 4)
        return (xv.reshape(B, ell, cs, N // cs).permute(2, 0, 1, 3)
                .unsqueeze(0).expand(lc, cs, B, ell, N // cs))

    def place(self, x, limb_sharded: bool):
        """The blocks of a global (…, ℓ, N) value as a (lc, cs, B, ℓ_loc,
        N/cs) view (B the leading dims flattened), or on a multi-part mesh a
        list of each part's (lc/Dl, cs/Dc, B, ℓ_loc, N/cs) view: limbs split
        over "limb" when ``limb_sharded`` (a value replicated over the rows
        first keeps its row's limbs, a local slice), else every cluster's
        view holds all ℓ."""
        self.part_devices(x)
        m, lr = self.cs // self.cols, self.lc // self.rows
        if self.n_parts == 1:
            return self._place(x, limb_sharded, self.lc, m)
        if limb_sharded:
            x = x.row_split()
        elif x.split:
            raise _parts.PartsError(f"{x!r} is split over the rows: a replicated "
                                    "operand was expected")
        return [self._place(p, limb_sharded, lr, m) for p in x.parts]

    @staticmethod
    def _collect(blocks: torch.Tensor, limb_sharded: bool,
                 lead: tuple[int, ...]) -> torch.Tensor:
        lc, cs, B, ell_loc, n = blocks.shape
        if limb_sharded:
            g = blocks.permute(2, 0, 3, 1, 4).reshape(B, lc * ell_loc, cs * n)
        else:
            g = blocks[0].permute(1, 2, 0, 3).reshape(B, ell_loc, cs * n)
        return g.reshape(*lead, g.shape[-2], g.shape[-1])

    def collect(self, blocks, limb_sharded: bool, lead: tuple[int, ...]):
        """The global (*lead, ℓ, N) value of (lc, cs, B, ℓ_loc, n_loc)
        blocks (a list of parts: their :class:`Parts`, split over the rows
        when ``limb_sharded``); a replicated operand is read from each
        part's first limb cluster."""
        if isinstance(blocks, list):
            return _parts.Parts((self._collect(b, limb_sharded, lead) for b in blocks),
                                self.rows, limb_sharded)
        return self._collect(blocks, limb_sharded, lead)

    def _row_basis(self, basis: tuple[int, ...], limb_sharded: bool) -> list:
        """Each part's moduli: its row's slice of ``basis`` when the blocks
        are limb-sharded over a grid of several rows, else all of them."""
        per = len(basis) // self.rows
        return [tuple(basis[self.row_of(i) * per:(self.row_of(i) + 1) * per])
                if limb_sharded and self.rows > 1 else tuple(basis)
                for i in range(self.n_parts)]

    # -- collectives -------------------------------------------------------------
    def _axis(self, axis: str) -> int:
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r} — one of {AXES}")
        return AXES.index(axis)

    def _groups(self, A: int, n_parts: int) -> list[list[int]]:
        """The parts that exchange along axis A: a grid row along "coef", a
        grid column along "limb" (each part alone on a one-part mesh)."""
        if n_parts == 1:
            return [[0]]
        if A == 1:
            return [list(range(a * self.cols, (a + 1) * self.cols))
                    for a in range(self.rows)]
        return [list(range(k, self.n_parts, self.cols)) for k in range(self.cols)]

    def _record(self, kind: str, axis: str, nbytes: int, part_bytes: int = 0) -> None:
        self._count[kind] += 1
        self._bytes[kind] += int(nbytes)
        if self.n_parts > 1 and (axis == "coef" and self.cols > 1
                                 or axis == "limb" and self.rows > 1):
            self._part_bytes[(kind, axis)] += int(part_bytes)

    @staticmethod
    def _carry(x: torch.Tensor, device) -> tuple[torch.Tensor, int]:
        """A chunk of another part on ``device`` and the bytes it carried; a
        replicated chunk (a limb-cluster dim of stride 0: every cluster
        holds the same words) travels once and is expanded on arrival."""
        replicated = x.shape[0] > 1 and x.stride(0) == 0
        t = x[:1] if replicated else x
        if t.device != device:
            t = t.to(device, non_blocking=True)
        nbytes = t.numel() * t.element_size()
        return (t.expand(x.shape) if replicated else t), nbytes

    def all_to_all(self, x, axis: str, split: int, concat: int):
        """Tiled all-to-all along ``axis``: block a splits its local dim
        ``split`` into n chunks and sends chunk a′ to block a′, which
        concatenates what it receives along its local dim ``concat`` in the
        order of the senders.  ``split``/``concat`` are negative local dims.
        A new buffer; each block moves (n − 1)/n of its words to others.  On
        a multi-part mesh ``x`` is the list of parts' blocks; along "coef"
        each part sends the other parts of its grid row their chunks, along
        "limb" the other parts of its grid column (a replicated operand's
        once for all limb clusters, :meth:`_carry`)."""
        xs = x if isinstance(x, list) else [x]
        A, x0 = self._axis(axis), xs[0]
        groups = self._groups(A, len(xs))
        n = x0.shape[A] * len(groups[0])
        s, c = x0.dim() + split, x0.dim() + concat
        if split >= 0 or concat >= 0 or s == c or s < 2 or c < 2:
            raise ValueError(f"all_to_all: split {split}, concat {concat} must "
                             "be distinct negative local dims")
        if x0.shape[s] % n:
            raise ValueError(f"all_to_all: dim {split} of {tuple(x0.shape)} "
                             f"does not split over {n} blocks")
        nbytes = sum(t.numel() for t in xs) * x0.element_size()
        # dim s: the destination block, then its chunk
        ys = [t.unflatten(s, (n, t.shape[s] // n)) for t in xs]
        carried = 0
        out = [None] * len(xs)
        m = x0.shape[A]
        for group in groups:
            for r2, i2 in enumerate(group):
                got = []
                for i in group:
                    piece = ys[i].narrow(s, r2 * m, m) if len(group) > 1 else ys[i]
                    if i != i2:
                        piece, b = self._carry(piece, self.devices[i2])
                        carried += b
                    got.append(piece)
                out[i2] = self._a2a_finish(torch.cat(got, dim=A) if len(got) > 1
                                           else got[0], A, s, c)
        self._record("all_to_all", axis, nbytes * (n - 1) // n, carried)
        return out if isinstance(x, list) else out[0]

    @staticmethod
    def _a2a_finish(y: torch.Tensor, A: int, s: int, c: int) -> torch.Tensor:
        """Dim A the senders and dim s the receivers → the received chunks
        concatenated along ``c`` in the senders' order, a new buffer."""
        c1 = c + 1 if c > s else c
        y = y.transpose(A, s)                             # dim s: source
        dst = c1 - 1 if c1 > s else c1                    # source before concat
        y = y.movedim(s, dst).contiguous()
        return y.flatten(dst, dst + 1)

    def all_gather(self, x, axis: str, dim: int):
        """Tiled all-gather along ``axis``: every block receives the blocks
        of its group concatenated along its local dim ``dim`` (negative), in
        their order.  A new buffer per block; each block receives n − 1
        blocks' words.  On a multi-part mesh ``x`` is the list of parts'
        blocks; each part receives the blocks of the other parts of its grid
        row ("coef") or column ("limb") once (a replicated operand's once
        for all limb clusters)."""
        xs = x if isinstance(x, list) else [x]
        A, x0 = self._axis(axis), xs[0]
        groups = self._groups(A, len(xs))
        n = x0.shape[A] * len(groups[0])
        if dim >= 0 or x0.dim() + dim < 2:
            raise ValueError(f"all_gather: dim {dim} must be a negative local dim")
        d = x0.dim() + dim
        nbytes = sum(t.numel() for t in xs) * x0.element_size()
        carried = 0
        out = [None] * len(xs)
        for group in groups:
            for i2 in group:
                got = []
                for i in group:
                    t = xs[i]
                    if i != i2:
                        t, b = self._carry(t, self.devices[i2])
                        carried += b
                    got.append(t)
                out[i2] = self._gather_finish(torch.cat(got, dim=A) if len(got) > 1
                                              else got[0], A, d, xs[i2].shape[A])
        self._record("all_gather", axis, nbytes * (n - 1), carried)
        return out if isinstance(x, list) else out[0]

    @staticmethod
    def _gather_finish(x: torch.Tensor, A: int, d: int, m: int) -> torch.Tensor:
        """The group's blocks (dim A) concatenated along dim d, for the m
        receiving blocks of this part, a new buffer."""
        g = x.movedim(A, d - 1 if A < d else d)
        g = g.flatten(d - 1, d) if A < d else g.flatten(d, d + 1)
        return g.unsqueeze(A).expand(*x.shape[:A], m, *g.shape[A:]).contiguous()

    # -- limbs between the rows of a grid -----------------------------------------
    def regroup(self, srcs, idx, split: bool):
        """The limbs ``idx`` of the values ``srcs`` concatenated along the
        limb axis (each a :class:`Parts` of this grid, split over its rows
        or replicated), as a value split over the rows (``split``: part
        (a, k) the a-th of ``Dl`` equal slices of ``idx``) or replicated over
        them.  Each part takes what its own row holds from its own part and
        copies the rest from the part of its grid column whose row holds it;
        the copies between parts are one "regroup" along "limb" in the
        tally (none when every part holds what it needs: a local slice)."""
        idx = [int(i) for i in idx]
        ells = [s.shape[-2] for s in srcs]
        where = [(si, j) for si, ell in enumerate(ells) for j in range(ell)]
        if split and len(idx) % self.rows:
            raise _parts.PartsError(f"{len(idx)} limbs do not split over "
                                    f"{self.rows} rows")
        per = len(idx) // self.rows
        carried, out = 0, []
        for i, dev in enumerate(self.devices):
            a, k = divmod(i, self.cols)
            need = idx[a * per:(a + 1) * per] if split else idx
            groups: dict = {}
            for pos, g in enumerate(need):
                si, j = where[g]
                src = srcs[si]
                if src.split:
                    rl = ells[si] // self.rows
                    r, j = divmod(j, rl)
                else:
                    r = a
                groups.setdefault((si, r), []).append((pos, j))
            pieces, order = [], []
            for (si, r), got in groups.items():
                part = srcs[si].parts[r * self.cols + k]
                loc = [j for _, j in got]
                if loc == list(range(loc[0], loc[0] + len(loc))):
                    piece = part[..., loc[0]:loc[0] + len(loc), :]
                else:
                    piece = part.index_select(
                        -2, torch.tensor(loc, dtype=torch.int64, device=part.device))
                if r != a:
                    carried += piece.numel() * piece.element_size()
                    if piece.device != dev:
                        piece = piece.to(dev, non_blocking=True)
                pieces.append(piece)
                order += [pos for pos, _ in got]
            t = torch.cat(pieces, dim=-2) if len(pieces) > 1 else pieces[0]
            if order != sorted(order):
                inv = [0] * len(order)
                for o, pos in enumerate(order):
                    inv[pos] = o
                t = t.index_select(-2, torch.tensor(inv, dtype=torch.int64,
                                                    device=t.device))
            out.append(t)
        if carried:
            self._regroups += 1
            self._part_bytes[("regroup", "limb")] += carried
        return _parts.Parts(out, self.rows, split)

    def replicate(self, x):
        """A value replicated over the grid's rows (a row-split one regrouped
        whole; anything else as it is)."""
        if not (isinstance(x, _parts.Parts) and x.split):
            return x
        return self.regroup([x], range(x.shape[-2]), False)

    # -- the executed tally ---------------------------------------------------
    def executed(self) -> dict:
        """Collectives this mesh's shard bodies executed, per kind."""
        return dict(self._count)

    def bytes_moved(self) -> dict:
        """Bytes the executed collectives moved between distinct blocks,
        whatever part each block is on."""
        return dict(self._bytes)

    def bytes_between_parts(self, axis: str | None = None) -> dict:
        """Bytes copied from one part to another, per kind ("all_to_all",
        "all_gather", and "regroup" for limbs moved between rows), along
        ``axis`` or both (none on a one-part mesh)."""
        return _by_kind(self._part_bytes, axis)

    def snapshot(self) -> tuple:
        return (self.executed(), self.bytes_moved(), dict(self._part_bytes),
                self._regroups)

    def since(self, snap) -> tuple[dict, dict]:
        """(counts, bytes) executed since a :meth:`snapshot` (kinds with no
        change omitted)."""
        c0, b0 = snap[0], snap[1]
        return _delta(self._count, c0), _delta(self._bytes, b0)

    def parts_since(self, snap, axis: str | None = None) -> dict:
        """Bytes between parts since a :meth:`snapshot`, per kind, along
        ``axis`` or both."""
        return _by_kind(_delta(self._part_bytes, snap[2]), axis)

    def regroups_since(self, snap) -> int:
        """Regroups that copied limbs between rows since a :meth:`snapshot`."""
        return self._regroups - snap[3]

    def reset(self) -> None:
        self._count.clear()
        self._bytes.clear()
        self._part_bytes.clear()
        self._regroups = 0


def _by_kind(part_bytes: dict, axis: str | None) -> dict:
    out: collections.Counter = collections.Counter()
    for (kind, ax), v in part_bytes.items():
        if axis is None or ax == axis:
            out[kind] += v
    return {k: v for k, v in out.items() if v}


def _delta(now: collections.Counter, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in now.items() if v - before.get(k, 0)}


# ----------------------------------------------------------------------------
# Layouts (pure numpy, as the reference's)
# ----------------------------------------------------------------------------

def ntt_layout_perm(N: int, R: int) -> np.ndarray:
    """Global permutation mapping natural-order NTT values to the four-step
    k₁-sharded layout: layout[l, r·C+c] = â[r + R·c] concatenated over shards."""
    C = N // R
    k1, k2 = np.meshgrid(np.arange(R), np.arange(C), indexing="ij")
    return (k1 + R * k2).reshape(-1).astype(np.int32)


def coef_layout_perm(N: int, R: int, cs: int) -> np.ndarray:
    """Coefficient-domain layout consumed by the four-step: core j of a limb
    cluster stores (R, C/cs) row-major for n₂ ∈ [j·C/cs, (j+1)·C/cs) (a
    *column slice* of the R×C view).  Returns I with layout[pos] = a[I[pos]].
    Position-wise ops are layout-agnostic, so coefficient-domain polys live
    in this layout for the whole scope."""
    C = N // R
    Cl = C // cs
    j, r, c = np.meshgrid(np.arange(cs), np.arange(R), np.arange(Cl),
                          indexing="ij")
    return (r * C + j * Cl + c).reshape(-1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def dist_layout(N: int, R: int, cs: int, domain: str):
    """(perm, inverse) for the scope's storage layout of one domain:
    ``layout_data[..., p] = natural_data[..., perm[p]]``."""
    perm = (ntt_layout_perm(N, R) if domain == "ntt"
            else coef_layout_perm(N, R, cs))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(N, dtype=np.int32)
    return perm, inv


def _device_layout(N: int, R: int, cs: int, domain: str, device):
    """(perm, inverse) of :func:`dist_layout` as int64 tensors on ``device``."""
    return const_cache.device_table(
        ("dist_layout", N, R, cs, domain),
        lambda: tuple(a.astype(np.int64) for a in dist_layout(N, R, cs, domain)),
        device)


def limbdup_beneficial(n_in_limbs: int, n_out_limbs: int, cm: ClusterMap) -> bool:
    """Paper Eq. 3: #out − #in·(broadcast_overhead − 1) > 0, the overhead
    being the coefficient-cluster size L_c."""
    overhead = cm.coef_cluster_size
    return n_out_limbs - n_in_limbs * (overhead - 1) > 0


# ----------------------------------------------------------------------------
# Shard bodies (shared by the standalone programs and the scope's engine)
# ----------------------------------------------------------------------------

def _fourstep(mesh: Mesh, x, fc: nttm.FourStepConsts, part_fcs: list,
              forward: bool, limb_sharded: bool):
    """The four-step (i)NTT on every block: one phase, ONE all-to-all along
    "coef" (none at cs = 1), the other phase.  x: global (…, ℓ, N) in the
    coefficient layout (forward) or the NTT layout (inverse), a tensor or
    the mesh's parts.  ``fc``: the tables of the whole ring (its R × C
    split); ``part_fcs``: each part's (column-phase, row-phase) tables
    (:func:`const_cache.device_four_step_part`)."""
    lead = x.shape[:-2]
    ell = x.shape[-2]
    R, C, cs = fc.R, fc.C, mesh.cs
    limb_block = ell // mesh.lc if limb_sharded else 0
    blocks = mesh.place(x, limb_sharded)
    first, second = ("fwd_col", "fwd_row") if forward else ("inv_row", "inv_col")

    def phase(name):        # each part's column- or row-phase tables
        return lambda b, t: ntt_ops.ntt_phase(b, t[0] if name.endswith("col") else t[1],
                                              name, limb_block)
    y = mesh.each(phase(first), blocks, part_fcs)
    if cs > 1:                                  # the §III-B shuffle
        if not limb_sharded:    # every cluster computed the same words: send one
            y = mesh.each(lambda b: b[:1].expand(b.shape), y)
        if forward:     # (R, C/cs) column slices → (R/cs, C) row slices
            y = mesh.all_to_all(mesh.each(lambda b: b.unflatten(-1, (R, C // cs)), y),
                                "coef", -2, -1)
        else:           # (R/cs, C) row slices → (R, C/cs) column slices
            y = mesh.all_to_all(mesh.each(lambda b: b.unflatten(-1, (R // cs, C)), y),
                                "coef", -1, -2)
        y = mesh.each(lambda b: b.flatten(-2), y)
    y = mesh.each(phase(second), y, part_fcs)
    return mesh.collect(y, limb_sharded, lead)


def _bconv_ark(mesh: Mesh, x, src, dst):
    """ARK §V-A: all-to-all along "limb" into coefficient scattering, the
    full-table product (one launch over every block of a part), all-to-all
    back (on a grid both exchanges cross the parts of a column)."""
    lead = x.shape[:-2]
    t = mesh.all_to_all(mesh.place(x, True), "limb", -1, -2)   # (ℓ, n/lc)
    out = mesh.each(lambda b: bconv_ops.bconv(b, src, dst), t)
    out = mesh.all_to_all(out, "limb", -2, -1)                 # (K/lc, n)
    return mesh.collect(out, True, lead)


def _bconv_limbdup(mesh: Mesh, x, src, dst, limb_in: bool):
    """Limb duplication §V-A: all-gather the inputs along "limb" (none when
    they are replicated already: every cluster reads the same words), each
    limb cluster its own destination rows, outputs born on their owner; one
    grouped BConv over every limb cluster of a part."""
    lead = x.shape[:-2]
    t = mesh.place(x, limb_in)
    if limb_in and mesh.lc > 1:                 # broadcast within the coef cluster
        t = mesh.all_gather(t, "limb", -2)
    # each part converts into its row's limb clusters' destination rows
    dsts = mesh._row_basis(dst, True) if isinstance(t, list) else [dst]
    out = mesh.each(lambda b, d: bconv_ops.bconv_grouped(b, src, d), t, dsts)
    return mesh.collect(out, True, lead)


def _galois(mesh: Mesh, x, tables: list, limb_sharded: bool):
    """Slot-parallel AutoU: ONE all-gather along "coef" (none at cs = 1),
    then each block gathers its outputs through the conjugated table
    (``tables``: each part's slice)."""
    lead = x.shape[:-2]
    full = mesh.place(x, limb_sharded)
    if mesh.cs > 1:
        full = mesh.all_gather(full, "coef", -1)
    out = mesh.each(auto_ops.automorphism_blocks, full, tables)
    return mesh.collect(out, limb_sharded, lead)


def _part_fcs(mesh: Mesh, basis: tuple[int, ...], N: int, R: int, devices,
              limb_sharded: bool = True) -> list:
    """Each part's (column-phase, row-phase) four-step tables on its card:
    its grid column's slice of the ring, over its row's limbs when the
    blocks are limb-sharded (all limbs otherwise)."""
    return [const_cache.device_four_step_part(b, N, R, i % mesh.cols, mesh.cols, dev)
            for i, (b, dev) in enumerate(zip(mesh._row_basis(basis, limb_sharded),
                                             devices))]


# ----------------------------------------------------------------------------
# Standalone programs (correctness self-test, Fig. 7 traffic)
# ----------------------------------------------------------------------------

def dist_ntt(mesh: Mesh, basis: tuple[int, ...], N: int, forward: bool = True):
    """Baseline distributed NTT as a program of x (ℓ, N), limbs split over
    both axes in natural order: all-to-all (limbs ↔ coefficients) along
    "coef", the full-row NTT of every block's limbs, all-to-all back."""
    basis = tuple(basis)

    if mesh.n_parts > 1:
        raise ValueError(f"the baseline NTT program runs on a one-part mesh, not {mesh}")

    def program(x: torch.Tensor) -> torch.Tensor:
        ell = x.shape[-2]
        y = mesh.all_to_all(mesh.place(x, True), "coef", -2, -1)  # (ℓ/(lc·cs), N)
        rows = y.reshape(ell, N)                # blocks' limbs in global order
        f = ntt_ops.ntt_fwd if forward else ntt_ops.ntt_inv
        y = f(rows, basis).reshape(y.shape)
        y = mesh.all_to_all(y, "coef", -1, -2)
        return mesh.collect(y, True, ())
    return program


def run_dist_ntt(mesh: Mesh, x: torch.Tensor, basis, forward: bool = True):
    return dist_ntt(mesh, tuple(basis), x.shape[-1], forward)(x)


def dist_ntt_fourstep(mesh: Mesh, basis: tuple[int, ...], N: int, R: int,
                      forward: bool = True):
    """The recomposable four-step with ONE mid-transform exchange (§III-B)
    as a program of x (ℓ, N), limbs split over "limb": forward from the
    coefficient layout of :func:`coef_layout_perm` into the k₁-sharded NTT
    layout, the inverse back."""
    basis = tuple(basis)

    def program(x):
        devices = mesh.part_devices(x)
        fc = const_cache.device_four_step_consts(basis, N, R, devices[0])
        return _fourstep(mesh, x, fc, _part_fcs(mesh, basis, N, R, devices),
                         forward, True)
    return program


def run_dist_ntt_fourstep(mesh: Mesh, x: torch.Tensor, basis, R: int,
                          forward: bool = True):
    return dist_ntt_fourstep(mesh, tuple(basis), x.shape[-1], R, forward)(x)


def dist_bconv_ark(mesh: Mesh, x: torch.Tensor, src, dst) -> torch.Tensor:
    """ARK's BConv of x (ℓ, N), limbs split over "limb"."""
    return _bconv_ark(mesh, x, tuple(src), tuple(dst))


def dist_bconv_limbdup(mesh: Mesh, x: torch.Tensor, src, dst) -> torch.Tensor:
    """Limb duplication's BConv of x (ℓ, N), limbs split over "limb"."""
    return _bconv_limbdup(mesh, x, tuple(src), tuple(dst), True)


# ----------------------------------------------------------------------------
# Mapping policies for whole HE ops (bconv.mapping_scope)
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MappingPolicy:
    """How BConv's legs are laid out on the mesh (paper §IV/§V), as
    ``cost_model.bconv_method``'s forcing: ``limb_dup="off"`` is ARK's
    redistribution (coefficient scattering into the table product, then
    back to (limb, coef) blocks), ``"on"`` limb duplication (the inputs
    replicated along "limb", each cluster's outputs born on it)."""
    name: str
    limb_dup: str


ARK_POLICY = MappingPolicy(name="ark-redistribution", limb_dup="off")
LIMBDUP_POLICY = MappingPolicy(name="limb-duplication", limb_dup="on")


def mesh_cluster_map(mesh: Mesh) -> ClusterMap:
    """The block clustering of ``mesh``'s cores on the squarest 2-D package
    that holds them (256 cores in 4 limb clusters: 16x16-BK-8x8), else a
    ``lc × cs`` package of ``1 × cs`` blocks: the limb clusters and block
    size the BConv decision and its prediction read."""
    n, cs = mesh.lc * mesh.cs, mesh.cs
    dx, bh = 1 << ((n.bit_length() - 1) // 2), 1 << ((cs.bit_length() - 1) // 2)
    if dx * (n // dx) == n and bh * (cs // bh) == cs and dx % bh == 0 \
            and (n // dx) % (cs // bh) == 0:
        return ClusterMap(dx, n // dx, bh, cs // bh)
    return ClusterMap(mesh.lc, mesh.cs, 1, mesh.cs)


def mapped_bconv(mesh: Mesh, policy: MappingPolicy, x: torch.Tensor, src, dst):
    """The policy's BConv of a global natural-order (…, ℓ, N) tensor on the
    mesh's logical shards, back to a global natural-order tensor: ARK's two
    all-to-alls along "limb" (:func:`_bconv_ark`) or limb duplication's one
    all-gather (:func:`_bconv_limbdup`), as ``cost_model.bconv_method``
    decides with the policy's ``limb_dup`` (its divisibility fallbacks
    included: "local" runs no collective).  BConv is position-wise in the
    coefficients, so shard j of "coef" holds coefficients [j·N/cs, …) with
    no layout permutation.  The prediction is recorded with
    ``kernels.config.count_collective``; the mesh tallies what it ran."""
    src, dst = tuple(src), tuple(dst)
    N = int(x.shape[-1])
    cm = mesh_cluster_map(mesh)
    method = _cost.bconv_method(cm, len(src), len(dst), N=N, limb_dup=policy.limb_dup)
    for kind, n in _cost.predict_collectives("bconv", cm, n_in=len(src), n_out=len(dst),
                                             N=N, limb_dup=policy.limb_dup).items():
        _kcfg.count_collective(kind, n, shards=cm.n_cores)
    if method == "local":
        mesh.check_device(x)
        return bconv_ops.bconv(x, src, dst)
    if method == "ark":
        return _bconv_ark(mesh, x, src, dst)
    return _bconv_limbdup(mesh, x, src, dst, len(src) % mesh.lc == 0)


# ----------------------------------------------------------------------------
# dist_scope: the sharded engine (paper §IV–§V end to end)
# ----------------------------------------------------------------------------

_dist_var: contextvars.ContextVar = contextvars.ContextVar(
    "dist_ctx", default=None)


@dataclasses.dataclass(frozen=True)
class DistContext:
    """An active cluster map + mesh pair (what :func:`dist_active` returns)."""
    cm: ClusterMap
    mesh: Any

    @property
    def cs(self) -> int:
        """Cores per limb cluster = "coef" axis size = block size."""
        return self.cm.block_size

    @property
    def lc(self) -> int:
        """Limb-cluster count = "limb" axis size = coefficient-cluster size."""
        return self.cm.n_limb_clusters

    def submodules(self, N: int) -> int:
        """Four-step R for this N: balanced √N, grown until the single-
        exchange dataflow divides (R % cs == 0 and C % cs == 0)."""
        R = max(nttm.balanced_submodules(N), self.cs)
        while R < N and (N // R) % self.cs:
            R *= 2
        if R >= N or R % self.cs or (N // R) % self.cs:
            raise ValueError(
                f"block size {self.cs} too large for N={N}: no R×C split "
                f"with R % {self.cs} == 0 and C % {self.cs} == 0")
        return R

    def limb_sharded(self, ell: int) -> bool:
        """Whether an ℓ-limb operand splits evenly over the "limb" axis;
        when it does not (rescale drops one limb at a time), it is
        replicated along "limb"."""
        return self.lc == 1 or ell % self.lc == 0


class dist_scope:
    """Activate the sharded engine for a ClusterMap (or its notation, e.g.
    ``"2x4-BK-1x2"``) on a mesh of logical shards::

        with dist_scope("2x4-BK-1x2", device="cuda") as ctx:
            dk = shard_keyset(keys, ctx)
            dct = shard_ciphertext(ct, ctx)
            out = unshard_ciphertext(ckks.hmult(dct, dct2, dk), ctx)

    ``devices`` (a sequence of D devices, D dividing the block size) splits
    the mesh's coefficient axis over them: ``["cuda:0", "cuda:1"]``, or
    ``["cuda:0"] * 4`` for four parts of one card; a grid of Dl rows of Dc
    devices (Dl dividing the limb clusters) splits both axes:
    ``[["cuda:0", "cuda:1"], ["cuda:2", "cuda:3"]]``, ``[["cpu"] * 2] * 2``.
    """

    def __init__(self, cm: ClusterMap | str, mesh: Mesh | None = None,
                 device="cuda", devices=None):
        if isinstance(cm, str):
            cm = ClusterMap.parse(cm)
        if mesh is None:
            mesh = cm.make_mesh(device, devices=devices)
        if (mesh.lc, mesh.cs) != (cm.n_limb_clusters, cm.block_size):
            raise ValueError(f"{mesh} does not hold cluster map {cm.name}")
        self.ctx = DistContext(cm=cm, mesh=mesh)

    def __enter__(self) -> DistContext:
        self._tok = _dist_var.set(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        _dist_var.reset(self._tok)
        return False


def dist_active() -> DistContext | None:
    """The innermost active :class:`dist_scope` context (None outside one)."""
    return _dist_var.get()


def _require() -> DistContext:
    ctx = _dist_var.get()
    if ctx is None:
        raise RuntimeError("no dist_scope is active")
    return ctx


# -- scope-boundary layout conversion ----------------------------------------

def shard_poly(p, ctx: DistContext | None = None):
    """Natural-order RnsPoly → layout-permuted RnsPoly on the mesh: on its
    device, or as its parts (part i on the grid's device i; split over the
    grid's rows when its limbs split over the limb clusters)."""
    ctx = ctx or _require()
    mesh = ctx.mesh
    data = p.data.to(mesh.devices[0])
    perm, _ = _device_layout(p.N, ctx.submodules(p.N), ctx.cs, p.domain,
                             data.device)
    return type(p)(mesh.split(data.index_select(-1, perm)), p.basis, p.domain)


def unshard_poly(p, ctx: DistContext | None = None):
    """Layout-permuted RnsPoly → natural-order RnsPoly (on its device; the
    parts of a multi-part value joined on the mesh's first device)."""
    ctx = ctx or _require()
    data = ctx.mesh.join(p.data) if isinstance(p.data, _parts.Parts) else p.data
    _, inv = _device_layout(p.N, ctx.submodules(p.N), ctx.cs, p.domain,
                            data.device)
    return type(p)(data.index_select(-1, inv), p.basis, p.domain)


def shard_ciphertext(ct, ctx: DistContext | None = None):
    return dataclasses.replace(ct, a=shard_poly(ct.a, ctx),
                               b=shard_poly(ct.b, ctx))


def unshard_ciphertext(ct, ctx: DistContext | None = None):
    return dataclasses.replace(ct, a=unshard_poly(ct.a, ctx),
                               b=unshard_poly(ct.b, ctx))


def shard_eval_key(ek, ctx: DistContext | None = None):
    """EvalKey with every digit poly permuted into the scope's NTT layout
    (and split into the mesh's parts, each on its card).

    The PRNG a-halves are expanded first (natural order, as keygen made
    them) and stored sharded; the key keeps the map, so an a-half
    regenerated after its cache was dropped is sharded too.
    """
    ctx = ctx or _require()
    lay = functools.partial(shard_poly, ctx=ctx)
    return dataclasses.replace(ek, b=[lay(p) for p in ek.b],
                               _a_cache=[lay(p) for p in ek.a()],
                               _level_cache=None, layout=lay)


def shard_keyset(keys, ctx: DistContext | None = None):
    """KeySet whose relin and galois keys live in the scope's layout.  None
    of the source's device caches carries over (level slices, the stacked
    galois keys): a natural-order cache inside the scope would be a wrong
    answer.  The secret key is shared: decryption happens outside."""
    ctx = ctx or _require()
    return dataclasses.replace(
        keys, relin=shard_eval_key(keys.relin, ctx),
        galois={g: shard_eval_key(ek, ctx) for g, ek in keys.galois.items()},
        _stack_cache={})


# -- sharded primitives (the dispatch targets of poly/bconv under a scope) ---

_prog_cache: dict = {}


def _record_prediction(op: str, ctx: DistContext, **kw) -> None:
    for kind, n in _cost.predict_collectives(op, ctx.cm, **kw).items():
        _kcfg.count_collective(kind, n, shards=ctx.cm.n_cores)


def sharded_ntt(ctx: DistContext, x, basis, forward: bool = True):
    """Batched four-step (i)NTT under the scope's mesh — ONE all-to-all.

    ``x``: (…, ℓ, N) in the coefficient layout (forward) or the NTT layout
    (inverse), a tensor or the mesh's parts; leading dims ride through as
    the blocks' batch.
    """
    basis = tuple(basis)
    N = int(x.shape[-1])
    R = ctx.submodules(N)
    limb_sharded = ctx.limb_sharded(int(x.shape[-2]))
    devices = ctx.mesh.part_devices(x)
    key = ("ntt", ctx.mesh, basis, N, R, forward, limb_sharded, devices)
    prog = _prog_cache.get(key)
    if prog is None:
        fc = const_cache.device_four_step_consts(basis, N, R, devices[0])
        prog = functools.partial(_fourstep, ctx.mesh, fc=fc,
                                 part_fcs=_part_fcs(ctx.mesh, basis, N, R, devices,
                                                    limb_sharded),
                                 forward=forward, limb_sharded=limb_sharded)
        _prog_cache[key] = prog
    _record_prediction("ntt" if forward else "intt", ctx)
    return prog(x)


def sharded_bconv(ctx: DistContext, x, src, dst):
    """Mesh-mapped BConv: ARK / limb duplication / local per
    ``cost_model.bconv_method``.  The q̂⁻¹ pre-scale is the BConvU kernel's
    own: it is limb-local, so scaling after the gather gives the
    reference's bytes.  "local" (every core holds all limbs of its
    coefficients: L_c = 1, or a destination count that does not split over
    the limb clusters) is a position-wise product on the global tensor (on
    each part of a multi-part value), as the reference computes it outside
    any shard body; zero collectives."""
    src, dst = tuple(src), tuple(dst)
    N = int(x.shape[-1])
    method = _cost.bconv_method(ctx.cm, len(src), len(dst), N=N)
    _record_prediction("bconv", ctx, n_in=len(src), n_out=len(dst), N=N)
    if method == "local":               # every part reads all limbs of its slice
        ctx.mesh.part_devices(x)
        return _parts.on_each(ctx.mesh.replicate(x),
                              lambda t: bconv_ops.bconv(t, src, dst))
    if method == "ark":
        return _bconv_ark(ctx.mesh, x, src, dst)
    return _bconv_limbdup(ctx.mesh, x, src, dst, ctx.limb_sharded(len(src)))


@functools.lru_cache(maxsize=64)
def _galois_layout_np(N: int, R: int, g: int) -> np.ndarray:
    """The layout-conjugated automorphism table T = L⁻¹∘perm∘L:
    out_layout[p] = in_layout[T[p]] reproduces φ_g on NTT-layout data."""
    from . import poly as _pl
    L = ntt_layout_perm(N, R)
    Linv = np.empty_like(L)
    Linv[L] = np.arange(N, dtype=np.int32)
    return Linv[_pl.automorphism_perm(N, g)[L]].astype(np.int64)


def _galois_layout_table(N: int, R: int, g: int, device) -> torch.Tensor:
    """:func:`_galois_layout_np`, device-staged."""
    return const_cache.device_table(("dist_galois", N, R, g),
                                    lambda: _galois_layout_np(N, R, g), device)


def _galois_part_tables(N: int, R: int, g: int, devices, cols: int) -> list:
    """Each part's slice of the table, positions [k·N/Dc, (k+1)·N/Dc) for
    the part in grid column k, staged on its card (the whole table on a
    one-column mesh)."""
    if cols == 1:
        return [_galois_layout_table(N, R, g, dev) for dev in devices]
    n = N // cols
    return [const_cache.device_table(
        ("dist_galois_part", N, R, g, i % cols, cols),
        lambda k=i % cols: _galois_layout_np(N, R, g)[k * n:(k + 1) * n], dev)
        for i, dev in enumerate(devices)]


def sharded_galois(ctx: DistContext, x, N: int, g: int):
    """Slot-parallel automorphism: ONE all-gather along "coef", then each
    block gathers its outputs through the layout-conjugated perm table."""
    R = ctx.submodules(N)
    devices = ctx.mesh.part_devices(x)
    tables = _galois_part_tables(N, R, g, devices, ctx.mesh.cols)
    limb_sharded = ctx.limb_sharded(int(x.shape[-2]))
    key = ("auto", ctx.mesh, N, limb_sharded)
    prog = _prog_cache.get(key)
    if prog is None:
        prog = functools.partial(_galois, ctx.mesh, limb_sharded=limb_sharded)
        _prog_cache[key] = prog
    _record_prediction("auto", ctx)
    return prog(x, tables)
