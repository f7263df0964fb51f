"""Distributed FHE primitives under a ClusterMap (paper §IV–§V), executed.

A **mesh** here is one process and one device holding ``lc × cs`` logical
shards: ``lc`` limb clusters (the "limb" axis) of ``cs`` cores each (the
"coef" axis).  A sharded :class:`~repro_torch.core.poly.RnsPoly` keeps one
global (…, ℓ, N) tensor in the scope's layout; shard (i, j) is the block of
ℓ/lc contiguous limbs by N/cs contiguous coefficients, the block
``P("limb", "coef")`` gives a JAX array.  Where ℓ does not split over the
limb clusters, every cluster reads all ℓ limbs (the operand is replicated
along "limb").  Ring ops outside the shard bodies run on the global tensor.

The shard bodies are written against one block's local shape, with every
block of the mesh as a batch dimension ((lc, cs, B, ℓ_loc, n_loc) tensors),
and read other blocks only through the mesh's collectives:

* the four-step NTT's column and row phases (``kernels.ntt.ops.ntt_phase``),
  ONE ``all_to_all`` along "coef" between them (the §III-B shuffle);
* the BConv table product (``kernels.bconv.ops.bconv``): ARK's method
  (§V-A) — an ``all_to_all`` along "limb" into coefficient scattering, the
  full table, an ``all_to_all`` back — or limb duplication — an
  ``all_gather`` of the inputs along "limb", each limb cluster its own
  destination rows (one grouped launch over every cluster,
  ``bconv_ops.bconv_grouped``), no output collective — or "local" (no collective: every core already holds all limbs
  of its coefficients), chosen per Eq. 3 by ``cost_model.bconv_method``;
* the AutoU gather of the slot-parallel automorphism
  (``kernels.automorphism.ops.automorphism_blocks``) after ONE
  ``all_gather`` along "coef".

Each collective materialises its result in a new buffer, so an exchange that
put a chunk in the wrong place gives wrong bytes, and the mesh tallies what it
executed: the kind, the count and the bytes moved between distinct blocks
(:meth:`Mesh.executed`, :meth:`Mesh.bytes_moved`).  Independently, each
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
bytes.  The port of ``repro.core.distributed`` without its XLA sharding
policies and jax version shims.
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
from . import cost_model as _cost
from . import ntt as nttm
from .mapping import ClusterMap

AXES = ("limb", "coef")


# ----------------------------------------------------------------------------
# The mesh of logical shards and its collectives
# ----------------------------------------------------------------------------

class Mesh:
    """``lc × cs`` logical shards on one device, axes ("limb", "coef").

    Sharded values are (lc, cs, …) tensors, dim 0 the limb cluster i and
    dim 1 the core j of the cluster; the rest is one block's local shape.
    """

    def __init__(self, limb: int, coef: int, device="cuda"):
        if limb < 1 or coef < 1:
            raise ValueError(f"mesh axes must be ≥ 1, got limb={limb}, coef={coef}")
        self.shape = {"limb": int(limb), "coef": int(coef)}
        self.device = torch.device(device)
        self._count: collections.Counter = collections.Counter()
        self._bytes: collections.Counter = collections.Counter()

    @property
    def lc(self) -> int:
        return self.shape["limb"]

    @property
    def cs(self) -> int:
        return self.shape["coef"]

    def __repr__(self) -> str:
        return f"Mesh(limb={self.lc}, coef={self.cs}, device={self.device})"

    # -- placement ------------------------------------------------------------
    def check_device(self, t: torch.Tensor) -> None:
        d = self.device
        if t.device.type != d.type or (d.index is not None
                                       and t.device.index != d.index):
            raise ValueError(f"operand on {t.device}, mesh on {d}")

    def place(self, x: torch.Tensor, limb_sharded: bool) -> torch.Tensor:
        """The blocks of a global (…, ℓ, N) tensor as a (lc, cs, B, ℓ_loc,
        N/cs) view (B the leading dims flattened): limbs split over "limb"
        when ``limb_sharded``, else every cluster's view holds all ℓ."""
        self.check_device(x)
        ell, N = x.shape[-2:]
        lc, cs = self.lc, self.cs
        xv = x.reshape(-1, ell, N)
        B = xv.shape[0]
        if limb_sharded:
            return xv.reshape(B, lc, ell // lc, cs, N // cs).permute(1, 3, 0, 2, 4)
        return (xv.reshape(B, ell, cs, N // cs).permute(2, 0, 1, 3)
                .unsqueeze(0).expand(lc, cs, B, ell, N // cs))

    def collect(self, blocks: torch.Tensor, limb_sharded: bool,
                lead: tuple[int, ...]) -> torch.Tensor:
        """The global (*lead, ℓ, N) tensor of (lc, cs, B, ℓ_loc, n_loc)
        blocks; a replicated operand is read from limb cluster 0."""
        lc, cs, B, ell_loc, n = blocks.shape
        if limb_sharded:
            g = blocks.permute(2, 0, 3, 1, 4).reshape(B, lc * ell_loc, cs * n)
        else:
            g = blocks[0].permute(1, 2, 0, 3).reshape(B, ell_loc, cs * n)
        return g.reshape(*lead, g.shape[-2], g.shape[-1])

    # -- collectives -------------------------------------------------------------
    def _axis(self, axis: str) -> int:
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r} — one of {AXES}")
        return AXES.index(axis)

    def _record(self, kind: str, nbytes: int) -> None:
        self._count[kind] += 1
        self._bytes[kind] += int(nbytes)

    def all_to_all(self, x: torch.Tensor, axis: str, split: int,
                   concat: int) -> torch.Tensor:
        """Tiled all-to-all along ``axis``: block a splits its local dim
        ``split`` into n chunks and sends chunk a′ to block a′, which
        concatenates what it receives along its local dim ``concat`` in the
        order of the senders.  ``split``/``concat`` are negative local dims.
        A new buffer; each block moves (n − 1)/n of its words to others."""
        A, n = self._axis(axis), x.shape[self._axis(axis)]
        s, c = x.dim() + split, x.dim() + concat
        if split >= 0 or concat >= 0 or s == c or s < 2 or c < 2:
            raise ValueError(f"all_to_all: split {split}, concat {concat} must "
                             "be distinct negative local dims")
        if x.shape[s] % n:
            raise ValueError(f"all_to_all: dim {split} of {tuple(x.shape)} "
                             f"does not split over {n} blocks")
        y = x.unflatten(s, (n, x.shape[s] // n))          # dim s: destination
        c1 = c + 1 if c > s else c
        y = y.transpose(A, s)                             # dim s: source
        dst = c1 - 1 if c1 > s else c1                    # source before concat
        y = y.movedim(s, dst).contiguous()
        out = y.flatten(dst, dst + 1)
        self._record("all_to_all", x.numel() * x.element_size() * (n - 1) // n)
        return out

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Tiled all-gather along ``axis``: every block receives the blocks
        of its group concatenated along its local dim ``dim`` (negative), in
        their order.  A new buffer per block; each block receives n − 1
        blocks' words."""
        A, n = self._axis(axis), x.shape[self._axis(axis)]
        if dim >= 0 or x.dim() + dim < 2:
            raise ValueError(f"all_gather: dim {dim} must be a negative local dim")
        d = x.dim() + dim
        # (…, n_src, …): the group's blocks in order next to dim d
        g = x.movedim(A, d - 1 if A < d else d)
        g = g.flatten(d - 1, d) if A < d else g.flatten(d, d + 1)
        out = g.unsqueeze(A).expand(*x.shape[:A], n, *g.shape[A:]).contiguous()
        self._record("all_gather", x.numel() * x.element_size() * (n - 1))
        return out

    # -- the executed tally ---------------------------------------------------
    def executed(self) -> dict:
        """Collectives this mesh executed, per kind."""
        return dict(self._count)

    def bytes_moved(self) -> dict:
        """Bytes the executed collectives moved between distinct blocks."""
        return dict(self._bytes)

    def snapshot(self) -> tuple[dict, dict]:
        return self.executed(), self.bytes_moved()

    def since(self, snap: tuple[dict, dict]) -> tuple[dict, dict]:
        """(counts, bytes) executed since a :meth:`snapshot` (kinds with no
        change omitted)."""
        c0, b0 = snap
        counts = {k: v - c0.get(k, 0) for k, v in self._count.items()
                  if v - c0.get(k, 0)}
        nbytes = {k: v - b0.get(k, 0) for k, v in self._bytes.items()
                  if v - b0.get(k, 0)}
        return counts, nbytes

    def reset(self) -> None:
        self._count.clear()
        self._bytes.clear()


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

def _fourstep(mesh: Mesh, x: torch.Tensor, fc: nttm.FourStepConsts,
              forward: bool, limb_sharded: bool) -> torch.Tensor:
    """The four-step (i)NTT on every block: one phase, ONE all-to-all along
    "coef" (none at cs = 1), the other phase.  x: global (…, ℓ, N) in the
    coefficient layout (forward) or the NTT layout (inverse)."""
    lead = x.shape[:-2]
    ell = x.shape[-2]
    R, C, cs = fc.R, fc.C, mesh.cs
    limb_block = ell // mesh.lc if limb_sharded else 0
    blocks = mesh.place(x, limb_sharded)
    first, second = ("fwd_col", "fwd_row") if forward else ("inv_row", "inv_col")
    y = ntt_ops.ntt_phase(blocks, fc, first, limb_block)
    if cs > 1:                                  # the §III-B shuffle
        if forward:     # (R, C/cs) column slices → (R/cs, C) row slices
            y = mesh.all_to_all(y.unflatten(-1, (R, C // cs)), "coef", -2, -1)
        else:           # (R/cs, C) row slices → (R, C/cs) column slices
            y = mesh.all_to_all(y.unflatten(-1, (R // cs, C)), "coef", -1, -2)
        y = y.flatten(-2)
    y = ntt_ops.ntt_phase(y, fc, second, limb_block)
    return mesh.collect(y, limb_sharded, lead)


def _bconv_ark(mesh: Mesh, x: torch.Tensor, src, dst) -> torch.Tensor:
    """ARK §V-A: all-to-all along "limb" into coefficient scattering, the
    full-table product (one launch over every block), all-to-all back."""
    lead = x.shape[:-2]
    t = mesh.all_to_all(mesh.place(x, True), "limb", -1, -2)   # (ℓ, n/lc)
    out = bconv_ops.bconv(t, src, dst)
    out = mesh.all_to_all(out, "limb", -2, -1)                 # (K/lc, n)
    return mesh.collect(out, True, lead)


def _bconv_limbdup(mesh: Mesh, x: torch.Tensor, src, dst,
                   limb_in: bool) -> torch.Tensor:
    """Limb duplication §V-A: all-gather the inputs along "limb" (none when
    they are replicated already: every cluster reads the same words), each
    limb cluster its own destination rows, outputs born on their owner; one
    grouped BConv over every limb cluster."""
    lead = x.shape[:-2]
    t = mesh.place(x, limb_in)
    if limb_in and mesh.lc > 1:                 # broadcast within the coef cluster
        t = mesh.all_gather(t, "limb", -2)
    return mesh.collect(bconv_ops.bconv_grouped(t, src, dst), True, lead)


def _galois(mesh: Mesh, x: torch.Tensor, table: torch.Tensor,
            limb_sharded: bool) -> torch.Tensor:
    """Slot-parallel AutoU: ONE all-gather along "coef" (none at cs = 1),
    then each block gathers its outputs through the conjugated table."""
    lead = x.shape[:-2]
    full = mesh.place(x, limb_sharded)
    if mesh.cs > 1:
        full = mesh.all_gather(full, "coef", -1)
    out = auto_ops.automorphism_blocks(full, table)
    return mesh.collect(out, limb_sharded, lead)


# ----------------------------------------------------------------------------
# Standalone programs (correctness self-test, Fig. 7 traffic)
# ----------------------------------------------------------------------------

def dist_ntt(mesh: Mesh, basis: tuple[int, ...], N: int, forward: bool = True):
    """Baseline distributed NTT as a program of x (ℓ, N), limbs split over
    both axes in natural order: all-to-all (limbs ↔ coefficients) along
    "coef", the full-row NTT of every block's limbs, all-to-all back."""
    basis = tuple(basis)

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

    def program(x: torch.Tensor) -> torch.Tensor:
        fc = const_cache.device_four_step_consts(basis, N, R, x.device)
        return _fourstep(mesh, x, fc, forward, True)
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
    """

    def __init__(self, cm: ClusterMap | str, mesh: Mesh | None = None,
                 device="cuda"):
        if isinstance(cm, str):
            cm = ClusterMap.parse(cm)
        if mesh is None:
            mesh = cm.make_mesh(device)
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
    """Natural-order RnsPoly → layout-permuted RnsPoly on the mesh's device."""
    ctx = ctx or _require()
    data = p.data.to(ctx.mesh.device)
    perm, _ = _device_layout(p.N, ctx.submodules(p.N), ctx.cs, p.domain,
                             data.device)
    return type(p)(data.index_select(-1, perm), p.basis, p.domain)


def unshard_poly(p, ctx: DistContext | None = None):
    """Layout-permuted RnsPoly → natural-order RnsPoly (same device)."""
    ctx = ctx or _require()
    _, inv = _device_layout(p.N, ctx.submodules(p.N), ctx.cs, p.domain,
                            p.data.device)
    return type(p)(p.data.index_select(-1, inv), p.basis, p.domain)


def shard_ciphertext(ct, ctx: DistContext | None = None):
    return dataclasses.replace(ct, a=shard_poly(ct.a, ctx),
                               b=shard_poly(ct.b, ctx))


def unshard_ciphertext(ct, ctx: DistContext | None = None):
    return dataclasses.replace(ct, a=unshard_poly(ct.a, ctx),
                               b=unshard_poly(ct.b, ctx))


def shard_eval_key(ek, ctx: DistContext | None = None):
    """EvalKey with every digit poly permuted into the scope's NTT layout.

    The PRNG a-halves are expanded first (natural order, as keygen made
    them) and stored permuted; the key keeps the layout, so an a-half
    regenerated after its cache was dropped is permuted too.
    """
    ctx = ctx or _require()
    N = ek.b[0].N
    dev = ctx.mesh.device
    perm, _ = _device_layout(N, ctx.submodules(N), ctx.cs, "ntt", dev)
    lay = lambda p: type(p)(p.data.to(dev).index_select(-1, perm), p.basis,
                            p.domain)
    return dataclasses.replace(ek, b=[lay(p) for p in ek.b],
                               _a_cache=[lay(p) for p in ek.a()],
                               _level_cache=None, layout=perm)


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


def sharded_ntt(ctx: DistContext, x: torch.Tensor, basis, forward: bool = True):
    """Batched four-step (i)NTT under the scope's mesh — ONE all-to-all.

    ``x``: (…, ℓ, N) in the coefficient layout (forward) or the NTT layout
    (inverse); leading dims ride through as the blocks' batch.
    """
    basis = tuple(basis)
    N = int(x.shape[-1])
    R = ctx.submodules(N)
    limb_sharded = ctx.limb_sharded(int(x.shape[-2]))
    key = ("ntt", ctx.mesh, basis, N, R, forward, limb_sharded, x.device)
    prog = _prog_cache.get(key)
    if prog is None:
        fc = const_cache.device_four_step_consts(basis, N, R, x.device)
        prog = functools.partial(_fourstep, ctx.mesh, fc=fc, forward=forward,
                                 limb_sharded=limb_sharded)
        _prog_cache[key] = prog
    _record_prediction("ntt" if forward else "intt", ctx)
    return prog(x)


def sharded_bconv(ctx: DistContext, x: torch.Tensor, src, dst):
    """Mesh-mapped BConv: ARK / limb duplication / local per
    ``cost_model.bconv_method``.  The q̂⁻¹ pre-scale is the BConvU kernel's
    own: it is limb-local, so scaling after the gather gives the
    reference's bytes.  "local" (every core holds all limbs of its
    coefficients: L_c = 1, or a destination count that does not split over
    the limb clusters) is a position-wise product on the global tensor, as
    the reference computes it outside any shard body; zero collectives."""
    src, dst = tuple(src), tuple(dst)
    N = int(x.shape[-1])
    method = _cost.bconv_method(ctx.cm, len(src), len(dst), N=N)
    _record_prediction("bconv", ctx, n_in=len(src), n_out=len(dst), N=N)
    if method == "local":
        return bconv_ops.bconv(x, src, dst)
    if method == "ark":
        return _bconv_ark(ctx.mesh, x, src, dst)
    return _bconv_limbdup(ctx.mesh, x, src, dst, ctx.limb_sharded(len(src)))


def _galois_layout_table(N: int, R: int, g: int, device) -> torch.Tensor:
    """Device-staged layout-conjugated automorphism table T = L⁻¹∘perm∘L:
    out_layout[p] = in_layout[T[p]] reproduces φ_g on NTT-layout data."""
    def build():
        from . import poly as _pl
        L = ntt_layout_perm(N, R)
        Linv = np.empty_like(L)
        Linv[L] = np.arange(N, dtype=np.int32)
        return Linv[_pl.automorphism_perm(N, g)[L]].astype(np.int64)
    return const_cache.device_table(("dist_galois", N, R, g), build, device)


def sharded_galois(ctx: DistContext, x: torch.Tensor, N: int, g: int):
    """Slot-parallel automorphism: ONE all-gather along "coef", then each
    block gathers its outputs through the layout-conjugated perm table."""
    R = ctx.submodules(N)
    T = _galois_layout_table(N, R, g, x.device)
    limb_sharded = ctx.limb_sharded(int(x.shape[-2]))
    key = ("auto", ctx.mesh, N, limb_sharded)
    prog = _prog_cache.get(key)
    if prog is None:
        prog = functools.partial(_galois, ctx.mesh, limb_sharded=limb_sharded)
        _prog_cache[key] = prog
    _record_prediction("auto", ctx)
    return prog(x, T)
