"""The port's CUDA kernels on the card, against their plain torch versions.

Needs a CUDA card and ``nvcc``; every test skips itself without a card.  Run
on the GPU machine with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Imports nothing of JAX.  Each kernel must equal its plain version exactly,
including past the 15 raw products after which a u64 sum would overflow, and
the whole CKKS pipeline must give the same bytes on the card as on the CPU.
"""
import ctypes
import functools
import json
import os

import numpy as np
import pytest
import torch

import torch_serve_wave as W
from repro_torch import interop
from repro_torch.core import ckks, const_cache, encoding as enc, keys as K
from repro_torch.core import modmath as mm, ntt as nttm, params as prm, poly as pl, rns
from repro_torch.kernels import config, native
from repro_torch.kernels.automorphism import ops as auto_ops, ref as auto_ref
from repro_torch.kernels.bconv import ops as bconv_ops, ref as bconv_ref
from repro_torch.kernels.eltwise import ops as elt_ops
from repro_torch.kernels.ntt import ops as ntt_ops

pytestmark = pytest.mark.cuda
N = 1024


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def rand(basis, lead=(), seed=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(lead)) if lead else 1
    out = np.stack([np.stack([rng.integers(0, q, N, dtype=np.int64)
                              for q in basis]) for _ in range(n)])
    return out.astype(np.uint32).reshape(*lead, len(basis), N)


def residue_words(basis, lead, n, seed):
    """u32 residues (*lead, ℓ, n), uniform per limb; the first row of the
    first batch element holds the largest residues q − 1."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, q, (*lead, n), dtype=np.int64) for q in basis],
                 axis=len(lead))
    x.reshape(-1, len(basis), n)[0] = np.array(basis)[:, None] - 1
    return x.astype(np.uint32)


def efu_scalars(basis):
    """Per-limb scalars for scale/subscale: 1, q − 1, and random residues."""
    rng = np.random.default_rng(len(basis))
    sv = np.array([rng.integers(0, q) for q in basis], dtype=np.uint32)
    sv[0], sv[-1] = 1, basis[-1] - 1
    return sv


@pytest.mark.parametrize("op", elt_ops.OPS)
def test_eltwise_kernel(dev, op):
    """Every EFU op on contiguous operands against its plain version, the
    first row of each limb holding the largest residues q − 1."""
    basis = tuple(rns.gen_ntt_primes(4, N))
    xs = [pl.to_tensor(residue_words(basis, (2,), N, seed=i), dev)
          for i in range(elt_ops.ARITY[op])]
    sv = efu_scalars(basis) if op in elt_ops.SCALED else None
    config.reset_launches()
    got = elt_ops.eltwise(op, basis, *xs, scalars=sv)
    assert config.launch_counts() == {"eltwise": 1}
    assert torch.equal(got, elt_ops.eltwise_plain(op, basis, *xs, scalars=sv))


VIEW_KINDS = ("moddown", "rescale", "halves", "expanded", "copied")


def efu_views(kind, basis, n, arity, dev):
    """EFU operands as the pipeline hands them over: the Q-part of a ModDown
    input (4, ℓ + 12, n)[..., :ℓ, :], the head of a rescale input
    (2, ℓ + 1, n)[..., :-1, :], the half k[:, 1] of a (2, 2, ℓ, n) key-switch
    output; an (ℓ, n) operand expanded to (3, ℓ, n), outer stride 0; and a
    (3, ℓ, n) view with rows 3n words apart, which the wrapper copies.
    The others are contiguous with the same leading dims."""
    ell = len(basis)
    words = lambda lead, seed, b=basis: pl.to_tensor(residue_words(b, lead, n, seed), dev)
    if kind == "moddown":
        first = words((4,), 0, basis + tuple(rns.gen_ntt_primes(12, n, exclude=basis)))
        first = first[..., :ell, :]
    elif kind == "rescale":
        first = words((2,), 0, basis + tuple(rns.gen_ntt_primes(1, n, exclude=basis)))
        first = first[..., :-1, :]
    elif kind == "halves":
        first = words((2, 2), 0)[:, 1]
    elif kind == "expanded":
        first = words((), 0).expand(3, ell, n)
    else:
        first = words((3,), 0).transpose(0, 1).contiguous().transpose(0, 1)
    return [first] + [words(tuple(first.shape[:-2]), i) for i in range(1, arity)]


@pytest.mark.parametrize("kind", VIEW_KINDS)
@pytest.mark.parametrize("op", elt_ops.OPS)
def test_eltwise_kernel_on_views(dev, op, kind):
    """Every EFU op on the strided views the pipeline makes, read in place
    (no copy), and on a view that the wrapper must copy (one copy)."""
    basis = tuple(rns.gen_ntt_primes(4, N))
    xs = efu_views(kind, basis, N, elt_ops.ARITY[op], dev)
    sv = efu_scalars(basis) if op in elt_ops.SCALED else None
    config.reset_launches()
    elt_ops.reset_copy_counts()
    got = elt_ops.eltwise(op, basis, *xs, scalars=sv)
    assert config.launch_counts() == {"eltwise": 1}
    assert elt_ops.copy_counts() == ({op: 1} if kind == "copied" else {})
    assert torch.equal(got, elt_ops.eltwise_plain(
        op, basis, *(x.contiguous() for x in xs), scalars=sv))


RING_OPS = {
    "add": lambda a, b, s: a + b,
    "sub": lambda a, b, s: a - b,
    "neg": lambda a, b, s: -a,
    "mul": lambda a, b, s: a * b,
    "mul_scalar": lambda a, b, s: a.mul_scalar(s),
    "sub_scaled": lambda a, b, s: a.sub_scaled(b, s),
}


@pytest.mark.parametrize("op", sorted(RING_OPS))
def test_rnspoly_ring_op_on_card(dev, op):
    """Each RnsPoly ring op on card data is one EFU launch, int32 out, equal
    to the same op on the CPU (the plain modmath path)."""
    basis = tuple(rns.gen_ntt_primes(4, N))
    x, y = (residue_words(basis, (2,), N, seed=s) for s in (1, 2))
    sv = efu_scalars(basis)
    polys = lambda d: [pl.RnsPoly(pl.to_tensor(v, d), basis, pl.NTT) for v in (x, y)]
    config.reset_launches()
    got = RING_OPS[op](*polys(dev), sv)
    assert config.kernel_launch_counts() == {"efu": 1}
    want = RING_OPS[op](*polys("cpu"), sv)
    assert (got.basis, got.domain, got.data.dtype) == (basis, pl.NTT, torch.int32)
    assert torch.equal(got.data.cpu(), want.data)


@pytest.mark.parametrize("n", [1 << 11, 1 << 16])
@pytest.mark.parametrize("B", [1, 3, 4])
@pytest.mark.parametrize("K", [1, 5, 46])
@pytest.mark.parametrize("ell", [1, 10, 12, 15, 16, 17, 18, 32, 33, 48, 60])
def test_bconv_kernel(dev, ell, K, B, n):
    """The whole BConv, q̂⁻¹ pre-scale inside the kernel, against the plain
    version and the numpy oracle: ℓ on both sides of the 15 products a u64
    holds, of each change of coefficients per thread (4 up to ℓ = 16, 2 up
    to 32, 1 up to 64) and past ℓ = 48 (ARK's source), one batch element of
    largest residues, and a strided view with two leading dims."""
    dst = tuple(rns.gen_ntt_primes(K, n))
    src = tuple(rns.gen_ntt_primes(ell, n, exclude=dst))
    x = residue_words(src, (B,), n, seed=ell * K + B)
    tx = pl.to_tensor(x, dev)
    config.reset_launches()
    got = bconv_ops.bconv(tx, src, dst)
    assert config.launch_counts() == {"bconv": 1}
    assert config.kernel_launch_counts() == {"bconvu": 1}
    assert torch.equal(got, bconv_ops.bconv_plain(tx, src, dst))
    np.testing.assert_array_equal(pl.to_numpy(got), bconv_ref.bconv_ref(x, src, dst))
    view = tx.expand(2, *tx.shape).transpose(0, 1)           # (B, 2, ℓ, n)
    assert not view.is_contiguous()
    assert torch.equal(bconv_ops.bconv(view, src, dst),
                       got[:, None].expand(B, 2, K, n))


@pytest.mark.parametrize("B,K,n", [(1, 70, 1 << 16), (2, 70, 1 << 16),
                                   (1, 200, 1 << 16), (3, 70, 1 << 11)])
def test_bconv_kernel_at_planned_chunks(dev, B, K, n):
    """Shapes at which chunk_plan splits the destination primes over the grid
    in other shares than the pipeline's (the last split ragged at some)."""
    dst = tuple(rns.gen_ntt_primes(K, n))
    src = tuple(rns.gen_ntt_primes(12, n, exclude=dst))
    tx = pl.to_tensor(residue_words(src, (B,), n, seed=K + B), dev)
    assert torch.equal(bconv_ops.bconv_cuda(tx, src, dst),
                       bconv_ops.bconv_plain(tx, src, dst))


# (G, shared, Bg, n, ℓ, Kg): limb duplication's grouped launch at the
# distributed engine's shard shapes (n = N/16, N/4 at N = 2¹⁶), then two
# ragged chunks (46 destination primes a group split 16 + 16 + 14)
GROUPED = ([(G, shared, Bg, n, 12, 12) for G in (1, 2, 4) for shared in (False, True)
            for Bg in (1, 2, 4) for n in (1 << 12, 1 << 14)]
           + [(2, False, 4, 1 << 14, 12, 46), (2, True, 4, 1 << 14, 48, 46)])


@pytest.mark.parametrize("G,shared,Bg,n,ell,Kg", GROUPED)
def test_bconv_grouped_kernel(dev, G, shared, Bg, n, ell, Kg):
    """G groups of Bg batch rows, group g into destination primes
    g·Kg … (g+1)·Kg − 1, in one launch, against the per-group plain version
    and the numpy oracle; a shared operand (group stride 0, as
    ``Mesh.place`` gives a replicated one) is read in place."""
    dst = tuple(rns.gen_ntt_primes(G * Kg, n))
    src = tuple(rns.gen_ntt_primes(ell, n, exclude=dst))
    x = residue_words(src, (1 if shared else G, Bg), n, seed=G * Bg + ell + shared)
    tx = pl.to_tensor(x, dev)
    if shared:
        tx = tx.expand(G, Bg, ell, n)
    if Kg == 46:
        resident = bconv_ops.resident_ctas(ell, dev)
        assert Kg % bconv_ops.chunk_plan(G * Bg, Kg, n, resident, bconv_ops.tile_of(ell))
    config.reset_launches()
    bconv_ops.reset_copy_counts()
    got = bconv_ops.bconv_grouped(tx, src, dst)
    assert config.launch_counts() == {"bconv": 1}
    assert bconv_ops.copy_counts() == {}
    assert got.shape == (G, Bg, Kg, n)
    assert torch.equal(got, bconv_ops.bconv_grouped_plain(tx, src, dst))
    for g in range(G):
        np.testing.assert_array_equal(
            pl.to_numpy(got[g]),
            bconv_ref.bconv_ref(x[0 if shared else g], src, dst[g * Kg:(g + 1) * Kg]))


@pytest.mark.parametrize("limb_sharded", [False, True])
@pytest.mark.parametrize("B", [1, 2])
def test_bconv_grouped_kernel_on_mesh_blocks(dev, B, limb_sharded):
    """Limb duplication on a 4 × 4 mesh as the engine runs it: the blocks of a
    replicated operand read through ``Mesh.place``'s view (copied once,
    never once per cluster, where its batch dims flatten to no stride), or
    the all-gathered blocks of a limb-sharded one; one launch, equal to the
    single-device conversion."""
    from repro_torch.core import distributed as D
    n = 1 << 12
    dst = tuple(rns.gen_ntt_primes(48, n))
    src = tuple(rns.gen_ntt_primes(12, n, exclude=dst))
    x = pl.to_tensor(residue_words(src, (B,), n, seed=40 + B), dev)
    mesh = D.Mesh(4, 4, dev)
    config.reset_launches()
    bconv_ops.reset_copy_counts()
    got = D._bconv_limbdup(mesh, x, src, dst, limb_sharded)
    assert config.kernel_launch_counts() == {"bconvu": 1}
    copied = {"bconv": 1} if B > 1 and not limb_sharded else {}
    assert bconv_ops.copy_counts() == copied
    assert torch.equal(got, bconv_ops.bconv_plain(x, src, dst))


@pytest.mark.parametrize("G_is_R", [False, True])
@pytest.mark.parametrize("R", [1, 2, 3])
def test_auto_ks_kernel(dev, R, G_is_R):
    """Against the plain version and the numpy oracle, with the shared (G = 1)
    and per-rotation (G = R) digits, past the 15 digits a u64 holds, at an
    odd number of limbs."""
    G = R if G_is_R else 1
    basis = tuple(rns.gen_ntt_primes(5, N))
    gs = tuple(pl.galois_elt(r, N) for r in (1, 5, -3)[:R])
    exts, evk_a, evk_b = (residue_words(basis, lead, N, seed=s) for s, lead in
                          ((0, (17, G)), (1, (R, 17)), (2, (R, 17))))
    d = lambda x: pl.to_tensor(x, dev)
    config.reset_launches()
    got = auto_ops.auto_ks(d(exts), d(evk_a), d(evk_b), N, gs, basis)
    assert config.launch_counts() == {"auto_ks": 1}
    perms = const_cache.device_galois_perm_stack(N, gs, dev)
    q = const_cache.device_q(basis, dev)
    assert torch.equal(got, auto_ops.auto_ks_plain(d(exts), d(evk_a), d(evk_b),
                                                   perms, q))
    want = auto_ref.auto_ks_ref(exts, evk_a, evk_b, np.stack(
        [pl.automorphism_perm(N, g) for g in gs]), basis)
    np.testing.assert_array_equal(pl.to_numpy(got), want)


# Row lengths of the cluster permutation kernels: a cluster of one CTA holds
# the row (2¹⁰, and 3·2¹⁴ and 40001, which are not powers of two: the first
# takes the 16-byte path, the second the word-by-word one), a cluster of two
# with overlapping windows does (2¹⁶).
PERM_NS = [1 << 10, 1 << 16, 3 << 14, 40001]
PERM_CASES = [(n, kind) for n in PERM_NS for kind in ("galois", "random")
              if kind == "random" or n & (n - 1) == 0]


def perm_table(n, kind, R, seed):
    """(R, n) int64 index rows: Galois tables of rotations 1, 4, -2, or
    uniform indices in [0, n) with repeats."""
    if kind == "galois":
        return np.stack([pl.automorphism_perm(n, pl.galois_elt(r, n))
                         for r in (1, 4, -2)[:R]]).astype(np.int64)
    return np.random.default_rng(seed).integers(0, n, (R, n), dtype=np.int64)


def words(shape, seed):
    """u32 residue-sized words (< 2³⁰) of any shape, as int32 bits."""
    return np.random.default_rng(seed).integers(0, 1 << 30, shape).astype(np.uint32)


@pytest.mark.parametrize("L", [1, 46])
@pytest.mark.parametrize("G_is_R", [False, True])
@pytest.mark.parametrize("R", [1, 2, 3])
@pytest.mark.parametrize("n,kind", PERM_CASES)
def test_automorphism_multi_kernel(dev, n, kind, R, G_is_R, L):
    G = R if G_is_R else 1
    x = words((G, L, n), seed=4)
    perms = perm_table(n, kind, R, seed=5)
    tx, tp = pl.to_tensor(x, dev), torch.from_numpy(perms).to(dev)
    config.reset_launches()
    got = auto_ops.automorphism_multi_cuda(tx, tp)
    assert config.kernel_launch_counts() == {"automorphism_multi": 1}
    assert torch.equal(got, auto_ops.automorphism_multi_plain(tx, tp))
    want = np.stack([auto_ref.automorphism_ref(x[r if G == R else 0], perms[r])
                     for r in range(R)])
    np.testing.assert_array_equal(pl.to_numpy(got), want)
    if kind == "galois" and L == 1:                 # the hoisting entry point
        gs = tuple(pl.galois_elt(r, n) for r in (1, 4, -2)[:R])
        config.reset_launches()
        assert torch.equal(auto_ops.apply_galois_many(tx, n, gs), got)
        assert config.launch_counts() == {"automorphism": 1}


@pytest.mark.parametrize("n,C", [(1 << 10, 1), (40001, 1), (60001, 2),
                                 (1 << 16, 2), (100000, 4), (1 << 17, 4),
                                 (1 << 18, 8)])
def test_every_cluster_size_gives_the_same_permutation(dev, n, C):
    """Both entry points at row lengths for which cluster_plan picks each
    cluster size (60001: two CTAs, the last window clamped to the row's end,
    word by word)."""
    assert auto_ops.cluster_plan(n)[0] == C
    x = pl.to_tensor(words((2, 3, n), seed=6), dev)
    perms = torch.from_numpy(perm_table(n, "random", 2, seed=7)).to(dev)
    assert torch.equal(auto_ops.automorphism_multi_cuda(x, perms),
                       auto_ops.automorphism_multi_plain(x, perms))
    assert torch.equal(auto_ops.automorphism_multi_cuda(x[:1], perms),
                       auto_ops.automorphism_multi_plain(x[:1], perms))
    assert torch.equal(auto_ops.automorphism_eager_cuda(x, perms[0]),
                       auto_ops.automorphism_eager_plain(x, perms[0]))


# Every cluster size the NTT's plan allows at each (log N, split): the
# two-pass kernel's nine cases, each at every valid cluster size.
NTT_SPLITS = {"2": lambda n: 2, "balanced": nttm.balanced_submodules,
              "N/2": lambda n: n // 2}
NTT_CASES = [(logN, split, c) for logN in (10, 11, 16) for split in NTT_SPLITS
             for c in ntt_ops.CLUSTER_SIZES
             if ntt_ops.cluster_ok(1 << logN, NTT_SPLITS[split](1 << logN), c)]


def lazy_residues(basis, lead, n, dev, seed):
    """(*lead, ℓ, n) int32 values in [0, 2q), some of them ≥ q."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = const_cache.device_q(basis, dev)
    x = (torch.randint(0, 2 ** 62, (*lead, len(basis), n), generator=gen,
                       device=dev, dtype=torch.int64) % (2 * q)).to(torch.int32)
    assert bool((x.to(torch.int64) >= q).any())
    return x, q


@pytest.mark.parametrize("logN,split,cluster", NTT_CASES)
def test_ntt_kernel(dev, logN, split, cluster):
    """Forward and inverse against the plain four-step at the same R, on
    inputs in [0, 2q), with several leading dims, ℓ = 1 and a strided view,
    at every cluster size the split allows."""
    n = 1 << logN
    R = NTT_SPLITS[split](n)
    basis = tuple(rns.gen_ntt_primes(3, n))
    x, q = lazy_residues(basis, (2,), n, dev, seed=logN)
    fc = const_cache.device_four_step_consts(basis, n, R, dev)
    config.reset_launches()
    got = ntt_ops.ntt_fwd(x, basis, R=R, cluster=cluster)
    assert config.kernel_launch_counts() == {"ntt_fwd": 1}
    assert torch.equal(got, ntt_ops.ntt_plain(x, fc, True))
    assert torch.equal(got, nttm.ntt(x, const_cache.device_ntt_consts(basis, n, dev)))
    back = ntt_ops.ntt_inv(got, basis, R=R, cluster=cluster)
    assert torch.equal(back, (x.to(torch.int64) % q).to(torch.int32))
    assert torch.equal(ntt_ops.ntt_inv(x, basis, R=R, cluster=cluster),
                       ntt_ops.ntt_plain(x, fc, False))
    top = x[:, -1:, :]                                  # ℓ = 1, strided view
    assert not top.is_contiguous()
    fc1 = const_cache.device_four_step_consts(basis[-1:], n, R, dev)
    for fwd in (True, False):
        f = ntt_ops.ntt_fwd if fwd else ntt_ops.ntt_inv
        assert torch.equal(f(top, basis[-1:], R=R, cluster=cluster),
                           ntt_ops.ntt_plain(top, fc1, fwd))


@pytest.mark.parametrize("n", [1 << 10, 1 << 16])
@pytest.mark.parametrize("R", [2, 4, 8])
def test_ntt_stages_across_ctas_alone(dev, n, R):
    """R = cluster: each CTA holds one row, so every column stage pairs CTAs
    through distributed shared memory and none is local."""
    basis = tuple(rns.gen_ntt_primes(2, n))
    x, q = lazy_residues(basis, (3,), n, dev, seed=R)
    fc = const_cache.device_four_step_consts(basis, n, R, dev)
    got = ntt_ops.ntt_cuda(x, fc, True, R)
    assert torch.equal(got, ntt_ops.ntt_plain(x, fc, True))
    assert torch.equal(ntt_ops.ntt_cuda(got, fc, False, R),
                       (x.to(torch.int64) % q).to(torch.int32))
    assert torch.equal(ntt_ops.ntt_cuda(x, fc, False, R), ntt_ops.ntt_plain(x, fc, False))


def graph_node_types(fn):
    """The types of the nodes one call of ``fn`` enqueues (0: kernel),
    captured into a CUDA graph and read back with the runtime's graph API."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    rt = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert rt.cudaGraphGetNodes(raw, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types


@pytest.mark.parametrize("fwd", [True, False])
def test_ntt_kernel_is_one_launch_without_scratch(dev, fwd):
    """One call: one kernel on the card and nothing else, and no device
    memory but its output."""
    n = 1 << 16
    basis = tuple(rns.gen_ntt_primes(3, n))
    x, _ = lazy_residues(basis, (2,), n, dev, seed=1)
    R = nttm.balanced_submodules(n)
    fc = const_cache.device_four_step_consts(basis, n, R, dev)
    cluster = ntt_ops.cluster_plan(n, R)
    want = ntt_ops.ntt_plain(x, fc, fwd)
    ntt_ops.ntt_cuda(x, fc, fwd, cluster)                # built and warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    got = ntt_ops.ntt_cuda(x, fc, fwd, cluster)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    assert extra == got.numel() * 4, f"{extra} bytes for a {got.numel() * 4}-byte output"
    assert torch.equal(got, want)
    assert graph_node_types(lambda: ntt_ops.ntt_cuda(x, fc, fwd, cluster)) == [0]


def test_to_ntt_on_the_card_runs_the_kernel(dev):
    basis = tuple(rns.gen_ntt_primes(3, N))
    x = pl.to_tensor(rand(basis, (2,), seed=8), dev)
    p = pl.RnsPoly(x, basis, pl.COEFF)
    config.reset_launches()
    fwd = p.to_ntt()
    back = fwd.to_coeff()
    rot = fwd.automorphism_by_gelt(pl.galois_elt(1, N))
    assert config.kernel_launch_counts() == {"ntt_fwd": 1, "ntt_inv": 1,
                                             "automorphism": 1}
    c = const_cache.device_ntt_consts(basis, N, dev)
    assert torch.equal(fwd.data, nttm.ntt(x, c)) and torch.equal(back.data, x)
    perm = const_cache.device_galois_perm(N, pl.galois_elt(1, N), dev)
    assert torch.equal(rot.data, fwd.data.index_select(-1, perm))


@pytest.mark.parametrize("L", [1, 46])
@pytest.mark.parametrize("n,kind", PERM_CASES)
@pytest.mark.parametrize("rows", [1, 3, 4, 32])
def test_single_permutation_kernels(dev, rows, n, kind, L):
    """The batched and the eager (cluster) kernels on (2, L, n) rows."""
    x = words((2, L, n), seed=5)
    perm = perm_table(n, kind, 3, seed=8)[-1]         # Galois: rotation -2
    tx, tp = pl.to_tensor(x, dev), torch.from_numpy(perm).to(dev)
    want = tx.index_select(-1, tp)
    config.reset_launches()
    assert torch.equal(auto_ops.automorphism(tx, tp, rows_per_cta=rows), want)
    assert torch.equal(auto_ops.automorphism_eager(tx, tp), want)
    assert torch.equal(auto_ops.automorphism_eager_plain(tx, tp), want)
    assert config.kernel_launch_counts() == {"automorphism": 1,
                                             "automorphism_eager": 1}
    np.testing.assert_array_equal(pl.to_numpy(want),
                                  auto_ref.automorphism_ref(x, perm))
    if kind == "galois":
        g = pl.galois_elt(-2, n)
        assert torch.equal(auto_ops.apply_galois(tx, n, g, rows_per_cta=rows), want)


def test_kernel_rejects_bad_operands(dev):
    basis = tuple(rns.gen_ntt_primes(2, N))
    x = torch.zeros((2, N), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        elt_ops.eltwise_cuda("add", basis, x, x)
    y = torch.zeros(2 * N + 1, dtype=torch.int32, device=dev)[1:].view(2, N)
    with pytest.raises(ValueError):
        elt_ops.eltwise_cuda("add", basis, y, y)                  # not 16-byte aligned


def guard_plain_ring_ops(monkeypatch):
    """Make the plain ring ops (modmath's addmod, submod, negmod, mulmod and
    the EFU's plain version) raise on card data; CPU data runs them as
    before."""
    for mod, name in ((mm, "addmod"), (mm, "submod"), (mm, "negmod"),
                      (mm, "mulmod"), (elt_ops, "eltwise_plain")):
        def guarded(*args, _fn=getattr(mod, name), _name=name, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError(f"plain {_name} ran on card data")
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, guarded)


@pytest.mark.parametrize("engine", ["fused", "eager"])
def test_pipeline_same_bytes_on_card_and_cpu(dev, engine, monkeypatch):
    """keygen → encrypt → hmult → rescale → hoisted rotations give the same
    bytes on the card as on the CPU, with no plain ring op on card data and
    no operand copied by the EFU wrapper."""
    guard_plain_ring_ops(monkeypatch)
    p = prm.test_small()
    z = np.linspace(-1, 1, 8) + 0.5j
    out = {}
    for device in ("cpu", dev):
        elt_ops.reset_copy_counts()
        keys = K.keygen(p, rotations=(1, 4), seed=0, device=device)
        scale = float(p.q[-1])
        ct = K.encrypt(enc.encode(z, scale, p.q, p.N), scale, keys.sk, p.q, p.N,
                       device=device)
        with ckks.use_engine(engine):
            r = ckks.rescale(ckks.hmult(ct, ct, keys), p)
            out[str(device)] = [r] + ckks.hrot_hoisted(r, [1, 4], keys)
        assert elt_ops.copy_counts() == {}
    for a, b in zip(out["cpu"], out[str(dev)], strict=True):
        assert torch.equal(a.a.data, b.a.data.cpu())
        assert torch.equal(a.b.data, b.b.data.cpu())


def test_mul_monomial_on_card_equals_cpu(dev, monkeypatch):
    """mul_monomial on card data is one EFU ``mul`` per half against the
    staged ψ table, runs no Shoup product there, and gives the CPU's bytes."""
    def guarded(*args, _fn=mm.mulmod_shoup, **kwargs):
        if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            raise AssertionError("plain mulmod_shoup ran on card data")
        return _fn(*args, **kwargs)
    monkeypatch.setattr(mm, "mulmod_shoup", guarded)
    p = prm.test_small()
    keys = K.keygen(p, seed=3, device="cpu")
    scale = float(p.q[-1])
    ct = K.encrypt(enc.encode(np.linspace(-1, 1, 16) + 0.5j, scale, p.q, p.N), scale,
                   keys.sk, p.q, p.N, device="cpu")
    d = interop.ciphertext_to_numpy(ct)
    card = interop.ciphertext_from_numpy(d["a"], d["b"], d["scale"], d["basis"],
                                         d["domain"], device=dev)
    for power in (p.N // 2, 3 * p.N // 2, 5):
        want = ckks.mul_monomial(ct, power)
        config.reset_launches()
        got = ckks.mul_monomial(card, power)
        assert config.kernel_launch_counts() == {"efu": 2}
        assert torch.equal(got.a.data.cpu(), want.a.data)
        assert torch.equal(got.b.data.cpu(), want.b.data)


@functools.lru_cache(maxsize=None)
def boot_params():
    """The card bootstrap's configuration (``chip_smoke.py`` phase bootstrap)."""
    return prm.make_params(N=1 << 14, L=24, K=4, dnum=6)


def card_residues(basis, lead, n, dev, seed):
    """(*lead, ℓ, n) canonical int32 residues generated on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = const_cache.device_q(basis, dev)
    raw = torch.randint(0, 2 ** 62, (*lead, len(basis), n), generator=gen,
                        device=dev, dtype=torch.int64)
    return (raw % q).to(torch.int32)


# case → the launch family its wrapper counts
BOOT_KERNELS = {"ntt_fwd": "ntt", "ntt_inv": "ntt", "ntt_fwd_ext": "ntt",
                "automorphism": "automorphism", "automorphism_multi": "automorphism",
                "bconvu_modup": "bconv", "bconvu_moddown": "bconv", "auto_ks": "auto_ks"}


@pytest.mark.parametrize("kernel", sorted(BOOT_KERNELS))
def test_kernels_at_bootstrap_shapes(dev, kernel):
    """Each kernel at the shapes of the N = 2¹⁴, L = 24 bootstrap (ℓ = 24,
    ℓ + K = 28, digits of 4 primes, 127 baby-step rotations in one launch)
    against its plain version, through the wrapper the path calls."""
    p = boot_params()
    n, q, ext = p.N, p.q, p.q + p.p
    gs = tuple(pl.galois_elt(r, n) for r in range(1, 128))
    config.reset_launches()
    if kernel.startswith("ntt"):
        basis = ext if kernel.endswith("ext") else q
        x, _ = lazy_residues(basis, (1,), n, dev, seed=14)
        fwd = kernel.startswith("ntt_fwd")
        R, _ = ntt_ops.resolve(x, None, None)
        fc = const_cache.device_four_step_consts(basis, n, R, dev)
        got = (ntt_ops.ntt_fwd if fwd else ntt_ops.ntt_inv)(x, basis)
        want = ntt_ops.ntt_plain(x, fc, fwd)
    elif kernel == "automorphism":
        x = card_residues(q, (2,), n, dev, seed=15)
        perm = const_cache.device_galois_perm(n, gs[0], dev)
        got, want = auto_ops.automorphism(x, perm), auto_ops.automorphism_plain(x, perm)
    elif kernel == "automorphism_multi":
        x = card_residues(q, (1,), n, dev, seed=16)
        perms = const_cache.device_galois_perm_stack(n, gs, dev)
        got = auto_ops.apply_galois_many(x, n, gs)
        want = auto_ops.automorphism_multi_plain(x, perms)
    elif kernel.startswith("bconvu"):
        src, dst, B = ((q[:4], q[4:] + p.p, 1) if kernel.endswith("modup")
                       else (p.p, q, 2 * len(gs)))
        x = card_residues(src, (B,), n, dev, seed=17)
        got, want = bconv_ops.bconv(x, src, dst), bconv_ops.bconv_plain(x, src, dst)
    else:
        exts = card_residues(ext, (p.dnum, 1), n, dev, seed=18)
        evk_a, evk_b = (card_residues(ext, (len(gs), p.dnum), n, dev, seed=s)
                        for s in (19, 20))
        got = auto_ops.auto_ks(exts, evk_a, evk_b, n, gs, ext)
        perms = const_cache.device_galois_perm_stack(n, gs, dev)
        want = auto_ops.auto_ks_plain(exts, evk_a, evk_b, perms,
                                      const_cache.device_q(ext, dev))
    assert config.launch_counts() == {BOOT_KERNELS[kernel]: 1}
    assert torch.equal(got, want)


def test_launches_follow_the_operands_card():
    """Every kernel launched on cuda:1 while cuda:0 is current equals its
    plain version there, the cluster kernels included (their shared-memory
    limit is raised per device), and cuda:0 stays current."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    n = 1 << 16
    d1 = torch.device("cuda", 1)
    basis = tuple(rns.gen_ntt_primes(3, n))
    dst = tuple(rns.gen_ntt_primes(2, n, exclude=basis))
    gs = (pl.galois_elt(1, n), pl.galois_elt(4, n))
    with torch.cuda.device(0):
        x = pl.to_tensor(residue_words(basis, (2,), n, seed=1), d1)
        y = pl.to_tensor(residue_words(basis, (2,), n, seed=2), d1)
        ev = [pl.to_tensor(residue_words(basis, (2, 2), n, seed=s), d1) for s in (3, 4)]
        perm = const_cache.device_galois_perm(n, gs[0], d1)
        perms = const_cache.device_galois_perm_stack(n, gs, d1)
        R = nttm.balanced_submodules(n)
        fc = const_cache.device_four_step_consts(basis, n, R, d1)
        cluster = ntt_ops.cluster_plan(n, R)
        pairs = [
            (elt_ops.eltwise_cuda("mul", basis, x, y),
             elt_ops.eltwise_plain("mul", basis, x, y)),
            (ntt_ops.ntt_cuda(x, fc, True, cluster), ntt_ops.ntt_plain(x, fc, True)),
            (ntt_ops.ntt_cuda(x, fc, False, cluster), ntt_ops.ntt_plain(x, fc, False)),
            (auto_ops.automorphism_cuda(x, perm, 4), auto_ops.automorphism_plain(x, perm)),
            (auto_ops.automorphism_eager_cuda(x, perm),
             auto_ops.automorphism_eager_plain(x, perm)),
            (auto_ops.automorphism_multi_cuda(x[:1], perms),
             auto_ops.automorphism_multi_plain(x[:1], perms)),
            (bconv_ops.bconv_cuda(x, basis, dst), bconv_ops.bconv_plain(x, basis, dst)),
            (auto_ops.auto_ks_cuda(x[:, None], ev[0], ev[1], gs, basis),
             auto_ops.auto_ks_plain(x[:, None], ev[0], ev[1], perms,
                                    const_cache.device_q(basis, d1)))]
        torch.cuda.synchronize(d1)
        assert torch.cuda.current_device() == 0
    for got, want in pairs:
        assert got.device == d1 and torch.equal(got, want)


# ------------------------------------------------------- serving slice

# kernel → (its library, its launch function, its launch family)
HOOKED = {"efu": ("eltwise", "efu_launch", "eltwise"),
          "bconvu": ("bconv", "bconv_launch", "bconv"),
          "ntt_fwd": ("ntt", "ntt_fwd_launch", "ntt"),
          "ntt_inv": ("ntt", "ntt_inv_launch", "ntt"),
          "automorphism": ("automorphism", "automorphism_rows_launch", "automorphism"),
          "automorphism_eager": ("automorphism", "automorphism_eager_launch",
                                 "automorphism"),
          "automorphism_multi": ("automorphism", "automorphism_multi_launch",
                                 "automorphism"),
          "auto_ks": ("automorphism", "auto_ks_launch", "auto_ks"),
          "ntt_fwd_col": ("ntt", "ntt_fwd_col_launch", "ntt"),
          "ntt_fwd_row": ("ntt", "ntt_fwd_row_launch", "ntt"),
          "ntt_inv_row": ("ntt", "ntt_inv_row_launch", "ntt"),
          "ntt_inv_col": ("ntt", "ntt_inv_col_launch", "ntt"),
          "automorphism_blocks": ("automorphism", "automorphism_blocks_launch",
                                  "automorphism")}


def hooked_case(kernel, dev):
    """(the kernel's wrapper call, its plain version) at N = 1024."""
    basis = tuple(rns.gen_ntt_primes(3, N))
    x = pl.to_tensor(residue_words(basis, (2,), N, seed=31), dev)
    gs = (pl.galois_elt(1, N), pl.galois_elt(4, N))
    perm = const_cache.device_galois_perm(N, gs[0], dev)
    perms = const_cache.device_galois_perm_stack(N, gs, dev)
    if kernel == "efu":
        return (lambda: elt_ops.eltwise_cuda("mul", basis, x, x),
                lambda: elt_ops.eltwise_plain("mul", basis, x, x))
    if kernel == "bconvu":
        dst = tuple(rns.gen_ntt_primes(2, N, exclude=basis))
        return (lambda: bconv_ops.bconv_cuda(x, basis, dst),
                lambda: bconv_ops.bconv_plain(x, basis, dst))
    if kernel in ("ntt_fwd", "ntt_inv"):
        fwd = kernel == "ntt_fwd"
        R, cluster = ntt_ops.resolve(x, None, None)
        fc = const_cache.device_four_step_consts(basis, N, R, dev)
        return (lambda: ntt_ops.ntt_cuda(x, fc, fwd, cluster),
                lambda: ntt_ops.ntt_plain(x, fc, fwd))
    if kernel == "automorphism":
        return (lambda: auto_ops.automorphism_cuda(x, perm, 4),
                lambda: auto_ops.automorphism_plain(x, perm))
    if kernel == "automorphism_eager":
        return (lambda: auto_ops.automorphism_eager_cuda(x, perm),
                lambda: auto_ops.automorphism_eager_plain(x, perm))
    if kernel == "automorphism_multi":
        return (lambda: auto_ops.automorphism_multi_cuda(x[:1], perms),
                lambda: auto_ops.automorphism_multi_plain(x[:1], perms))
    if kernel.startswith("ntt_") and kernel[4:] in ntt_ops.PHASES:
        phase = kernel[4:]
        fc = const_cache.device_four_step_consts(basis, N, 32, dev)
        blocks = x.reshape(2, 3, 2, 512).permute(0, 2, 1, 3).unsqueeze(0)
        return (lambda: ntt_ops.ntt_phase_cuda(blocks, fc, phase, 0),
                lambda: ntt_ops.ntt_phase_plain(blocks, fc, phase, 0))
    if kernel == "automorphism_blocks":
        full = x.reshape(1, 1, 2, 3, N).expand(1, 2, 2, 3, N).contiguous()
        return (lambda: auto_ops.automorphism_blocks_cuda(full, perm),
                lambda: auto_ops.automorphism_blocks_plain(full, perm))
    ev = [pl.to_tensor(residue_words(basis, (2, 2), N, seed=s), dev) for s in (32, 33)]
    return (lambda: auto_ops.auto_ks_cuda(x[:, None], ev[0], ev[1], gs, basis),
            lambda: auto_ops.auto_ks_plain(x[:, None], ev[0], ev[1], perms,
                                           const_cache.device_q(basis, dev)))


class HookFault(Exception):
    pass


@pytest.mark.parametrize("kernel", sorted(HOOKED))
def test_launch_hook_runs_before_the_kernel_launches(dev, kernel, monkeypatch):
    """A launch hook that raises stops the wrapper before its kernel is
    launched: no launch function call, no count, no output; without the
    hook the same call launches once and equals the plain version."""
    lib, fn, family = HOOKED[kernel]
    launched = []
    real = getattr(native.lib(lib), fn)
    monkeypatch.setattr(native.lib(lib), fn,
                        lambda *a: launched.append(1) or real(*a))
    call, plain = hooked_case(kernel, dev)
    fired = []

    def hook(fam, n):
        fired.append((fam, n, len(launched)))
        raise HookFault(fam)
    config.reset_launches()
    config.set_launch_hook(hook)
    try:
        with pytest.raises(HookFault):
            call()
    finally:
        config.set_launch_hook(None)
    assert fired == [(family, 1, 0)] and not launched
    assert config.launch_counts() == {}
    got = call()
    assert launched == [1] and config.launch_counts() == {family: 1}
    assert torch.equal(got, plain())


def serve_params():
    return prm.make_params(N=W.CONFIG["N"], L=W.CONFIG["L"], K=W.CONFIG["K"],
                           dnum=W.CONFIG["dnum"])


def test_ks_inner_broadcasts_the_evk_without_a_copy(dev, monkeypatch):
    """hmult_many's relinearization multiplies each (B, ℓ+K, N) digit
    extension by an (ℓ+K, N) evk half: on the card the EFU reads the evk as
    a stride-0 view, copies nothing, and gives the CPU's bytes."""
    guard_plain_ring_ops(monkeypatch)
    p = serve_params()
    d = residue_words(p.q, (3,), p.N, seed=34)
    out = {}
    for device in ("cpu", dev):
        keys = K.keygen(p, seed=0, device=device)
        x = pl.RnsPoly(pl.to_tensor(d, device), p.q, pl.NTT)
        exts = ckks.mod_up_all_digits(x, p)
        elt_ops.reset_copy_counts()
        config.reset_launches()
        out[str(device)] = ckks.ks_inner(exts, keys.relin, p, p.L)
        assert elt_ops.copy_counts() == {}
    assert config.kernel_launch_counts().get("efu", 0) >= 2 * p.dnum
    for a, b in zip(out["cpu"], out[str(dev)], strict=True):
        assert torch.equal(a.data, b.data.cpu())


@pytest.mark.parametrize("engine", ["fused", "eager"])
def test_batched_ops_same_bytes_on_card_and_cpu(dev, engine, monkeypatch):
    """hadd_many (add, sub), pmult_many, hmult_many, square_many,
    rescale_many and hrot_many — equal rotations, as the standard program
    makes, and mixed ones — give the same bytes on the card as on the CPU."""
    guard_plain_ring_ops(monkeypatch)
    p = serve_params()
    out = {}
    for device in ("cpu", dev):
        api = W.port_api(device)
        keys = W.keysets_for(K, p, device=device)["alice"]
        reqs = W.wave(api, p, {"alice": keys}, 3, 40)
        c1s = [r.inputs["x"] for r, _ in reqs]
        c2s = [r.inputs["y"] for r, _ in reqs]
        pts = [api.coeff_poly(api.encode(np.full(4, 0.5 + i), float(p.q[-1]), p.q,
                                         p.N), p.q) for i in range(3)]
        elt_ops.reset_copy_counts()
        with ckks.use_engine(engine):
            prods = ckks.hmult_many(c1s, c2s, keys)
            res = ckks.rescale_many(prods, p)
            out[str(device)] = (
                ckks.hadd_many(c1s, c2s) + ckks.hadd_many(c1s, c2s, sub=True)
                + ckks.pmult_many(c1s, pts, [float(p.q[-1])] * 3) + prods
                + ckks.square_many(c1s, keys) + res
                + ckks.hrot_many(res, [1, 1, 1], keys)
                + ckks.hrot_many(c1s, [1, 0, 1], keys))
        assert elt_ops.copy_counts() == {}
    for a, b in zip(out["cpu"], out[str(dev)], strict=True):
        assert a.scale == b.scale and a.basis == b.basis
        assert torch.equal(a.a.to_ntt().data, b.a.to_ntt().data.cpu())
        assert torch.equal(a.b.to_ntt().data, b.b.to_ntt().data.cpu())


@pytest.mark.parametrize("engine", ["fused", "eager"])
def test_served_wave_same_bytes_on_card_and_cpu(dev, engine, monkeypatch):
    """The mixed wave served batched gives the same bytes on the card as on
    the CPU, the JAX package's recorded digests, and launches the kernels."""
    guard_plain_ring_ops(monkeypatch)
    with open(os.path.join(os.path.dirname(__file__), "torch_serve_ref.json")) as f:
        ref = json.load(f)
    p = serve_params()
    records = {}
    with ckks.use_engine(engine):
        for device in ("cpu", dev):
            keysets = W.keysets_for(K, p, device=device)
            config.reset_launches()
            records[str(device)], reqs, _ = W.serve(W.port_api(device), p,
                                                    keysets, "batched")
            assert all(r.result()["out"].a.device.type == torch.device(device).type
                       for r, _ in reqs)
    launches = config.kernel_launch_counts()
    assert records["cpu"]["outputs"] == records[str(dev)]["outputs"] \
        == ref["engines"][engine]["batched"]["outputs"]
    assert all(launches.get(k, 0) > 0 for k in ("efu", "ntt_fwd", "ntt_inv", "bconvu"))


# ------------------------------------------------------- distributed slice

# the paper's widths: N = 2¹⁶, ℓ = 48; R as the engine picks it for cs
DIST_N = 1 << 16
DIST_CS = (1, 2, 4, 8, 16)


def dist_R(cs, n=DIST_N):
    from repro_torch.core import distributed as D
    from repro_torch.core.mapping import ClusterMap
    return D.DistContext(ClusterMap(1, cs, 1, cs), None).submodules(n)


# (N, limb clusters, B, ℓ per cluster) of the phase kernels' card cases: the
# paper's hmult operands (B = 2), one poly, the served wave's width of 8, the
# non-square split R = 256, C = 128 of N = 2¹⁵, and one limb of one poly on
# one limb cluster, whose launch has fewer CTAs than the card has SMs
PHASE_SHAPES = {"B2": (DIST_N, 4, 2, 12), "B1": (DIST_N, 4, 1, 12),
                "B8": (DIST_N, 4, 8, 12), "N2^15": (DIST_N // 2, 4, 2, 12),
                "small_grid": (DIST_N, 1, 1, 1)}


@pytest.mark.parametrize("shape", PHASE_SHAPES)
@pytest.mark.parametrize("sharded", [True, False])
@pytest.mark.parametrize("phase", ntt_ops.PHASES)
@pytest.mark.parametrize("cs", DIST_CS)
def test_ntt_phase_kernels_at_shard_shapes(dev, cs, phase, sharded, shape):
    """Each phase kernel of the distributed four-step against its plain
    version on the blocks of an (lc, cs) mesh (:data:`PHASE_SHAPES`; at
    "B2" N = 2¹⁶, ℓ = 48, B = 2): the limbs split over the limb clusters
    (read as a strided view of the global tensor) or replicated (a stride-0
    view); one launch each, at :func:`ntt_ops.phase_plan`'s plan."""
    from repro_torch.core import distributed as D
    n, lc, B, ell_loc = PHASE_SHAPES[shape]
    R = dist_R(cs, n)
    ell = lc * ell_loc
    basis = tuple(rns.gen_ntt_primes(ell, n))
    fc = const_cache.device_four_step_consts(basis, n, R, dev)
    x = pl.to_tensor(residue_words(basis, (B,), n, seed=cs), dev)
    mesh = D.Mesh(lc, cs, dev)
    blocks = mesh.place(x, sharded)
    limb_block = ell_loc if sharded else 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = ntt_ops.phase_plan(phase, lc, cs, B, blocks.shape[3], R, n // R, sms)
    if shape == "small_grid":
        assert plan.ctas < sms
    config.reset_launches()
    got = ntt_ops.ntt_phase(blocks, fc, phase, limb_block)
    assert config.kernel_launch_counts() == {f"ntt_{phase}": 1}
    assert torch.equal(got, ntt_ops.ntt_phase_plain(blocks, fc, phase, limb_block))


@pytest.mark.parametrize("cs", DIST_CS)
def test_distributed_ntt_on_card_equals_the_transform(dev, cs):
    """The four phase kernels with the mesh's exchange give the single-device
    kernel's NTT permuted into the scope's layouts, at N = 2¹⁶ on a (4, cs)
    mesh, and the inverse returns the input."""
    from repro_torch.core import distributed as D
    R = dist_R(cs)
    basis = tuple(rns.gen_ntt_primes(8, DIST_N))
    x = pl.to_tensor(residue_words(basis, (), DIST_N, seed=cs), dev)
    cperm, nperm = (torch.as_tensor(D.dist_layout(DIST_N, R, cs, d)[0].astype(np.int64),
                                    device=dev) for d in (pl.COEFF, pl.NTT))
    mesh = D.Mesh(4, cs, dev)
    got = D.run_dist_ntt_fourstep(mesh, x.index_select(-1, cperm), basis, R)
    assert torch.equal(got, ntt_ops.ntt_fwd(x, basis).index_select(-1, nperm))
    back = D.run_dist_ntt_fourstep(mesh, got, basis, R, forward=False)
    assert torch.equal(back, x.index_select(-1, cperm))


@pytest.mark.parametrize("cs", DIST_CS)
def test_automorphism_blocks_kernel_at_shard_shapes(dev, cs):
    """The AutoU gather variant (output rows of N/cs words) against its
    plain version, through the engine's layout-conjugated table, at
    N = 2¹⁶ on a (4, cs) mesh with (B, ℓ) = (2, 12) per block."""
    from repro_torch.core import distributed as D
    R = dist_R(cs)
    table = D._galois_layout_table(DIST_N, R, pl.galois_elt(1, DIST_N), dev)
    basis = tuple(rns.gen_ntt_primes(12, DIST_N))
    rows = pl.to_tensor(residue_words(basis, (4, cs, 2), DIST_N, seed=cs), dev)
    config.reset_launches()
    got = auto_ops.automorphism_blocks(rows, table)
    assert config.kernel_launch_counts() == {"automorphism_blocks": 1}
    assert got.shape == (4, cs, 2, 12, DIST_N // cs)
    assert torch.equal(got, auto_ops.automorphism_blocks_plain(rows, table))


@pytest.mark.parametrize("name", ["2x2-DW", "4x2-BK-1x2", "4x4-BK-2x2",
                                  "4x4-coef-scatter"])
def test_sharded_pipeline_same_bytes_on_card_and_cpu(dev, name, monkeypatch):
    """hmult → rescale → hrot_hoisted([1, 2]) under dist_scope at N = 256
    gives the same digests and collectives on the card as on the CPU, with
    no plain ring op on card data."""
    from repro_torch.core import _dist_selftest as S
    from repro_torch.core.mapping import ClusterMap
    guard_plain_ring_ops(monkeypatch)
    cm = ClusterMap.parse(name)
    p = prm.make_params(N=256, L=8, K=2, dnum=4)
    out = {}
    for device in ("cpu", dev):
        ks, ct1, ct2 = S._make_inputs(p, device=device)
        out[str(device)] = S._pipeline_run(cm, p, ks, ct1, ct2, device)
    assert out["cpu"] == out[str(dev)]


def _card_parts(where):
    """The devices of a mesh split into parts: four parts of cuda:0, or the
    machine's distinct cards (four, or two with two or three)."""
    count = torch.cuda.device_count()
    if where == "parts_of_one_card":
        return ["cuda:0"] * 4
    if count < 2:
        pytest.skip("needs two CUDA cards")
    return [f"cuda:{k}" for k in range(4 if count >= 4 else 2)]


@pytest.mark.parametrize("where", ["parts_of_one_card", "distinct_cards"])
def test_mesh_parts_on_card(dev, where, monkeypatch):
    """The distributed engine with its coefficient axis split into parts on
    the card(s), at N = 256 on every map of 4 and 16 shards whose block size
    the parts divide: each primitive's bytes, collectives and bytes between
    blocks equal the one-part engine's on cuda:0 (the bytes between parts
    their closed form); hmult → rescale → hrot_hoisted([1, 2]) gives the JAX
    package's single-device eager digests with the one-part tallies and the
    CPU parts' bytes between parts, every path kernel launched on every card
    of the mesh, no plain ring op on card data; an operand on other parts
    and a coefficient-mixing op outside the scope raise."""
    from repro_torch.core import _dist_selftest as S, distributed as D
    from repro_torch.core.parts import Parts, PartsError
    guard_plain_ring_ops(monkeypatch)
    devices = _card_parts(where)
    n_parts = len(devices)
    with open(os.path.join(os.path.dirname(__file__), "torch_dist_ref.json")) as f:
        want = json.load(f)["N"]["256"]["engines"]["eager"]
    p = prm.make_params(N=256, L=8, K=2, dnum=4)
    inputs = {d: S._make_inputs(p, device=d) for d in ("cpu", "cuda:0")}
    for cm in S.maps_for_parts(4, n_parts) + S.maps_for_parts(16, n_parts):
        prims = {}
        for devs in (None, devices):
            with D.dist_scope(cm, device="cuda:0", devices=devs) as ctx:
                prims[bool(devs)] = S._prim_checks(ctx, p, np.random.default_rng(11),
                                                   "cuda:0")
        for op, res in prims[True].items():
            one = prims[False][op]
            assert (res["digest"], res["executed"], res["bytes"]) == \
                (one["digest"], one["executed"], one["bytes"]), (cm.name, op)
        config.reset_launches()
        out = S._pipeline_run(cm, p, *inputs["cuda:0"], "cuda:0", devices)
        per_card = config.card_launch_counts()
        one = S._pipeline_run(cm, p, *inputs["cuda:0"], "cuda:0")
        on_cpu = S._pipeline_run(cm, p, *inputs["cpu"], "cpu", ["cpu"] * n_parts)
        assert out["digests"] == want, cm.name
        assert out["executed"] == out["collectives"] == one["executed"], cm.name
        assert out["bytes"] == one["bytes"] and out["part_bytes"] == on_cpu["part_bytes"]
        assert sorted(per_card) == sorted(set(devices)), per_card
        for card, counts in per_card.items():
            for kernel in ("efu", "bconvu", "ntt_fwd_col", "ntt_fwd_row",
                           "ntt_inv_row", "ntt_inv_col", "automorphism_blocks"):
                assert counts.get(kernel, 0) > 0, (cm.name, card, kernel)
    ct = inputs["cuda:0"][1]
    with D.dist_scope("4x4-BK-2x2", devices=devices) as ctx:
        a = D.shard_poly(ct.a, ctx)
        assert isinstance(a.data, Parts) and a.devices == tuple(map(torch.device, devices))
        with pytest.raises(PartsError):
            a + ct.a                                       # a tensor on one card
        if len(set(devices)) > 1:                          # parts on other cards
            swapped = pl.RnsPoly(Parts(a.data.parts[::-1]), a.basis, a.domain)
            with pytest.raises(ValueError):
                D.sharded_ntt(ctx, swapped.data, a.basis, False)
            with pytest.raises(PartsError):
                a + swapped
        else:                                              # another part count
            half = pl.RnsPoly(Parts(a.data.parts[:2]), a.basis, a.domain)
            with pytest.raises(PartsError):
                D.sharded_ntt(ctx, half.data, a.basis, False)
    with pytest.raises(PartsError):
        a.to_coeff()                                       # outside the scope


def test_lm_reduced_on_card_equals_cpu(dev):
    """The LM decoder (reduced qwen3-4b, float32, TF32 off) on the card and
    on the CPU from the same weights: forward logits and a 16-token
    teacher-forced decode within 1e-3, one train step's loss and grad norm
    within 1e-4 relative, the parameters after it within 2·lr.  The decoder
    launches none of the FHE kernels."""
    import torch_lm_check as LC
    from repro_torch.models import registry
    config.reset_launches()
    got = LC.card_vs_cpu(registry.get_config("qwen3_4b").reduced(), dev,
                         train_steps=1)
    assert all(got["ok"].values()), got
    assert config.kernel_launch_counts() == {}
