"""The port's CUDA kernels on the card, against their plain torch versions.

Needs a CUDA card and ``nvcc``; every test skips itself without a card.  Run
on the GPU machine with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Imports nothing of JAX.  Each kernel must equal its plain version exactly,
including past the 15 raw products after which a u64 sum would overflow, and
the whole CKKS pipeline must give the same bytes on the card as on the CPU.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core import ckks, const_cache, encoding as enc, keys as K
from repro_torch.core import ntt as nttm, params as prm, poly as pl, rns
from repro_torch.kernels import config
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


@pytest.mark.parametrize("op", elt_ops.OPS)
def test_eltwise_kernel(dev, op):
    basis = tuple(rns.gen_ntt_primes(4, N))
    xs = [pl.to_tensor(rand(basis, (2,), seed=i), dev)
          for i in range(elt_ops.ARITY[op])]
    q = const_cache.device_q(basis, dev)
    config.reset_launches()
    got = elt_ops.eltwise(op, basis, *(x.transpose(0, 1).contiguous()
                                       .transpose(0, 1) for x in xs))
    assert config.launch_counts() == {"eltwise": 1}
    assert torch.equal(got, elt_ops.eltwise_plain(op, q, *xs))


def residue_words(basis, lead, n, seed):
    """u32 residues (*lead, ℓ, n), uniform per limb; the first row of the
    first batch element holds the largest residues q − 1."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, q, (*lead, n), dtype=np.int64) for q in basis],
                 axis=len(lead))
    x.reshape(-1, len(basis), n)[0] = np.array(basis)[:, None] - 1
    return x.astype(np.uint32)


@pytest.mark.parametrize("n", [1 << 11, 1 << 16])
@pytest.mark.parametrize("B", [1, 3, 4])
@pytest.mark.parametrize("K", [1, 5, 46])
@pytest.mark.parametrize("ell", [1, 10, 12, 15, 16, 18])
def test_bconv_kernel(dev, ell, K, B, n):
    """The whole BConv, q̂⁻¹ pre-scale inside the kernel, against the plain
    version and the numpy oracle: ℓ on both sides of the 15 products a u64
    holds and of the template limit 16, one batch element of largest
    residues, and a strided view with two leading dims."""
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
    q = const_cache.device_q(basis, dev)
    x = torch.zeros((2, N), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        elt_ops.eltwise_cuda("add", q, x, x)


@pytest.mark.parametrize("engine", ["fused", "eager"])
def test_pipeline_same_bytes_on_card_and_cpu(dev, engine):
    p = prm.test_small()
    z = np.linspace(-1, 1, 8) + 0.5j
    out = {}
    for device in ("cpu", dev):
        keys = K.keygen(p, rotations=(1, 4), seed=0, device=device)
        scale = float(p.q[-1])
        ct = K.encrypt(enc.encode(z, scale, p.q, p.N), scale, keys.sk, p.q, p.N,
                       device=device)
        with ckks.use_engine(engine):
            r = ckks.rescale(ckks.hmult(ct, ct, keys), p)
            out[str(device)] = [r] + ckks.hrot_hoisted(r, [1, 4], keys)
    for a, b in zip(out["cpu"], out[str(dev)], strict=True):
        assert torch.equal(a.a.data, b.a.data.cpu())
        assert torch.equal(a.b.data, b.b.data.cpu())
