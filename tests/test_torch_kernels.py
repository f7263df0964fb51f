"""The port's kernel functions against the JAX kernels and the numpy oracles.

Each plain torch version (what the port's wrappers run on CPU tensors) is held
against the JAX package's Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it) and against the independent numpy-int64
``ref`` of its family, at N = 256 and ℓ ≤ 4.  The CUDA kernels themselves run
only on a card (``tests/test_torch_cuda.py``).  Modular arithmetic is exact,
so every comparison is exact equality.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import const_cache as jcc  # noqa: E402
from repro.core import modmath as jmm  # noqa: E402
from repro.core import rns as jrns  # noqa: E402
from repro.kernels.automorphism import ops as jauto  # noqa: E402
from repro.kernels.bconv import kernel as jbconv_kernel  # noqa: E402
from repro.kernels.bconv import ops as jbconv  # noqa: E402
from repro.kernels.eltwise import ops as jelt  # noqa: E402
from repro_torch.core import const_cache, poly as pl  # noqa: E402
from repro_torch.kernels import config  # noqa: E402
from repro_torch.kernels.automorphism import ops as auto_ops, ref as auto_ref  # noqa: E402
from repro_torch.kernels.bconv import ops as bconv_ops, ref as bconv_ref  # noqa: E402
from repro_torch.kernels.eltwise import ops as elt_ops, ref as elt_ref  # noqa: E402

N = 256
CPU = torch.device("cpu")


def rand(basis, lead=(), seed=0):
    """u32 residues of shape (*lead, ℓ, N), uniform per limb."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(lead)) if lead else 1
    out = np.stack([np.stack([rng.integers(0, q, N, dtype=np.int64)
                              for q in basis]) for _ in range(n)])
    return out.astype(np.uint32).reshape(*lead, len(basis), N)


def t(x):
    return pl.to_tensor(x, CPU)


def u32(x):
    return pl.to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------- EFU

@pytest.mark.parametrize("op", elt_ops.REFERENCE_OPS)
def test_eltwise_plain_vs_jax_kernel(op):
    basis = tuple(jrns.gen_ntt_primes(3, N))
    xs = [rand(basis, (2,), seed=i) for i in range(elt_ops.ARITY[op])]
    want = elt_ref.eltwise_ref(op, basis, *xs)
    jax_out = np.asarray(jelt.eltwise(op, basis, *map(jnp.asarray, xs),
                                      interpret=True))
    got = elt_ops.eltwise(op, basis, *map(t, xs))
    np.testing.assert_array_equal(jax_out, want)
    np.testing.assert_array_equal(u32(got), want)


@pytest.mark.parametrize("op", ["neg", "scale", "subscale"])
def test_eltwise_ring_op_plain_vs_reference_modmath(op):
    """The EFU ops the reference computes in jnp: ``negmod``; ``mulmod_shoup``
    with ``rns.shoup`` companions; ``submod`` then ``mulmod_shoup``.  The
    first row of each limb holds q − 1 and the scalars include 1 and q − 1."""
    basis = tuple(jrns.gen_ntt_primes(3, N))
    xs = [rand(basis, (2,), seed=i) for i in range(elt_ops.ARITY[op])]
    xs[0][0, :, :] = np.array(basis, dtype=np.uint32)[:, None] - 1
    sv = np.array([1, 7 << 20, basis[2] - 1], dtype=np.uint32)
    q = jnp.asarray(np.array(basis, dtype=np.uint32)[:, None])
    w = jnp.asarray(sv[:, None])
    ws = jnp.asarray(np.array([[jrns.shoup(int(v), b)] for v, b in zip(sv, basis)],
                              dtype=np.uint32))
    a = jnp.asarray(xs[0])
    if op == "neg":
        want = jmm.negmod(a, q)
    elif op == "scale":
        want = jmm.mulmod_shoup(a, w, ws, q)
    else:
        want = jmm.mulmod_shoup(jmm.submod(a, jnp.asarray(xs[1]), q), w, ws, q)
    got = elt_ops.eltwise(op, basis, *map(t, xs),
                          scalars=sv if op in elt_ops.SCALED else None)
    np.testing.assert_array_equal(u32(got), np.asarray(want))


def test_eltwise_operand_layout():
    """The EFU wrapper's (offset, outer, stride) in words for the views the
    pipeline hands it, read in place; and operands it must copy."""
    n, ell, K = 16, 46, 12
    x = torch.zeros((4, ell + K, n), dtype=torch.int32)
    assert elt_ops.operand_layout(x[..., :ell, :]) == (0, 4, (ell + K) * n)  # ModDown
    xn = torch.zeros((2, ell + 1, n), dtype=torch.int32)
    assert elt_ops.operand_layout(xn[..., :-1, :]) == (0, 2, (ell + 1) * n)  # rescale
    k = torch.zeros((2, 2, ell, n), dtype=torch.int32)
    assert elt_ops.operand_layout(k[:, 0]) == (0, 2, 2 * ell * n)         # ka
    assert elt_ops.operand_layout(k[:, 1]) == (ell * n, 2, 2 * ell * n)   # kb
    assert elt_ops.operand_layout(k[1, 1]) == (3 * ell * n, 1, ell * n)
    assert elt_ops.operand_layout(k) == (0, 4, ell * n)
    assert elt_ops.operand_layout(k[:, :, 0:1]) == (0, 4, ell * n)       # ℓ = 1
    assert elt_ops.operand_layout(k[0].expand(3, 2, ell, n)) is None
    assert elt_ops.operand_layout(k[0, 0].expand(3, ell, n)) == (0, 3, 0)  # repeated
    assert elt_ops.operand_layout(k.transpose(0, 1)) is None              # copied
    assert elt_ops.operand_layout(k[..., :n - 4]) is None
    assert elt_ops.operand_layout(k.transpose(-1, -2)) is None
    odd = torch.zeros((3, 1, 6), dtype=torch.int32)[..., :4]
    assert elt_ops.operand_layout(odd) is None                  # stride 6 words


def test_eltwise_cuda_rejects_bad_operands():
    """Checked before any kernel is built."""
    basis = tuple(jrns.gen_ntt_primes(2, N))
    x = t(rand(basis, (2,)))
    with pytest.raises(TypeError):
        elt_ops.eltwise_cuda("add", basis, x.to(torch.int64), x.to(torch.int64))
    with pytest.raises(ValueError):
        elt_ops.eltwise_cuda("add", basis, x[..., :N - 2], x[..., :N - 2])   # N % 4
    with pytest.raises(ValueError):
        elt_ops.eltwise_cuda("add", basis[:1], x, x)                        # ℓ ≠ |basis|
    with pytest.raises(ValueError):
        elt_ops.eltwise_cuda("scale", basis, x)                             # no scalars
    with pytest.raises(ValueError):
        elt_ops.eltwise_cuda("add", basis, x, x, scalars=np.ones(2, np.uint32))
    with pytest.raises(ValueError):
        elt_ops.eltwise_cuda("scale", basis, x, scalars=np.ones(3, np.uint32))


# ------------------------------------------------------------------ BConv

@pytest.mark.parametrize("ell,K", [(2, 3), (4, 4)])
def test_bconv_matmul_plain_vs_jax_kernel(ell, K):
    dst = tuple(jrns.gen_ntt_primes(K, N))
    src = tuple(jrns.gen_ntt_primes(ell, N, exclude=dst))
    tt = rand(src, (3,), seed=ell)
    c = jcc.device_bconv_consts(src, dst)
    jax_out = np.asarray(jbconv_kernel.bconv_matmul_pallas(
        jnp.asarray(tt), c.table, c.table_shoup, c.q_dst, c.mu_hi, c.mu_lo,
        tile=N, interpret=True))
    tc = const_cache.device_bconv_consts(src, dst, CPU)
    got = bconv_ops.bconv_matmul_plain(t(tt), tc.table, tc.q_dst)
    for b in range(tt.shape[0]):
        want = bconv_ref.bconv_matmul_ref(tt[b], np.asarray(c.table), dst)
        np.testing.assert_array_equal(jax_out[b], want)
        np.testing.assert_array_equal(u32(got)[b], want)


def test_bconv_wrapper_vs_jax_and_ref():
    dst = tuple(jrns.gen_ntt_primes(3, N))
    src = tuple(jrns.gen_ntt_primes(4, N, exclude=dst))
    x = rand(src, (2, 2), seed=7)
    want = bconv_ref.bconv_ref(x.reshape(-1, len(src), N), src, dst)
    jax_out = np.asarray(jbconv.bconv(jnp.asarray(x), src, dst, tile=N,
                                      interpret=True))
    got = bconv_ops.bconv(t(x), src, dst)
    assert got.shape == (2, 2, len(dst), N) and got.dtype == torch.int32
    np.testing.assert_array_equal(jax_out.reshape(want.shape), want)
    np.testing.assert_array_equal(u32(got).reshape(want.shape), want)


def test_bconv_plain_exact_past_sixteen_terms():
    """The sum is exact past the 16 raw products a u64 sum could hold."""
    dst = tuple(jrns.gen_ntt_primes(2, N))
    src = tuple(jrns.gen_ntt_primes(18, N, exclude=dst))
    x = np.stack([np.full(N, q - 1, dtype=np.uint32) for q in src])[None]
    got = bconv_ops.bconv(t(x), src, dst)
    np.testing.assert_array_equal(u32(got)[0], bconv_ref.bconv_ref(x[0], src, dst))


@pytest.mark.parametrize("ell", [12, 48])
def test_bconv_grouped_plain_is_the_per_cluster_stack(ell):
    """G = 4 groups, each into its own Kg = 3 destination primes: the
    per-group stack of bconv_plain and the numpy oracle, for an operand
    shared by the groups (group stride 0) and for a non-contiguous batch
    view; one dispatch per call, on the CPU too."""
    G, Kg = 4, 3
    dst = tuple(jrns.gen_ntt_primes(G * Kg, N))
    src = tuple(jrns.gen_ntt_primes(ell, N, exclude=dst))
    shared = t(rand(src, (2,), seed=ell)).expand(G, 2, ell, N)
    view = t(rand(src, (2, G), seed=ell + 1)).transpose(0, 1)
    assert shared.stride(0) == 0 and not view.is_contiguous()
    for x in (shared, view):
        bconv_ops.reset_dispatch_counts()
        got = bconv_ops.bconv_grouped(x, src, dst)
        assert bconv_ops.dispatch_counts() == {"bconv": 1}
        assert got.shape == (G, 2, Kg, N) and got.dtype == torch.int32
        for g in range(G):
            part = dst[g * Kg:(g + 1) * Kg]
            assert torch.equal(got[g], bconv_ops.bconv_plain(x[g], src, part))
            np.testing.assert_array_equal(u32(got[g]),
                                          bconv_ref.bconv_ref(u32(x[g]), src, part))
    with pytest.raises(ValueError):
        bconv_ops.bconv_grouped(shared[:1].expand(5, 2, ell, N), src, dst)  # 12 % 5


@pytest.mark.parametrize("B,K,N,resident,want", [
    (4, 46, 1 << 16, 396, 16),    # ModDown of a hoisted pair, 3 CTAs × 132 SMs
    (1, 48, 1 << 16, 396, 8),     # ModUp of one digit
    (1, 48, 1 << 16, 264, 12),    # ... at 2 CTAs an SM (ℓ 15–16)
    (1, 70, 1 << 16, 396, 12),    # ragged last split
    (1, 70, 1 << 16, 264, 14),
    (1, 200, 1 << 16, 396, 16),   # at least ⌈K / PLAN_CHUNK⌉ splits
    (64, 46, 1 << 16, 396, 16),
    (1, 1, 1 << 11, 396, 1),
    (3, 5, 1 << 11, 396, 1),
    (0, 4, 1 << 10, 396, 1)])
def test_bconv_chunk_plan(B, K, N, resident, want):
    """Destination primes per CTA: an even share over as many splits as one
    wave of resident CTAs holds, never more than the plan's share."""
    chunk = bconv_ops.chunk_plan(B, K, N, resident)
    assert 1 <= chunk <= min(K, bconv_ops.PLAN_CHUNK)
    assert chunk == want


@pytest.mark.parametrize("ell,tile", [(1, 1024), (16, 1024), (17, 512), (32, 512),
                                      (33, 256), (48, 256), (64, 256)])
def test_bconv_tile_follows_the_held_words(ell, tile):
    """A CTA covers 256 threads × 4, 2 or 1 coefficients as ℓ passes 16 and
    32: the ℓ·V words a thread holds stay at most 64."""
    assert bconv_ops.tile_of(ell) == tile
    assert ell * tile // 256 <= 64
    # ARK's (32, 48, N/16) → 12 at two CTAs an SM: one split of 12 primes
    assert bconv_ops.chunk_plan(32, 12, 1 << 12, 264, bconv_ops.tile_of(48)) == 12


def test_bconv_cuda_rejects_bad_operands():
    """Checked before any kernel is built."""
    dst = tuple(jrns.gen_ntt_primes(2, N))
    src = tuple(jrns.gen_ntt_primes(3, N, exclude=dst))
    with pytest.raises(ValueError):
        bconv_ops.bconv_cuda(t(rand(src[:2], (2,))), src, dst)       # ℓ ≠ |src|
    with pytest.raises(TypeError):
        bconv_ops.bconv_cuda(torch.zeros((2, 3, N), dtype=torch.int64), src, dst)
    with pytest.raises(ValueError):                                  # ℓ > 64
        wide = tuple(jrns.gen_ntt_primes(65, N, exclude=dst))
        bconv_ops.bconv_cuda(torch.zeros((1, 65, N), dtype=torch.int32), wide, dst)


# ------------------------------------------------ AutoU∘KS / multi-perm

def _auto_case(G, R=2, J=3, ell=4, seed=0):
    basis = tuple(jrns.gen_ntt_primes(ell, N))
    gs = tuple(pl.galois_elt(r, N) for r in (1, 5, 3)[:R])
    exts = rand(basis, (J, G), seed=seed)
    evk_a = rand(basis, (R, J), seed=seed + 1)
    evk_b = rand(basis, (R, J), seed=seed + 2)
    perms = np.stack([pl.automorphism_perm(N, g) for g in gs])
    return basis, gs, exts, evk_a, evk_b, perms


@pytest.mark.parametrize("G", [1, 2])
def test_auto_ks_plain_vs_jax_kernel(G):
    basis, gs, exts, evk_a, evk_b, perms = _auto_case(G)
    want = auto_ref.auto_ks_ref(exts, evk_a, evk_b, perms, basis)
    jax_out = np.asarray(jauto.auto_ks(jnp.asarray(exts), jnp.asarray(evk_a),
                                       jnp.asarray(evk_b), N, gs, basis,
                                       interpret=True))
    got = auto_ops.auto_ks(t(exts), t(evk_a), t(evk_b), N, gs, basis)
    np.testing.assert_array_equal(jax_out, want)
    np.testing.assert_array_equal(u32(got), want)


@pytest.mark.parametrize("G", [1, 2])
def test_automorphism_multi_plain_vs_jax_kernel(G):
    basis, gs, exts, _, _, perms = _auto_case(G)
    x = exts[0]                                         # (G, ℓ, N)
    want = np.stack([auto_ref.automorphism_ref(x[r if G > 1 else 0], perms[r])
                     for r in range(len(gs))])
    jax_out = np.asarray(jauto.apply_galois_many(jnp.asarray(x), N, gs,
                                                 interpret=True))
    got = auto_ops.apply_galois_many(t(x), N, gs)
    np.testing.assert_array_equal(jax_out, want)
    np.testing.assert_array_equal(u32(got), want)


def test_auto_ks_cuda_rejects_bad_operands():
    """Checked before any kernel is built: G ∉ {1, R}, evk shapes, the basis,
    and a Galois map with no affine form (N not a power of two)."""
    basis, gs, exts, evk_a, evk_b, _ = _auto_case(1)
    e, a, b = t(exts), t(evk_a), t(evk_b)
    with pytest.raises(ValueError):
        auto_ops.auto_ks_cuda(t(rand(basis, (3, 3))), a, b, gs, basis)
    with pytest.raises(ValueError):
        auto_ops.auto_ks_cuda(e, a[:1], b, gs, basis)
    with pytest.raises(ValueError):
        auto_ops.auto_ks_cuda(e, a, b, gs, basis[:-1])
    with pytest.raises(ValueError):
        auto_ops.auto_ks_cuda(e[..., :N - 1].contiguous(), a[..., :N - 1].contiguous(),
                              b[..., :N - 1].contiguous(), gs, basis)


# --------------------------------------------------------- dispatch rules

def test_cpu_wrappers_launch_no_kernel():
    """CPU tensors take the plain version, and only kernel launches count."""
    config.reset_launches()
    basis, gs, exts, evk_a, evk_b, _ = _auto_case(1)
    elt_ops.eltwise("mul", basis, t(exts[0]), t(exts[1]))
    bconv_ops.bconv(t(exts[0]), basis, tuple(jrns.gen_ntt_primes(2, N,
                                                                  exclude=basis)))
    auto_ops.auto_ks(t(exts), t(evk_a), t(evk_b), N, gs, basis)
    auto_ops.apply_galois_many(t(exts[0]), N, gs)
    assert config.launch_counts() == {}


def test_wrapper_rejects_other_devices():
    basis = tuple(jrns.gen_ntt_primes(2, N))
    x = torch.zeros((2, N), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        elt_ops.eltwise("add", basis, x, x)
    with pytest.raises(ValueError):
        elt_ops.eltwise("mac", basis, x, x)          # wrong arity
