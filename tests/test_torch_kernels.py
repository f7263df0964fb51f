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

@pytest.mark.parametrize("op", elt_ops.OPS)
def test_eltwise_plain_vs_jax_kernel(op):
    basis = tuple(jrns.gen_ntt_primes(3, N))
    xs = [rand(basis, (2,), seed=i) for i in range(elt_ops.ARITY[op])]
    want = elt_ref.eltwise_ref(op, basis, *xs)
    jax_out = np.asarray(jelt.eltwise(op, basis, *map(jnp.asarray, xs),
                                      interpret=True))
    got = elt_ops.eltwise(op, basis, *map(t, xs))
    np.testing.assert_array_equal(jax_out, want)
    np.testing.assert_array_equal(u32(got), want)


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
