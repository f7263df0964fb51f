"""The port's four-step NTT against the JAX package, at small sizes on the CPU.

The four-step tables, the plain four-step transform (the NTT kernel's plain
version) at every valid R, and the ``ntt_fwd``/``ntt_inv`` wrappers on CPU
tensors against the reference's jnp four-step and its Pallas NTT kernel in
interpret mode (as ``tests/test_kernels.py`` runs it), the numpy oracle and
the fused plain transform.  The CUDA kernel itself runs only on a card
(``tests/test_torch_cuda.py``).  Modular arithmetic is exact, so every
comparison is exact equality.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import ntt as jntt  # noqa: E402
from repro.kernels.ntt import ops as jops  # noqa: E402
from repro_torch.core import const_cache, ntt as nttm, poly as pl, rns  # noqa: E402
from repro_torch.kernels import autotune, config  # noqa: E402
from repro_torch.kernels.ntt import ops, ref  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _isolated_autotune_cache(tmp_path):
    autotune.set_cache_path(tmp_path / "autotune.json")
    yield
    autotune.set_cache_path(None)


def rand(basis, N, lead=(1,), seed=0, hi=1):
    """u32 residues (*lead, ℓ, N), uniform in [0, hi·q) per limb."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, hi * q, (*lead, N)) for q in basis], axis=-2)
    return x.astype(np.uint32)


def t(x):
    return pl.to_tensor(x, CPU)


def u32(x):
    return pl.to_numpy(x)


@pytest.mark.parametrize("N,R", [(256, 2), (256, 16), (1024, 32), (1024, 512)])
def test_stacked_four_step_consts_equal_reference(N, R):
    basis = tuple(rns.gen_ntt_primes(3, N))
    a, b = jntt.stacked_four_step_consts(basis, N, R), nttm.stacked_four_step_consts(basis, N, R)
    assert (a.R, a.C) == (b.R, b.C) == (R, N // R)
    for f in b._fields:
        if f in ("R", "C", "col"):
            continue
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert np.asarray(getattr(b, f)).dtype == np.asarray(getattr(a, f)).dtype, f
    for f in b.col._fields:                       # the port's NttConsts fields
        np.testing.assert_array_equal(getattr(a.col, f), getattr(b.col, f), err_msg=f)


@pytest.mark.parametrize("R", [2, 4, 8, 16, 32, 64, 128])
def test_plain_four_step_equals_jax_every_split(R):
    N = 256
    basis = tuple(rns.gen_ntt_primes(2, N))
    x = rand(basis, N, seed=R)
    jfc = jntt.stacked_four_step_consts(basis, N, R)
    want = np.asarray(jax.jit(lambda v: jntt.four_step_ntt(v, jfc))(x))
    back = np.asarray(jax.jit(lambda v: jntt.four_step_intt(v, jfc))(want))
    fc = const_cache.device_four_step_consts(basis, N, R, CPU)
    got = nttm.four_step_ntt(t(x), fc)
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(u32(nttm.four_step_intt(got, fc)), back)
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("N,R", [(128, 4), (128, 16), (128, 32),
                                 (512, 4), (512, 16), (512, 32)])
def test_wrappers_equal_jax_kernel_interpret_and_oracle(N, R):
    basis = tuple(rns.gen_ntt_primes(2, N))
    x = rand(basis, N, lead=(2,), seed=N + R)
    want = ref.ntt_ref(x, basis)
    jax_fwd = np.asarray(jops.ntt_fwd(jnp.asarray(x), basis, R=R, interpret=True))
    got = ops.ntt_fwd(t(x), basis, R=R)
    np.testing.assert_array_equal(jax_fwd, want)
    np.testing.assert_array_equal(u32(got), want)
    jax_inv = np.asarray(jops.ntt_inv(jnp.asarray(want), basis, R=R, interpret=True))
    back = ops.ntt_inv(got, basis, R=R)
    np.testing.assert_array_equal(jax_inv, x)
    np.testing.assert_array_equal(u32(back), x)
    np.testing.assert_array_equal(ref.intt_ref(want, basis), x)


def test_fused_plain_equals_four_step():
    N = 1024
    basis = tuple(rns.gen_ntt_primes(3, N))
    x = t(rand(basis, N, lead=(2,), seed=5))
    c = const_cache.device_ntt_consts(basis, N, CPU)
    fused = nttm.ntt(x, c)
    for R in (2, 32, 512):
        fc = const_cache.device_four_step_consts(basis, N, R, CPU)
        assert torch.equal(nttm.four_step_ntt(x, fc), fused), R
        assert torch.equal(nttm.four_step_intt(fused, fc), nttm.intt(fused, c)), R
    assert torch.equal(nttm.intt(fused, c), x)


def test_inputs_below_2q_give_the_reduced_output():
    """Values in [q, 2q) transform like their reduced form, in both forms."""
    N = 256
    basis = tuple(rns.gen_ntt_primes(2, N))
    lazy = rand(basis, N, lead=(2,), seed=9, hi=2)
    q = np.array(basis, dtype=np.uint32)[:, None]
    assert (lazy >= q).any()
    reduced = t(lazy % q)
    c = const_cache.device_ntt_consts(basis, N, CPU)
    for fwd, fused in ((ops.ntt_fwd, nttm.ntt), (ops.ntt_inv, nttm.intt)):
        want = fused(reduced, c)
        assert torch.equal(fused(t(lazy), c), want)
        for R in (4, 16, 64):
            assert torch.equal(fwd(t(lazy), basis, R=R), want), R


def test_to_ntt_of_one_limb_slice_view():
    """A one-limb slice of a stacked tensor (rescale's top limb) and a limb
    range of a poly transform like their contiguous copies."""
    N = 256
    basis = tuple(rns.gen_ntt_primes(3, N))
    xn = t(rand(basis, N, lead=(2,), seed=3))
    top = pl.RnsPoly(xn[..., -1:, :], basis[-1:], pl.NTT)
    assert not top.data.is_contiguous()
    got = top.to_coeff()
    want = pl.RnsPoly(xn[..., -1:, :].contiguous(), basis[-1:], pl.NTT).to_coeff()
    assert got.data.shape == (2, 1, N)
    assert torch.equal(got.data, want.data)
    assert torch.equal(ops.ntt_inv(top.data, basis[-1:]), want.data)
    head = pl.RnsPoly(xn[0], basis, pl.COEFF).limbs(slice(1, 3))
    assert torch.equal(head.to_ntt().data,
                       ops.ntt_fwd(xn[0, 1:3].contiguous(), basis[1:3]))


def test_cpu_transforms_launch_no_kernel_and_reject_bad_splits():
    N = 256
    basis = tuple(rns.gen_ntt_primes(2, N))
    x = t(rand(basis, N))
    config.reset_launches()
    ops.ntt_inv(ops.ntt_fwd(x, basis), basis)
    pl.RnsPoly(x[0], basis, pl.COEFF).to_ntt().to_coeff()
    assert config.launch_counts() == {} and config.kernel_launch_counts() == {}
    for R in (1, 3, N):
        with pytest.raises(ValueError):
            ops.ntt_fwd(x, basis, R=R)
    with pytest.raises(ValueError):
        ops.ntt_fwd(x, basis[:1])
    assert ops.default_submodules(N) == 16
