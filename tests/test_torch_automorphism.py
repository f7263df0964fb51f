"""The cluster permutation kernels' CPU side.

The multi-permutation and eager kernels stage each source row across a
thread-block cluster; here, without a card: the rule that sizes the cluster
(every word lies in the window of the CTA the kernel reads it from, every
window fits its budget), the plain versions
against the JAX package's ``automorphism_multi_pallas`` and
``automorphism_pallas_eager`` in interpret mode on index tables that are not
Galois tables (uniform, with repeats), and the wrappers' operand checks,
which run before any kernel is built.  The kernels themselves run in
``tests/test_torch_cuda.py``.  Permutations copy words, so every comparison
is exact equality.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.automorphism import kernel as jkernel  # noqa: E402
from repro_torch.core import poly as pl  # noqa: E402
from repro_torch.kernels.automorphism import ops as auto_ops, ref as auto_ref  # noqa: E402

CPU = torch.device("cpu")


def check_plan(N):
    C, S, T = auto_ops.cluster_plan(N)
    budget = auto_ops.WINDOW_BUDGET // 4
    assert C in auto_ops.CLUSTER_SIZES
    assert T >= 4 and T & (T - 1) == 0 and T * C >= N
    assert S == min(N, budget) and min(T, N) <= S
    assert all(min(N, max(4, 1 << (-(-N // c) - 1).bit_length())) > budget
               for c in auto_ops.CLUSTER_SIZES if c < C)      # the smallest C
    # every word lies in the window of CTA w // T, as the kernel reads it
    w = np.arange(N)
    base = np.minimum((w // T) * T, N - S)
    assert (w // T).max() < C
    assert ((w - base >= 0) & (w - base < S)).all()


@pytest.mark.parametrize("logN", range(4, 18))
def test_cluster_plan_covers_the_row_within_budget(logN):
    check_plan(1 << logN)


@pytest.mark.parametrize("N", [3, 1001, 3 << 14, 40001, 100000])
def test_cluster_plan_rows_that_are_not_powers_of_two(N):
    check_plan(N)


def test_cluster_plan_past_the_budget():
    largest = auto_ops.CLUSTER_SIZES[-1] * (1 << (auto_ops.WINDOW_BUDGET // 4).bit_length() - 1)
    check_plan(largest)
    with pytest.raises(ValueError):
        auto_ops.cluster_plan(largest + 1)


def test_cluster_plan_at_the_paper_size():
    """N = 2¹⁶: two CTAs whose windows overlap, so 7/8 of the words are in
    each CTA's own window; a row that fits one CTA takes a cluster of one."""
    assert auto_ops.cluster_plan(1 << 16) == (2, 57344, 32768)
    assert auto_ops.cluster_plan(3 << 14) == (1, 3 << 14, 1 << 16)


def random_table(N, shape, seed):
    """Uniform indices in [0, N) with repeats: not a permutation."""
    perms = np.random.default_rng(seed).integers(0, N, shape, dtype=np.int64)
    assert len(np.unique(perms)) < perms.size
    return perms


def words(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 30, shape).astype(np.uint32)


@pytest.mark.parametrize("G,R,N", [(1, 1, 256), (1, 3, 256), (3, 3, 200)])
def test_multi_plain_vs_jax_kernel_on_random_tables(G, R, N):
    x = words((G, 4, N), seed=G + R)
    perms = random_table(N, (R, N), seed=R)
    jax_out = np.asarray(jkernel.automorphism_multi_pallas(
        jnp.asarray(x), jnp.asarray(perms.astype(np.int32)), interpret=True))
    got = auto_ops.automorphism_multi_plain(pl.to_tensor(x, CPU),
                                            torch.from_numpy(perms))
    want = np.stack([auto_ref.automorphism_ref(x[r if G == R else 0], perms[r])
                     for r in range(R)])
    np.testing.assert_array_equal(jax_out, want)
    np.testing.assert_array_equal(pl.to_numpy(got), want)


@pytest.mark.parametrize("P,N", [(1, 256), (2, 200)])
def test_eager_plain_vs_jax_kernel_on_random_tables(P, N):
    x = words((P, 3, N), seed=P)
    perm = random_table(N, (N,), seed=N)
    jax_out = np.asarray(jkernel.automorphism_pallas_eager(
        jnp.asarray(x), jnp.asarray(perm.astype(np.int32)), interpret=True))
    got = auto_ops.automorphism_eager(pl.to_tensor(x, CPU), torch.from_numpy(perm))
    np.testing.assert_array_equal(jax_out, auto_ref.automorphism_ref(x, perm))
    np.testing.assert_array_equal(pl.to_numpy(got), jax_out)


@pytest.mark.parametrize("fn", [auto_ops.automorphism_multi_plain,
                                auto_ops.automorphism_multi_cuda])
def test_multi_wrappers_reject_bad_operands(fn):
    x = torch.zeros((2, 3, 16), dtype=torch.int32)
    for perms in (torch.zeros((2, 15), dtype=torch.int64),     # N mismatch
                  torch.zeros((16,), dtype=torch.int64),       # not (R, N)
                  torch.zeros((3, 16), dtype=torch.int64)):    # G = 2 ∉ {1, 3}
        with pytest.raises(ValueError):
            fn(x, perms)
    with pytest.raises(ValueError):
        fn(x[0], torch.zeros((2, 16), dtype=torch.int64))      # x not (G, L, N)


def test_galois_many_rejects_a_batch_that_is_neither_one_nor_R():
    x = torch.zeros((2, 3, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        auto_ops.apply_galois_many(x, 16, (3, 5, 7))


@pytest.mark.parametrize("fn", [auto_ops.automorphism_eager_plain,
                                auto_ops.automorphism_eager_cuda])
def test_eager_wrappers_reject_bad_operands(fn):
    x = torch.zeros((2, 3, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        fn(x, torch.zeros((15,), dtype=torch.int64))
    with pytest.raises(ValueError):
        fn(x, torch.zeros((1, 16), dtype=torch.int64))
    with pytest.raises(ValueError):
        fn(x[0], torch.zeros((16,), dtype=torch.int64))
