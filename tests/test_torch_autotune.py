"""The port's autotuner and single-permutation wrappers on the CPU.

The autotuner's grids are deterministic and valid, its JSON cache round-trips
through a temporary path, a cold cache gives the defaults (R = √N for the
NTT), and a CPU sweep records a winner that the wrappers then use.  The plain
single and eager permutations equal the JAX package's ``apply_galois`` and
``automorphism_pallas_eager`` in interpret mode, exactly.
"""
import json

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import const_cache as jcc  # noqa: E402
from repro.kernels.automorphism import kernel as jkernel  # noqa: E402
from repro.kernels.automorphism import ops as jauto  # noqa: E402
from repro_torch.core import const_cache, ntt as nttm, poly as pl, rns  # noqa: E402
from repro_torch.kernels import autotune, config  # noqa: E402
from repro_torch.kernels.automorphism import ops as auto_ops, ref as auto_ref  # noqa: E402
from repro_torch.kernels.ntt import ops as ntt_ops  # noqa: E402

CPU = torch.device("cpu")
N = 256


@pytest.fixture(autouse=True)
def cache(tmp_path):
    path = tmp_path / "autotune.json"
    autotune.set_cache_path(path)
    yield path
    autotune.set_cache_path(None)


def rand(basis, lead=(2,), seed=0):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, q, (*lead, N)) for q in basis], axis=-2)
    return x.astype(np.uint32)


@pytest.mark.parametrize("N_,ell", [(256, 2), (2048, 8), (65536, 48)])
def test_candidates_deterministic_and_valid(N_, ell):
    for family in autotune.FAMILIES:
        cands = autotune.candidates(family, N_, ell)
        assert cands == autotune.candidates(family, N_, ell) and cands
        assert len({json.dumps(c, sort_keys=True) for c in cands}) == len(cands)
    for c in autotune.candidates("ntt", N_, ell):
        assert nttm.valid_submodules(N_, c["R"])
        assert ntt_ops.cluster_ok(N_, c["R"], c["cluster"])
        assert ntt_ops.smem_bytes_per_cta(N_, c["R"], c["cluster"]) <= autotune.SMEM_MAX
    assert all(c["rows_per_cta"] >= 1 for c in autotune.candidates("automorphism", N_, ell))
    for family in ("eltwise", "bconv", "auto_ks"):
        assert autotune.candidates(family, N_, ell) == [{}]
    with pytest.raises(ValueError):
        autotune.candidates("fft", N_, ell)


def test_cold_cache_gives_defaults_and_balanced_R(cache):
    assert not cache.exists()
    for N_, R in ((256, 16), (2048, 64), (65536, 256)):
        cfg = autotune.best_config("ntt", N_, 4, backend="cuda")
        assert cfg == {**autotune.DEFAULTS["ntt"], "R": R}
        assert R == ntt_ops.default_submodules(N_) == nttm.balanced_submodules(N_)
    for family in ("automorphism", "eltwise", "bconv", "auto_ks"):
        assert autotune.best_config(family, N, 2) == autotune.DEFAULTS[family]
    with pytest.raises(ValueError):
        autotune.best_config("fft", N, 2)


def test_cache_round_trips_through_a_file(cache):
    key = autotune.record("ntt", N, 2, {"config": {"R": 8, "cluster": 2}, "us": 1.5},
                          backend="cpu")
    assert key == "ntt/N=256/L=2/cpu" == autotune.cache_key("ntt", N, 2, "cpu")
    assert json.loads(cache.read_text())["entries"][key]["config"] == {"R": 8, "cluster": 2}
    autotune.set_cache_path(cache)                    # drop memory, reload the file
    assert autotune.entries()[key]["us"] == 1.5
    assert autotune.best_config("ntt", N, 2, backend="cpu") == {"R": 8, "cluster": 2}
    # the wrappers resolve unpinned knobs from the cache entry of their device;
    # a cached cluster size counts only with the R it was tuned at
    x = pl.to_tensor(rand(tuple(rns.gen_ntt_primes(2, N))), CPU)
    assert ntt_ops.resolve(x, None, None) == (8, 2)
    assert ntt_ops.resolve(x, 32, None) == (32, ntt_ops.cluster_plan(N, 32)) == (32, 1)
    assert ntt_ops.resolve(x, None, 4) == (8, 4)
    with pytest.raises(ValueError):
        ntt_ops.resolve(x, 4, 8)                      # more CTAs than rows
    # a stale R falls back to √N
    autotune.record("ntt", N, 3, {"config": {"R": 3}}, backend="cpu")
    assert autotune.best_config("ntt", N, 3, backend="cpu")["R"] == 16


NTT_PLAN_CASES = [(logN, R) for logN in (10, 11, 16)
                  for R in (1 << k for k in range(1, logN))]


@pytest.mark.parametrize("logN,R", NTT_PLAN_CASES)
def test_ntt_cluster_plan_fits_a_cta(logN, R):
    """The NTT's untuned cluster size at every split of N ∈ {2¹⁰, 2¹¹, 2¹⁶}:
    the per-CTA share fits, no row spans CTAs, and it is the largest share
    at which two CTAs share an SM, else the largest that fits one CTA."""
    n = 1 << logN
    c = ntt_ops.cluster_plan(n, R)
    assert c in ntt_ops.CLUSTER_SIZES and c <= R and R % c == 0
    assert ntt_ops.smem_bytes_per_cta(n, R, c) <= autotune.SMEM_MAX
    assert ntt_ops.cluster_ok(n, R, c)
    valid = [s for s in ntt_ops.CLUSTER_SIZES if ntt_ops.cluster_ok(n, R, s)]
    paired = [s for s in valid if ntt_ops.smem_bytes_per_cta(n, R, s) <= ntt_ops.PAIR_SMEM]
    assert c == (paired or valid)[0]
    assert c == {10: 1, 11: 1, 16: 2 if R == 2 else 4}[logN]
    if logN == 16:              # twiddle pairs in shared memory near R = √N
        assert ntt_ops.stage_pairs(n, R, c) == (64 <= R <= 1024)
    assert not ntt_ops.cluster_ok(n, R, 2 * R)            # a row would span CTAs
    assert not ntt_ops.cluster_ok(n, R, 3)                # not a cluster size


@pytest.mark.parametrize("logN,R", [(18, 2), (18, 4), (20, 1024), (17, 2)])
def test_ntt_cluster_plan_raises_when_nothing_fits(logN, R):
    with pytest.raises(ValueError):
        ntt_ops.cluster_plan(1 << logN, R)


@pytest.mark.parametrize("family", ["ntt", "automorphism"])
def test_autotune_records_a_winner_on_cpu(cache, family):
    entry = autotune.autotune(family, N, 2, reps=1, device="cpu")
    assert entry["config"] in autotune.candidates(family, N, 2)
    assert entry["backend"] == "cpu" and entry["swept"] == len(entry["sweep"])
    assert autotune.best_config(family, N, 2, backend="cpu") == {
        **autotune.DEFAULTS[family], **entry["config"]}
    saved = json.loads(cache.read_text())["entries"]
    assert saved[autotune.cache_key(family, N, 2, "cpu")]["config"] == entry["config"]


def test_cli_times_every_family_on_cpu(tmp_path, capsys):
    out = tmp_path / "cli.json"
    assert autotune.main(["--N", str(N), "--L", "2", "--reps", "1", "--quick",
                          "--device", "cpu", "--out", str(out)]) == 0
    entries = json.loads(out.read_text())["entries"]
    assert sorted(entries) == sorted(autotune.cache_key(f, N, 2, "cpu")
                                     for f in autotune.FAMILIES)
    assert "config cache ->" in capsys.readouterr().out


def test_apply_galois_plain_equals_jax_kernel_interpret():
    basis = tuple(rns.gen_ntt_primes(3, N))
    x = rand(basis, lead=(2,), seed=1)
    config.reset_launches()
    for g in (pl.galois_elt(1, N), pl.galois_elt(-3, N), 2 * N - 1):
        want = auto_ref.automorphism_ref(x, pl.automorphism_perm(N, g))
        jax_out = np.asarray(jauto.apply_galois(jnp.asarray(x), N, g, interpret=True))
        got = auto_ops.apply_galois(pl.to_tensor(x, CPU), N, g)
        np.testing.assert_array_equal(jax_out, want)
        np.testing.assert_array_equal(pl.to_numpy(got), want)
    np.testing.assert_array_equal(
        pl.to_numpy(auto_ops.apply_rotation(pl.to_tensor(x, CPU), N, 4)),
        np.asarray(jauto.apply_rotation(jnp.asarray(x), N, 4, interpret=True)))
    assert config.launch_counts() == {}


def test_eager_plain_equals_jax_eager_kernel_interpret():
    basis = tuple(rns.gen_ntt_primes(3, N))
    x = rand(basis, lead=(2,), seed=2)
    g = pl.galois_elt(5, N)
    want = np.asarray(jkernel.automorphism_pallas_eager(
        jnp.asarray(x), jcc.device_galois_perm(N, g), interpret=True))
    perm = const_cache.device_galois_perm(N, g, CPU)
    got = auto_ops.automorphism_eager(pl.to_tensor(x, CPU), perm)
    np.testing.assert_array_equal(pl.to_numpy(got), want)
    np.testing.assert_array_equal(
        pl.to_numpy(auto_ops.automorphism_plain(pl.to_tensor(x, CPU), perm)), want)


def test_rnspoly_automorphism_on_cpu_is_the_plain_gather():
    basis = tuple(rns.gen_ntt_primes(2, N))
    x = pl.to_tensor(rand(basis, lead=(3,), seed=3), CPU)
    g = pl.galois_elt(1, N)
    perm = const_cache.device_galois_perm(N, g, CPU)
    got = pl.RnsPoly(x, basis, pl.NTT).automorphism_by_gelt(g)
    assert torch.equal(got.data, x.index_select(-1, perm))
    with pytest.raises(ValueError):
        auto_ops.automorphism(x, perm.to("meta"))
