"""The port's CKKS pipeline against the JAX package, byte for byte.

keygen → encrypt → hmult → rescale → hrot_hoisted([1, 4]) → decrypt at
``test_small``, on the fused engine and separately on the eager engine (the
two engines give different valid ciphertexts by design, so like is compared
with like).  The JAX reference runs once per module, fused first and eager
after it in the same process; the port runs on the CPU, where every kernel
wrapper takes its plain version.  Tolerance: exact equality.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.core import ckks as jckks  # noqa: E402
from repro.core import encoding as jenc  # noqa: E402
from repro.core import keys as jK  # noqa: E402
from repro.core import params as jprm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import ckks, guards, keys as K, params as prm  # noqa: E402
from repro_torch.core import encoding as enc  # noqa: E402
from repro_torch.core import poly as pl  # noqa: E402
from repro_torch.kernels import config  # noqa: E402

CPU = torch.device("cpu")
ROTS = [1, 4]
ENGINES = ("fused", "eager")
STAGES = ("hmult", "rescale", "rot1", "rot4")


def _messages():
    rng = np.random.default_rng(0)
    z1 = rng.normal(size=8) + 1j * rng.normal(size=8)
    z2 = rng.normal(size=8) + 1j * rng.normal(size=8)
    return z1, z2


def _pipeline(ckks_mod, ct1, ct2, keys, params, engine):
    """{stage: ciphertext} of hmult → rescale → hoisted rotations."""
    with ckks_mod.use_engine(engine):
        m = ckks_mod.hmult(ct1, ct2, keys)
        r = ckks_mod.rescale(m, params)
        rots = ckks_mod.hrot_hoisted(r, ROTS, keys)
    return dict(zip(STAGES, [m, r, *rots]))


def _np_ct(ct):
    return {"a": np.asarray(ct.a.data), "b": np.asarray(ct.b.data),
            "scale": ct.scale, "basis": ct.basis, "domain": ct.a.domain}


def _np_evk(ek):
    return int(ek.seed), [np.asarray(b.data) for b in ek.b]


@pytest.fixture(scope="module")
def ref():
    """Everything the JAX package computes, as numpy, built once."""
    p = jprm.test_small()
    keys = jK.keygen(p, rotations=(1, 4), seed=0)
    scale = float(p.q[-1])
    z1, z2 = _messages()
    cts = [jK.encrypt(jenc.encode(z, scale, p.q, p.N), scale, keys.sk, p.q, p.N,
                      rng=np.random.default_rng(i + 1))
           for i, z in enumerate((z1, z2))]
    out = {"s_small": np.asarray(keys.sk.s_small),
           "relin": _np_evk(keys.relin),
           "relin_a": [np.asarray(a.data) for a in keys.relin.a()],
           "galois": {g: _np_evk(ek) for g, ek in keys.galois.items()},
           "cts": [_np_ct(c) for c in cts]}
    for engine in ENGINES:
        stages = _pipeline(jckks, *cts, keys, p, engine)
        out[engine] = {s: _np_ct(c) for s, c in stages.items()}
        out[engine + "_dec"] = {s: np.asarray(jK.decrypt(c, keys.sk))
                                for s, c in stages.items()}
    return out


@pytest.fixture(scope="module")
def port():
    """The port's keys, ciphertexts and pipelines on the CPU."""
    p = prm.test_small()
    keys = K.keygen(p, rotations=(1, 4), seed=0, device=CPU)
    scale = float(p.q[-1])
    z1, z2 = _messages()
    cts = [K.encrypt(enc.encode(z, scale, p.q, p.N), scale, keys.sk, p.q, p.N,
                     rng=np.random.default_rng(i + 1), device=CPU)
           for i, z in enumerate((z1, z2))]
    config.reset_launches()
    out = {"params": p, "keys": keys, "cts": cts, "z": (z1, z2)}
    for engine in ENGINES:
        out[engine] = _pipeline(ckks, *cts, keys, p, engine)
    out["launches"] = config.launch_counts()
    return out


def assert_ct_equal(got: K.Ciphertext, want: dict):
    assert got.basis == tuple(want["basis"])
    assert got.a.domain == want["domain"] and got.b.domain == want["domain"]
    assert got.scale == want["scale"]
    assert got.a.data.dtype == torch.int32
    np.testing.assert_array_equal(pl.to_numpy(got.a.data), want["a"])
    np.testing.assert_array_equal(pl.to_numpy(got.b.data), want["b"])


# -------------------------------------------------------------- key material

def test_keygen_matches_reference(ref, port):
    keys = port["keys"]
    np.testing.assert_array_equal(keys.sk.s_small, ref["s_small"])
    assert sorted(keys.galois) == sorted(ref["galois"])
    for ek, (seed, bs) in [(keys.relin, ref["relin"])] + [
            (keys.galois[g], ref["galois"][g]) for g in ref["galois"]]:
        assert ek.seed == seed
        for got, want in zip(ek.b, bs, strict=True):
            np.testing.assert_array_equal(pl.to_numpy(got.data), want)
    for got, want in zip(keys.relin.a(), ref["relin_a"], strict=True):
        np.testing.assert_array_equal(pl.to_numpy(got.data), want)


def test_interop_keyset_equals_native_keygen(ref, port):
    ks = interop.keyset_from_numpy(port["params"], ref["s_small"], ref["relin"],
                                   ref["galois"], device=CPU)
    native = port["keys"]
    for a, b in [(ks.relin, native.relin)] + [
            (ks.galois[g], native.galois[g]) for g in native.galois]:
        assert a.seed == b.seed
        for x, y in zip(a.a() + a.b, b.a() + b.b, strict=True):
            assert torch.equal(x.data, y.data)


def test_interop_ciphertext_round_trip(ref):
    want = ref["cts"][0]
    ct = interop.ciphertext_from_numpy(want["a"], want["b"], want["scale"],
                                       want["basis"], want["domain"], device=CPU)
    assert_ct_equal(ct, want)
    back = interop.ciphertext_to_numpy(ct)
    for k in ("a", "b"):
        assert back[k].dtype == np.uint32
        np.testing.assert_array_equal(back[k], want[k])
    assert (back["scale"], back["basis"], back["domain"]) == \
        (want["scale"], want["basis"], want["domain"])


def test_encrypt_matches_reference(ref, port):
    for got, want in zip(port["cts"], ref["cts"], strict=True):
        assert_ct_equal(got, want)


# ---------------------------------------------------------------- pipeline

@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("engine", ENGINES)
def test_pipeline_ciphertext_matches_reference(ref, port, engine, stage):
    assert_ct_equal(port[engine][stage], ref[engine][stage])


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("engine", ENGINES)
def test_pipeline_decrypt_matches_reference(ref, port, engine, stage):
    got = K.decrypt(port[engine][stage], port["keys"].sk)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, ref[engine + "_dec"][stage])


@pytest.mark.parametrize("engine", ENGINES)
def test_pipeline_decodes_to_plaintext_math(port, engine):
    p, (z1, z2) = port["params"], port["z"]
    prod = np.concatenate([z1 * z2, np.zeros(p.slots - 8)])
    want = {"rescale": prod[:8], "rot1": np.roll(prod, -1)[:8],
            "rot4": np.roll(prod, -4)[:8]}
    for stage, z in want.items():
        ct = port[engine][stage]
        got = enc.decode(K.decrypt(ct, port["keys"].sk), ct.scale, ct.basis,
                         p.N, 8)
        assert np.max(np.abs(got - z)) < 1e-2, (engine, stage)


def test_cpu_pipeline_launches_no_kernel(port):
    assert port["launches"] == {}


# ------------------------------------------- port-internal identities (fused)

def test_hrot_equals_hoisted_single_rotation(port):
    ct, keys = port["cts"][0], port["keys"]
    a = ckks.hrot(ct, 4, keys)
    b = ckks.hrot_hoisted(ct, [4], keys)[0]
    assert torch.equal(a.a.data, b.a.data) and torch.equal(a.b.data, b.b.data)


def test_hrot_many_equals_per_ciphertext_rotations(port):
    (c1, c2), keys = port["cts"], port["keys"]
    many = ckks.hrot_many([c1, c2, c1], [1, 4, 0], keys)
    for got, want in zip(many, [ckks.hrot(c1, 1, keys), ckks.hrot(c2, 4, keys), c1]):
        assert torch.equal(got.a.to_ntt().data, want.a.to_ntt().data)
        assert torch.equal(got.b.to_ntt().data, want.b.to_ntt().data)


def test_square_equals_hmult_with_itself(port):
    ct, keys = port["cts"][0], port["keys"]
    a, b = ckks.square(ct, keys), ckks.hmult(ct, ct, keys)
    assert torch.equal(a.a.data, b.a.data) and torch.equal(a.b.data, b.b.data)


def test_conjugate_and_adds_decode():
    p = prm.test_small()
    keys = K.keygen(p, conj=True, seed=3, device=CPU)
    z1, z2 = _messages()
    scale = float(p.q[-1])
    ct1, ct2 = (K.encrypt(enc.encode(z, scale, p.q, p.N), scale, keys.sk, p.q,
                          p.N, device=CPU) for z in (z1, z2))
    for ct, want in ((ckks.conjugate(ct1, keys), np.conj(z1)),
                     (ckks.hadd(ct1, ct2), z1 + z2),
                     (ckks.hsub(ct1, ct2), z1 - z2),
                     (ckks.level_drop(ct1, 3), z1)):
        got = enc.decode(K.decrypt(ct, keys.sk), ct.scale, ct.basis, p.N, 8)
        assert np.max(np.abs(got - want)) < 1e-2


def test_full_guards_catch_a_flipped_residue(port):
    ct = port["cts"][0]
    bad = ct.a.data.clone()
    bad[0, 0] |= torch.tensor(-2 ** 31, dtype=torch.int32)    # bit 31
    with guards.use_mode("full"):
        ckks.hadd(ct, ct)
        with pytest.raises(guards.ResidueRange):
            ckks.hadd(K.Ciphertext(pl.RnsPoly(bad, ct.basis, ct.a.domain),
                                   ct.b, ct.scale), ct)
