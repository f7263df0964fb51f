"""The port's CKKS pipeline against the JAX package, byte for byte.

keygen → encrypt → hmult → rescale → hrot_hoisted([1, 4]) → decrypt at
``test_small``, on the fused engine and separately on the eager engine (the
two engines give different valid ciphertexts by design, so like is compared
with like).  The port runs on the CPU, where every kernel wrapper takes its
plain version, and is held against the SHA-256 digests of the JAX package's
bytes that ``tests/make_torch_ckks_ref.py`` recorded in
``tests/torch_ckks_ref.json`` (the key material, both ciphertexts, each
stage's ciphertext and its decryption).  Tolerance: exact equality.  The
op trace of the pipeline (counts, calls, HE ops) is held to the JAX
package's in ``tests/torch_trace_ref.json`` (``tests/make_torch_trace_ref.py``).
"""
import json
import os

import numpy as np
import pytest
import torch

from make_torch_ckks_ref import ROTS, STAGES, ct_record, messages, sha
from make_torch_trace_ref import PIPELINE_ROTS, trace_record
from repro_torch import interop
from repro_torch.core import ckks, guards, keys as K, params as prm
from repro_torch.core import encoding as enc
from repro_torch.core import poly as pl
from repro_torch.core import trace as TR
from repro_torch.kernels import config

CPU = torch.device("cpu")
ENGINES = ("fused", "eager")
with open(os.path.join(os.path.dirname(__file__), "torch_ckks_ref.json")) as _f:
    REF = json.load(_f)
with open(os.path.join(os.path.dirname(__file__), "torch_trace_ref.json")) as _f:
    TRACE_REF = json.load(_f)["traces"]


def _messages():
    return messages()


def _pipeline(ckks_mod, ct1, ct2, keys, params, engine):
    """{stage: ciphertext} of hmult → rescale → hoisted rotations."""
    with ckks_mod.use_engine(engine):
        m = ckks_mod.hmult(ct1, ct2, keys)
        r = ckks_mod.rescale(m, params)
        rots = ckks_mod.hrot_hoisted(r, ROTS, keys)
    return dict(zip(STAGES, [m, r, *rots]))


def _np_evk(ek):
    return int(ek.seed), [pl.to_numpy(b.data) for b in ek.b]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's digests (tests/torch_ckks_ref.json)."""
    return REF


@pytest.fixture(scope="module")
def port():
    """The port's keys, ciphertexts and pipelines on the CPU."""
    p = prm.test_small()
    keys = K.keygen(p, rotations=tuple(ROTS), seed=0, device=CPU)
    scale = float(p.q[-1])
    z1, z2 = _messages()
    cts = [K.encrypt(enc.encode(z, scale, p.q, p.N), scale, keys.sk, p.q, p.N,
                     rng=np.random.default_rng(i + 1), device=CPU)
           for i, z in enumerate((z1, z2))]
    config.reset_launches()
    out = {"params": p, "keys": keys, "cts": cts, "z": (z1, z2)}
    for engine in ENGINES:
        with TR.trace_ops() as out["trace", engine]:
            out[engine] = _pipeline(ckks, *cts, keys, p, engine)
    out["launches"] = config.launch_counts()
    return out


def assert_ct_equal(got: K.Ciphertext, want: dict):
    """Equal to a recorded ciphertext: basis, domain, scale and the SHA-256
    of the u32 bytes of a, then b."""
    assert got.a.data.dtype == torch.int32
    assert ct_record(pl.to_numpy(got.a.data), pl.to_numpy(got.b.data), got.scale,
                     got.basis, got.a.domain) == {k: want[k] for k in (
                         "sha256", "scale", "basis", "domain")}
    assert got.b.domain == want["domain"]


@pytest.mark.parametrize("engine", ENGINES)
def test_pipeline_trace_matches_reference(port, engine):
    """The op trace of hmult → rescale → hrot_hoisted([1, 4]) (counts, calls,
    HE ops) equals the JAX package's, recorded by
    tests/make_torch_trace_ref.py; the CPU launches nothing."""
    assert ROTS == PIPELINE_ROTS
    t = port["trace", engine]
    assert trace_record(t) == TRACE_REF["pipeline"][engine]
    assert not t.launches


# -------------------------------------------------------------- key material

def test_keygen_matches_reference(ref, port):
    keys = port["keys"]
    assert sha(keys.sk.s_small) == ref["s_small"]
    assert sorted(keys.galois) == sorted(int(g) for g in ref["galois"])
    for ek, want in [(keys.relin, ref["relin"])] + [
            (keys.galois[int(g)], w) for g, w in ref["galois"].items()]:
        assert ek.seed == want["seed"]
        assert [sha(pl.to_numpy(b.data)) for b in ek.b] == want["b"]
    assert [sha(pl.to_numpy(a.data)) for a in keys.relin.a()] == ref["relin"]["a"]


def test_interop_keyset_equals_native_keygen(ref, port):
    """A KeySet built from the secret and the (seed, b-halves) of each key —
    each input held here to the JAX package's digests — equals the native
    keygen's, a-halves regenerated from the seeds included."""
    native = port["keys"]
    s_small = native.sk.s_small.copy()
    assert sha(s_small) == ref["s_small"]
    relin = _np_evk(native.relin)
    galois = {g: _np_evk(ek) for g, ek in native.galois.items()}
    assert sorted(galois) == sorted(int(g) for g in ref["galois"])
    for (seed, bs), want in [(relin, ref["relin"])] + [
            (galois[int(g)], w) for g, w in ref["galois"].items()]:
        assert seed == want["seed"]
        assert [sha(b) for b in bs] == want["b"]
    ks = interop.keyset_from_numpy(port["params"], s_small, relin, galois,
                                   device=CPU)
    for a, b in [(ks.relin, native.relin)] + [
            (ks.galois[g], native.galois[g]) for g in native.galois]:
        assert a.seed == b.seed
        for x, y in zip(a.a() + a.b, b.a() + b.b, strict=True):
            assert torch.equal(x.data, y.data)


def test_interop_ciphertext_round_trip(ref, port):
    """u32 arrays → ciphertext → u32 arrays, the ciphertext held to the JAX
    package's digest of the first encryption."""
    want = interop.ciphertext_to_numpy(port["cts"][0])
    for k in ("a", "b"):
        assert want[k].dtype == np.uint32
    ct = interop.ciphertext_from_numpy(want["a"], want["b"], want["scale"],
                                       want["basis"], want["domain"], device=CPU)
    assert_ct_equal(ct, ref["cts"][0])
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
    assert_ct_equal(port[engine][stage], ref["engines"][engine][stage])


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("engine", ENGINES)
def test_pipeline_decrypt_matches_reference(ref, port, engine, stage):
    got = K.decrypt(port[engine][stage], port["keys"].sk)
    assert got.dtype == np.uint32
    assert sha(got) == ref["engines"][engine][stage]["decrypt_sha256"]


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
