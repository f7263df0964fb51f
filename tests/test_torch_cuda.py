"""The port's CUDA kernels on the card, against their plain torch versions.

Needs a CUDA card and ``nvcc``; every test skips itself without a card.  Run
on the GPU machine with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Imports nothing of JAX.  Each kernel must equal its plain version exactly,
including past the 15 raw products after which a u64 sum would overflow, and
the whole CKKS pipeline must give the same bytes on the card as on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ckks, const_cache, encoding as enc, keys as K
from repro_torch.core import params as prm, poly as pl, rns
from repro_torch.kernels import config
from repro_torch.kernels.automorphism import ops as auto_ops, ref as auto_ref
from repro_torch.kernels.bconv import ops as bconv_ops, ref as bconv_ref
from repro_torch.kernels.eltwise import ops as elt_ops

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


def test_bconv_kernel(dev):
    dst = tuple(rns.gen_ntt_primes(5, N))
    src = tuple(rns.gen_ntt_primes(18, N, exclude=dst))
    x = rand(src, (3,), seed=3)
    x[0] = np.array(src, dtype=np.uint32)[:, None] - 1      # largest residues
    tx = pl.to_tensor(x, dev)
    c = const_cache.device_bconv_consts(src, dst, dev)
    t = bconv_ops.bconv_plain(tx, src, dst)
    config.reset_launches()
    got = bconv_ops.bconv(tx, src, dst)
    assert config.launch_counts() == {"bconv": 1}
    assert torch.equal(got, t)
    np.testing.assert_array_equal(pl.to_numpy(got), bconv_ref.bconv_ref(x, src, dst))
    pre = torch.randint(0, 2 ** 29, (2, len(src), N), device=dev, dtype=torch.int32)
    assert torch.equal(bconv_ops.bconv_matmul_cuda(pre, c.table, c.q_dst),
                       bconv_ops.bconv_matmul_plain(pre, c.table, c.q_dst))


@pytest.mark.parametrize("G", [1, 2])
def test_auto_ks_kernel(dev, G):
    basis = tuple(rns.gen_ntt_primes(4, N))
    gs = (pl.galois_elt(1, N), pl.galois_elt(5, N))
    exts, evk_a, evk_b = (rand(basis, lead, seed=s) for s, lead in
                          ((0, (17, G)), (1, (2, 17)), (2, (2, 17))))
    d = lambda x: pl.to_tensor(x, dev)
    config.reset_launches()
    got = auto_ops.auto_ks(d(exts), d(evk_a), d(evk_b), N, gs, basis)
    assert config.launch_counts() == {"auto_ks": 1}
    perms = const_cache.device_galois_perm_stack(N, gs, dev)
    q = const_cache.device_q(basis, dev)
    assert torch.equal(got, auto_ops.auto_ks_plain(d(exts), d(evk_a), d(evk_b),
                                                   perms, q))
    want = auto_ref.auto_ks_ref(exts, evk_a, evk_b, pl.to_numpy(perms.to(torch.int32))
                                .view(np.int32), basis)
    np.testing.assert_array_equal(pl.to_numpy(got), want)


@pytest.mark.parametrize("G", [1, 2])
def test_automorphism_multi_kernel(dev, G):
    basis = tuple(rns.gen_ntt_primes(3, N))
    gs = (pl.galois_elt(1, N), pl.galois_elt(4, N))
    x = pl.to_tensor(rand(basis, (G,), seed=4), dev)
    config.reset_launches()
    got = auto_ops.apply_galois_many(x, N, gs)
    assert config.launch_counts() == {"automorphism": 1}
    perms = const_cache.device_galois_perm_stack(N, gs, dev)
    assert torch.equal(got, auto_ops.automorphism_multi_plain(x, perms))


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
