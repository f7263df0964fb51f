"""The benchmark's yardstick on the CPU: the plain reference against direct
float64 evaluation and against the program's own encryption, the frozen
work model against the program's virtual executor, and the command's
refusals: no card, no result; no module of JAX or the JAX package."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fhebench.reference import ckks as ref
from fhebench.work import model as wm

from .conftest import tiny_config

ROOT = Path(__file__).resolve().parents[2]
TRAFFIC = ROOT / "fhebench" / "traffic"


def _direct(mix: str, inputs: dict, pts: dict, n: int) -> np.ndarray:
    """The program's output by its textbook formula."""
    if mix.startswith("std"):
        prod = inputs["x"] * inputs["y"]
        return prod + np.roll(prod, -1)
    # a banded matrix times x: row j holds d_k[j] at column j + k (mod n)
    M = np.zeros((n, n))
    for k in range(5):
        M[np.arange(n), (np.arange(n) + k) % n] = pts[f"d{k}"]
    return M @ inputs["x"]


def test_reference_and_work_model():
    """The reference and the work model, one after the other, and
    ``BENCHMARK.json`` against ``validate.py`` (one test: the suite keeps
    its files to a few tests each)."""
    from fhebench import validate
    for mix in ("std.c64", "diag.c32"):
        _reference_decrypts_and_evaluates(mix)
    _work_model_matches_virtual_executor_and_bounds()
    assert validate.faults(json.loads((ROOT / "BENCHMARK.json").read_text())) == []
    from fhebench import generator as gen
    with pytest.raises(ValueError, match="loop"):
        gen.check_mix(dict(json.loads((TRAFFIC / "std.c64.json").read_text()),
                           loop="open"))


def _reference_decrypts_and_evaluates(mix):
    """evaluate() equals the textbook formula, and the reference decrypts
    the program's fresh ciphertexts and its NTT matches the definition."""
    from repro_torch.core import encoding as enc, keys as K
    from repro_torch.core.params import CkksParams
    from fhebench import generator as gen

    cfg = tiny_config()
    traffic = json.loads((TRAFFIC / f"{mix}.json").read_text())
    N, n = cfg["N"], cfg["N"] // 2
    rng = np.random.default_rng(5)
    inputs = {r: gen.message(s, n, rng) for r, s in traffic["inputs"].items()}
    pts = {p: gen.message(s, n, rng) for p, s in traffic["plaintexts"].items()}
    got = ref.evaluate(traffic["program"], inputs, pts)["out"]
    np.testing.assert_allclose(got, _direct(mix, inputs, pts, n), atol=1e-12)

    params = CkksParams(N=N, q=tuple(cfg["q"]), p=tuple(cfg["p"]), dnum=cfg["dnum"],
                        rescale_primes=2)
    ks = K.keygen(params, seed=17, device="cpu")
    s = ref.ternary_secret(17, N)
    assert np.array_equal(ks.sk.s_small.astype(np.int64), s)
    scale = ref.encode_scale(params.q, params.L, 2)
    z = inputs["x"]
    ct = K.encrypt(enc.encode(z, scale, params.q, N), scale, ks.sk, params.q, N,
                   rng=np.random.default_rng(3), device="cpu")
    dec = ref.Decryptor(s, params.q, N, "cpu")
    r = ref.check(dec, ct.a.data, ct.b.data, ct.a.domain == "ntt", params.L,
                  scale, z)
    assert r["bad_limbs"] == 0 and r["wrong_level"] == 0 and r["err"] < 1e-9

    t = ref.Ntt(params.q[:2], N, "cpu")
    x = torch.tensor(rng.integers(0, 2 ** 20, (2, N)), dtype=torch.int64) % t.q
    for i, q in enumerate(params.q[:2]):
        psi = ref.find_psi(q, N)
        k = 3
        want = sum(int(x[i, m]) * pow(psi, (2 * k + 1) * m, q) for m in range(N)) % q
        assert int(t.forward(x)[i, k]) == want
    assert torch.equal(t.inverse(t.forward(x)), x)


def _work_model_matches_virtual_executor_and_bounds():
    """NTT limbs and BConv MACs per op equal the virtual executor's at two
    levels, and each roofline of ideal times reads at most 100 %."""
    from repro_torch.core import params as prm
    from repro_torch.workloads import virtual as V

    p = prm.test_small()
    wp = wm.Params(p.N, p.L, p.K, p.dnum, p.rescale_primes)
    peak = wm.PEAKS["NVIDIA H100 80GB HBM3"]
    for ell in (p.L, 3):
        for kind in ("hmult", "rescale", "hrot", "pmult"):
            vc = V.VirtualCkks(p)
            ct = V.VirtualCt(ell)
            {"hmult": lambda: vc.hmult(ct, rescale=False),
             "rescale": lambda: vc.rescale(ct),
             "hrot": lambda: vc.hrot(ct),
             "pmult": lambda: vc.pmult(ct, rescale=False)}[kind]()
            w = wm.op_work(wp, kind, ell, 1, plaintexts=1)
            assert w.ntt_limbs == vc.t.limb_transforms(), (kind, ell)
            assert w.bconv_macs == vc.t.bconv_macs(), (kind, ell)
            # the time of any kernel meeting its bound reads at most 100 %
            obs = {"params": wp, "peak": peak, "work": w,
                   "loop_s": wm.whole_least_s(wp, w, peak),
                   "segment": {"work": w, "kernel_s": {
                       "ntt_fwd_kernel": wm.ntt_least_s(wp, w, peak),
                       "bconv_kernel<12>": wm.keyswitch_least_s(wp, w, peak)}}}
            from fhebench.harness import reader
            for name in ("roofline.ntt", "roofline.keyswitch", "window_roofline"):
                v = reader(name)(obs)
                assert v is None or v <= 100.0 + 1e-9, (name, kind, ell, v)


def test_no_card_no_result_and_no_jax():
    """A run without a CUDA card exits non-zero and prints no result; a
    whole CPU run loads no module of JAX or of the JAX package."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "fhebench/run.py", "--workload",
                        "paper-l48.std.c64", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and "{" not in p.stdout, (p.returncode, p.stdout)
    code = (
        "import json, sys, time\n"
        "sys.path[:0] = ['fhebench/tests', '.']\n"
        "from conftest import tiny_config\n"
        "from fhebench import harness\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "t = json.load(open('fhebench/traffic/diag.c32.json'))\n"
        "t.update(clients_per_tenant=1, pool_per_tenant=1, warmup_waves=1)\n"
        "r, _ = harness.run({'name': 'tiny'}, tiny_config(), t,"
        " bench['end_to_end'] + bench['per_layer'], seed=1, seconds=0.1,"
        " trace=False, device='cpu', t_proc0=time.perf_counter())\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.splitlines()[-1]) == []
