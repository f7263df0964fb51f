"""The port's FHE examples (``examples/torch/``) on the CPU, held to the JAX
package's examples.

Each example runs at its own parameters on the plain versions and must give
what ``tests/torch_examples_ref.json`` records of the JAX example
(``tests/make_torch_examples_ref.py``): the same ciphertext bytes for every
ciphertext it decrypts, the same decoded values and HE-op counts (see
``tests/torch_examples.py`` for each example's checks).  HELR and the
quickstart are held on both CKKS engines, the others on the fused one.  No
JAX runs here; the file takes about 15 s on one worker.

The file holds three tests, each running several cases and naming every
failing one: ``--dist loadfile`` hands files to workers in order of their
test counts, largest first, so a file of at most three tests joins the end
of the queue and leaves the order of every other file as it was.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_examples as TE


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread: the file runs at the end of the queue, beside other
    workers' tests that hold wall-clock deadlines, and takes about as long
    on one thread as on all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def failures(part: str, engine: str, ref: dict, tmp_path) -> dict:
    got = TE.port_record(part, "cpu", engine, out_dir=tmp_path)
    checks = TE.compare(part, got, ref[part][engine])
    bad = {f"{part}/{engine}/{k}": v for k, v in checks.items() if not v}
    return bad if checks else {f"{part}/{engine}": "no checks"}


def test_helr_equals_jax():
    """HELR on both engines: the JAX example's weights' bytes, decoded
    values, op trace, accuracy; the accuracy floor of the example and the
    float64 replay of the same update on whole slot vectors."""
    ref, helr = TE.reference(), TE.load("helr")
    cfg = helr.PRESETS["example"]
    p = cfg["params"]()
    bad = {}
    for engine in TE.ENGINES["helr"]:
        assert ref["helr"][engine]["config"] == {
            "N": p.N, "L": p.L, "K": p.K, "dnum": p.dnum, "features": cfg["features"],
            "batch": cfg["batch"], "iters": cfg["iters"]}
        got = TE.port_record("helr", "cpu", engine)
        bad.update({f"helr/{engine}/{k}": v for k, v in
                    TE.compare("helr", got, ref["helr"][engine]).items() if not v})
        run = got["run"]
        want = helr.replay(run.X, run.y, cfg["iters"], p.slots)[:, 0]
        if run.acc < 0.8 or np.max(np.abs(run.w_dec - want)) >= 5e-3:
            bad[f"helr/{engine}/replay"] = (run.acc, float(np.max(np.abs(run.w_dec - want))))
    assert not bad, bad


def test_other_examples_equal_jax(tmp_path):
    """The quickstart (both engines), the bootstrapping, serving and
    distributed demos against the JAX examples' record; the distributed
    demo's bytes pinned and related to the JAX demo's."""
    ref = TE.reference()
    assert {k: set(v) for k, v in ref.items()} == {k: set(v) for k, v in TE.ENGINES.items()}
    bad = {}
    for part, engines in TE.ENGINES.items():
        if part != "helr":
            for engine in engines:
                bad.update(failures(part, engine, ref, tmp_path / part))
    assert not bad, bad


def test_coefficients_equal_the_big_integer_crt():
    """``encoding.coefficients``: the int64 lift from two limbs (checked
    against the others) and the big-integer CRT give the same floats, for
    small coefficients, ones near ±q₀q₁/2, and uniform residues (the big
    integer path)."""
    from repro_torch.core import encoding as enc, params as prm
    basis = prm.paper_full().q[:6]
    Q = int(np.prod([int(q) for q in basis], dtype=object))
    rng = np.random.default_rng(3)
    for magnitude in (2 ** 20, 2 ** 58, None):
        if magnitude is None:
            res = np.stack([rng.integers(0, q, 512) for q in basis])
        else:
            x = rng.integers(-magnitude, magnitude, 512)
            res = np.stack([x % q for q in basis])
        acc = [sum(int(r[k]) * (Q // q) * pow(Q // q, -1, q) for r, q in zip(res, basis))
               % Q for k in range(res.shape[1])]
        want = np.array([float(a - Q if a > Q // 2 else a) for a in acc])
        assert np.array_equal(enc.coefficients(res.astype(np.uint32), basis), want)
        if magnitude is not None:
            assert np.array_equal(want, x.astype(np.float64))
