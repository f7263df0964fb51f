"""The torch examples as programs (``examples/torch/``): they import no JAX,
refuse a missing card, and the records they are held to hold together.

Three tests, each over every case (see ``tests/test_torch_examples.py`` for
why a file of examples keeps to three).
"""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_examples as TE

ROOT = Path(__file__).resolve().parents[1]


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_examples_import_no_jax():
    paths = [*sorted((ROOT / "examples" / "torch").glob("*.py")),
             ROOT / "tests" / "torch_examples.py", ROOT / "chip_smoke.py"]
    assert len(paths) == 8
    bad = {p.name: sorted(_imports(p) & {"jax", "jaxlib", "repro"}) for p in paths}
    assert not any(bad.values()), bad


def test_examples_refuse_a_missing_card():
    """``--device cuda`` without a card raises; no example falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    for part in TE.MODULES:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TE.load(part).main(["--device", "cuda"])


def test_records_hold_together():
    """The distributed demo's pinned bytes follow from the JAX demo's
    recorded ones (the port counts every block's words sent to other
    blocks, the JAX demo one device's wire bytes with XLA's pre-scale
    gathers); the JAX bootstrap met its bound and the steady-state serving
    wave staged nothing; HELR's replay keeps partial sums in the batch's
    other slots and separates the example's data."""
    ref = TE.reference()
    jax_t = ref["distributed"]["fused"]["traffic"]
    port_t = {k: {"total": v} for k, v in TE.PORT_TRAFFIC.items()}
    assert all(TE.traffic_relation(port_t, jax_t).values())
    assert jax_t["ntt_ell"] == 16 and jax_t["map"] == "4x2-BK-1x2"
    assert ref["bootstrapping"]["fused"]["max_error"] < 5e-3
    assert ref["serving"]["fused"]["uploads"] == 0 == ref["serving"]["fused"]["plan_builds"]
    helr = TE.load("helr")
    X, y = helr.make_data(4, 64)
    w = helr.replay(X, y, 1, 1 << 10)
    assert helr.accuracy(X, y, w[:, 0]) >= 0.8
    assert np.count_nonzero(w[:, 1:64]) > 0
