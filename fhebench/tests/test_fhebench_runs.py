"""Whole runs of the harness on the CPU at a tiny size: a sound run is
correct; the control (single-prime rescale) and each fault planted in the
timed path are not."""
import json
import time
from pathlib import Path

from .conftest import tiny_config

ROOT = Path(__file__).resolve().parents[2]


def _unchanged(port):
    """A step that returns its state unchanged: rotations return their input."""
    from repro_torch.core import ckks
    ckks.hrot_many = lambda cts, rots, keys: list(cts)


def _half(port):
    """Half of the batch left out: the second half of every group receives
    the first half's results."""
    from repro_torch.serve import batcher
    orig = batcher.Batcher._scatter

    def scatter(items, outs):
        outs = list(outs)
        h = max(1, len(outs) // 2)
        orig(items, outs[:h] + [outs[0]] * (len(outs) - h))
    batcher.Batcher._scatter = staticmethod(scatter)


def _altered(port):
    """An answer altered where it is produced: one residue of each hadd
    output changed."""
    from repro_torch.core import ckks
    orig = ckks.hadd_many

    def hadd_many(c1s, c2s, sub=False):
        out = orig(c1s, c2s, sub)
        for ct in out:
            d = ct.b.data.clone()
            d[1, 7] = (d[1, 7] + 1) % 1000
            ct.b.data = d
        return out
    ckks.hadd_many = hadd_many


CASES = {"sound": (2, None, True), "control": (1, None, False),
         "unchanged": (2, _unchanged, False), "half": (2, _half, False),
         "altered": (2, _altered, False)}


def test_run_correct_only_when_sound(monkeypatch):
    """The comparison that decides ``correct`` passes the program as it is
    and fails the control and every fault the cells can have (one card: no
    exchange between chips to leave out), for both programs."""
    from fhebench import harness
    from repro_torch.core import ckks
    from repro_torch.serve import batcher
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for mix in ("std.c64", "diag.c32"):
        traffic = json.loads((ROOT / "fhebench" / "traffic" / f"{mix}.json")
                             .read_text())
        traffic.update(clients_per_tenant=2, pool_per_tenant=2, warmup_waves=1)
        for case, (rp, fault, want) in CASES.items():
            with monkeypatch.context() as m:
                m.setattr(ckks, "hrot_many", ckks.hrot_many)
                m.setattr(ckks, "hadd_many", ckks.hadd_many)
                m.setattr(batcher.Batcher, "_scatter",
                          batcher.Batcher.__dict__["_scatter"])
                result, checks = harness.run(
                    {"name": "tiny"}, tiny_config(rp), traffic,
                    bench["end_to_end"], seed=2 ** 33 + 5, seconds=1.0,
                    trace=False, device="cpu", t_proc0=time.perf_counter(),
                    fault=fault)
            assert checks["outputs_checked"]["value"] >= 1, (mix, case)
            assert result["correct"] is want, (mix, case, checks)
