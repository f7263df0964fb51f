#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` and runs, each phase printing one JSON line:

1. device   — the card (fails without CUDA), ``nvidia-smi`` name/power limit;
2. build    — one ``nvcc`` per kernel source, all at once;
3. kernels  — each kernel against its plain torch version on the card at the
              shapes the ``paper_full`` pipeline gives it (N = 2¹⁶, L = 48,
              K = 12, dnum = 4): bit-equal, with kernel / plain / library
              times and the memory-or-operations bound;
4. cross    — keygen → encrypt → hmult → rescale → hrot_hoisted([1, 4]) at
              ``test_medium`` on the CPU (plain versions) and on the card
              (kernels): every ciphertext must have equal bytes;
5. pipeline — the same pipeline at ``paper_full`` on the card with |z| ≤ 1:
              decode error against plaintext math must be < 1e-2, and every
              kernel family must have launched (counts reset just before);

then the kernel table as one JSON line, and the result line
``{"ok": true, "device": {...}}`` last.  Any failure raises: the script exits
non-zero and prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT_OPS_PER_S = 67e12          # H100 SXM CUDA-core peak (no integer-unit entry)
SEED = 0
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def gpu_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median device time of one call of ``fn``: ``reps`` calls captured in a
    CUDA graph, replayed ``rounds`` times between CUDA events, so host-side
    launch overhead does not enter the time."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    torch.cuda.synchronize()
    return statistics.median(times)


def residues(basis, lead, N, gen):
    """Uniform int32 residues (*lead, ℓ, N) on the card, one prime per limb."""
    import torch
    from repro_torch.core import const_cache
    q = const_cache.device_q(tuple(basis), gen.device)
    raw = torch.randint(0, 2 ** 62, (*lead, len(basis), N), generator=gen,
                        device=gen.device, dtype=torch.int64)
    return (raw % q).to(torch.int32)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build():
    from repro_torch.kernels import native
    seconds = native.build()
    for name in native.SOURCES:
        native.lib(name)
    emit({"phase": "build", "seconds": seconds, "nvcc": native.nvcc(),
          "libraries": [native.library_path(n).name for n in native.SOURCES]})


def phase_kernels(params):
    """Each kernel vs its plain version at the paper_full pipeline shapes."""
    import torch
    from repro_torch.core import const_cache, poly as pl
    from repro_torch.kernels.automorphism import ops as auto_ops
    from repro_torch.kernels.bconv import ops as bconv_ops
    from repro_torch.kernels.eltwise import ops as elt_ops

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    N, L, K = params.N, params.L, params.K
    q48 = params.q[:L]
    rows = []

    def case(kernel, name, family, source, replaces, cuda_fn, plain_fn, args,
             nbytes, ops, library=None):
        got = cuda_fn(*args)
        want = plain_fn(*args)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        b_ms, b_by = bound_ms(nbytes, ops)
        row = {"kernel": kernel, "name": name, "family": family, "route": "cuda", "source": source,
               "replaces": replaces, "shape": list(args[0].shape),
               "equal": equal, "max_abs_err": err,
               "ms": gpu_ms(lambda: cuda_fn(*args)),
               "plain_ms": gpu_ms(lambda: plain_fn(*args), reps=2, rounds=3),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": gpu_ms(lambda: library(*args)) if library else None}
        emit({"phase": "kernel", **row})
        if not equal:
            raise AssertionError(f"{name}: kernel differs from its plain version "
                                 f"(max |diff| {err})")
        rows.append(row)

    src = "src/repro_torch/kernels/csrc/"
    # EFU: HMult's stacked mul on (2, ℓ, N) and compound mac on (ℓ, N)
    q = const_cache.device_q(q48, dev)
    x2 = [residues(q48, (2,), N, gen) for _ in range(2)]
    case("efu", "eltwise_mul_2x48", "eltwise", src + "eltwise.cu",
         "src/repro/kernels/eltwise/kernel.py:56",
         lambda a, b: elt_ops.eltwise_cuda("mul", q, a, b),
         lambda a, b: elt_ops.eltwise_plain("mul", q, a, b), x2,
         nbytes=3 * x2[0].numel() * 4, ops=2 * x2[0].numel())
    x4 = [residues(q48, (), N, gen) for _ in range(4)]
    case("efu", "eltwise_mac_48", "eltwise", src + "eltwise.cu",
         "src/repro/kernels/eltwise/kernel.py:56",
         lambda *a: elt_ops.eltwise_cuda("mac", q, *a),
         lambda *a: elt_ops.eltwise_plain("mac", q, *a), x4,
         nbytes=5 * x4[0].numel() * 4, ops=5 * x4[0].numel())

    # BConvU: ModUp of one digit (α = 12 limbs → 36 + 12 = 48) and the
    # stacked ModDown of a hoisted pair of rotations (4 × 12 → 46)
    for name, src_b, dst_b, B in (
            ("bconv_moddown_4x12_to_46", params.p, params.q[:L - 2], 4),
            ("bconv_modup_1x12_to_48", params.q[:12], params.q[12:L] + params.p, 1)):
        c = const_cache.device_bconv_consts(src_b, dst_b, dev)
        t = residues(src_b, (B,), N, gen)
        ell, k = len(src_b), len(dst_b)
        case("bconvu", name, "bconv", src + "bconv.cu", "src/repro/kernels/bconv/kernel.py:59",
             lambda a: bconv_ops.bconv_matmul_cuda(a, c.table, c.q_dst),
             lambda a: bconv_ops.bconv_matmul_plain(a, c.table, c.q_dst), [t],
             nbytes=(B * ell * N + B * k * N) * 4 + k * ell * 8,
             ops=2 * B * k * ell * N)

    # AutoU∘KS: hoisted digits (dnum=4, G=1, ℓ+K = 46+12 = 58) × 2 rotations
    gs = (pl.galois_elt(1, N), pl.galois_elt(4, N))
    ext_basis = params.q[:L - 2] + params.p
    J, Lx, R = params.dnum, len(ext_basis), len(gs)
    exts = residues(ext_basis, (J, 1), N, gen)
    evk_a = residues(ext_basis, (R, J), N, gen)
    evk_b = residues(ext_basis, (R, J), N, gen)
    perms = const_cache.device_galois_perm_stack(N, gs, dev)
    qx = const_cache.device_q(ext_basis, dev)
    case("auto_ks", "auto_ks_J4_G1_R2_L58", "auto_ks", src + "automorphism.cu",
         "src/repro/kernels/automorphism/kernel.py:175",
         lambda e, a, b: auto_ops.auto_ks_cuda(e, a, b, perms, qx),
         lambda e, a, b: auto_ops.auto_ks_plain(e, a, b, perms, qx),
         [exts, evk_a, evk_b],
         nbytes=(J * Lx * N + 2 * R * J * Lx * N + 2 * R * Lx * N) * 4 + R * N * 8,
         ops=4 * R * J * Lx * N)

    # multi-permutation: the rotated b-halves, (1, 46, N) → R = 2
    xb = residues(params.q[:L - 2], (1,), N, gen)
    case("automorphism_multi", "automorphism_multi_G1_R2_L46", "automorphism",
         src + "automorphism.cu",
         "src/repro/kernels/automorphism/kernel.py:118",
         lambda x: auto_ops.automorphism_multi_cuda(x, perms),
         lambda x: auto_ops.automorphism_multi_plain(x, perms), [xb],
         nbytes=(xb.numel() + R * xb.numel()) * 4 + R * N * 8, ops=0,
         library=lambda x: torch.gather(
             x.expand(R, -1, -1), 2, perms[:, None, :].expand(R, x.shape[1], N)))
    return rows


def _run_ops(cts, keys, params, rotations, sync):
    """hmult → rescale → hoisted rotations once: ({stage: ciphertext},
    {op: milliseconds on the host clock, each ending in a device sync})."""
    from repro_torch.core import ckks
    t0 = time.perf_counter()
    m = ckks.hmult(cts[0], cts[1], keys)
    sync()
    t1 = time.perf_counter()
    r = ckks.rescale(m, params)
    sync()
    t2 = time.perf_counter()
    rots = ckks.hrot_hoisted(r, list(rotations), keys)
    sync()
    t3 = time.perf_counter()
    ms = {"hmult_ms": (t1 - t0) * 1e3, "rescale_ms": (t2 - t1) * 1e3,
          "hoisted_rotations_ms": (t3 - t2) * 1e3}
    return {"hmult": m, "rescale": r, "rot1": rots[0], "rot4": rots[1]}, ms


def _pipeline(params, device, z1, z2, rotations=(1, 4), warm_reps=0):
    """keygen → encrypt, then the ops once with the launch counters reset
    just before and read just after (the cold run, which also stages the
    constants and regenerates the evk a-halves), then ``warm_reps`` more
    runs whose median per-op times are the steady-state latencies."""
    import numpy as np
    import torch
    from repro_torch.core import encoding as enc, keys as K
    from repro_torch.kernels import config

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    keys = K.keygen(params, rotations=rotations, seed=SEED, device=device)
    scale = params.scale()
    cts = [K.encrypt(enc.encode(z, scale, params.q, params.N), scale, keys.sk,
                     params.q, params.N, rng=np.random.default_rng(i + 1),
                     device=device) for i, z in enumerate((z1, z2))]
    sync()
    times = {"keygen_encrypt_s": time.perf_counter() - t0}
    config.reset_launches()
    out, cold = _run_ops(cts, keys, params, rotations, sync)
    launches = config.launch_counts()
    times.update({"cold_" + k: v for k, v in cold.items()})
    warm = [_run_ops(cts, keys, params, rotations, sync)[1]
            for _ in range(warm_reps)]
    if warm:
        times.update({k: statistics.median(w[k] for w in warm) for k in cold})
    return keys, out, times, launches


def _messages(n, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
    return z / np.sqrt(2)                                # |z| ≤ 1


def phase_cross():
    """Equal bytes from the plain versions on the CPU and the kernels on the card."""
    import torch
    from repro_torch.core import params as prm, poly as pl
    p = prm.test_medium()
    z1, z2 = _messages(8, 1), _messages(8, 2)
    _, cpu, _, _ = _pipeline(p, "cpu", z1, z2)
    _, gpu, _, launches = _pipeline(p, DEVICE, z1, z2)
    equal = {}
    for stage in cpu:
        equal[stage] = bool(
            torch.equal(cpu[stage].a.data, gpu[stage].a.data.cpu())
            and torch.equal(cpu[stage].b.data, gpu[stage].b.data.cpu()))
    emit({"phase": "cross", "params": "test_medium", "N": p.N, "L": p.L,
          "equal": equal, "gpu_launches": launches})
    if not all(equal.values()):
        raise AssertionError(f"CPU and GPU ciphertexts differ: {equal}")
    digest = pl.to_numpy(gpu["rot4"].b.data)[:2, :4].tolist()
    return digest


def phase_pipeline(params):
    import numpy as np
    from repro_torch.core import encoding as enc, keys as K, rns
    t0 = time.perf_counter()
    for q in params.q + params.p:
        rns.prime_tables(q, params.N)
    tables_s = time.perf_counter() - t0
    n = 16
    z1, z2 = _messages(n, 1), _messages(n, 2)
    keys, cts, times, launches = _pipeline(params, DEVICE, z1, z2, warm_reps=5)
    prod = np.concatenate([z1 * z2, np.zeros(params.slots - n)])
    want = {"rescale": prod[:n], "rot1": np.roll(prod, -1)[:n],
            "rot4": np.roll(prod, -4)[:n]}
    t0 = time.perf_counter()
    errors = {}
    for stage, z in want.items():
        ct = cts[stage]
        got = enc.decode(K.decrypt(ct, keys.sk), ct.scale, ct.basis, params.N, n)
        errors[stage] = float(np.max(np.abs(got - z)))
    decode_s = time.perf_counter() - t0
    emit({"phase": "pipeline", "params": "paper_full", "N": params.N,
          "L": params.L, "K": params.K, "dnum": params.dnum,
          "levels": {s: cts[s].level for s in cts}, "max_error": errors,
          "launches": launches, "host_tables_s": tables_s,
          "decrypt_decode_s": decode_s, **times})
    if not all(e < 1e-2 for e in errors.values()):
        raise AssertionError(f"decode error ≥ 1e-2: {errors}")
    for family in ("eltwise", "bconv", "auto_ks", "automorphism"):
        if launches.get(family, 0) <= 0:
            raise AssertionError(f"kernel family {family} never launched: {launches}")
    return launches


def kernel_table(rows, launches):
    """One entry per kernel: its first case's numbers, the main path's
    launches of its family, and every measured case."""
    table = []
    for kernel in dict.fromkeys(r["kernel"] for r in rows):
        cases = [r for r in rows if r["kernel"] == kernel]
        main_case = cases[0]
        table.append({"name": kernel, "launches": launches.get(main_case["family"], 0),
                      **{k: main_case[k] for k in (
                          "route", "source", "replaces", "max_abs_err", "ms",
                          "plain_ms", "bound_ms", "bound_by", "library_ms",
                          "equal", "shape")},
                      "cases": [{k: c[k] for k in (
                          "name", "shape", "equal", "max_abs_err", "ms",
                          "plain_ms", "bound_ms", "bound_by", "library_ms")}
                          for c in cases]})
    return table


def main() -> int:
    import torch
    t_start = time.perf_counter()
    phase_device()
    from repro_torch.core import params as prm
    phase_build()
    paper = prm.paper_full()
    rows = phase_kernels(paper)
    phase_cross()
    launches = phase_pipeline(paper)
    table = kernel_table(rows, launches)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
