#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc`` and runs, each phase printing one JSON line:

1. device   — the card (fails without CUDA), ``nvidia-smi`` name/power limit;
2. build    — one ``nvcc`` per kernel source, all at once, and ptxas's
              report (registers, shared memory, spills) of the cluster
              permutation kernel, the one-pass NTT kernels, BConvU and
              AutoU∘KS;
3. kernels  — each kernel against its plain torch version on the card at the
              shapes the ``paper_full`` pipeline gives it (N = 2¹⁶, L = 48,
              K = 12, dnum = 4): bit-equal, with kernel / plain / library
              times and the memory-or-operations bound; the NTT also against
              the fused plain transform, round trip included, on inputs in
              [0, 2q), and at every cluster size its split allows (one launch
              per transform, each limb held in a thread-block cluster's
              shared memory); BConvU as the whole conversion (pre-scale
              included) against the plain one, also at several shares of the
              destination primes per CTA; the NTT, multi-permutation and eager kernels
              also with their cluster size and shared memory per CTA, and the
              eager kernel on index tables whose reads are local, remote in
              order, or scattered;
4. cross    — keygen → encrypt → hmult → rescale → hrot_hoisted([1, 4]) at
              ``test_medium`` on the CPU (plain versions) and on the card
              (kernels), on the fused and on the eager engine: every
              ciphertext must have equal bytes;
5. pipeline — the same pipeline at ``paper_full`` on the card with |z| ≤ 1,
              then the eager engine's hoisted pair: decode error against
              plaintext math must be < 1e-2; each op runs with the launch
              counts reset just before it and read just after, and every
              kernel of the path must have launched, the NTT in every op;
              no plain NTT, plain gather, plain multi-permutation, plain
              AutoU∘KS or plain BConv table product may run on card data;
6. autotune — ``python -m repro_torch.kernels.autotune --quick`` for the NTT
              (R × cluster size) and the single permutation at N = 2¹⁶,
              ℓ = 48, its cache in a temporary directory;
7. card tests — ``pytest -m cuda tests/test_torch_cuda.py`` in a subprocess
              (every kernel against its plain version at small shapes, the
              NTT at every cluster size of every split it is tested at);

then the kernel table as one JSON line, and the result line
``{"ok": true, "device": {...}}`` last.  Any failure raises: the script exits
non-zero and prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
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


def ptxas_report(log: str, kernel: str) -> list[str]:
    """ptxas's lines (registers, shared memory, spills) for the entry
    function whose mangled name contains ``kernel``."""
    lines, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        if inside:
            lines.append(line.strip())
    return lines


# Kernels whose ptxas report (registers, spills, shared memory) the build
# phase prints: (source, entry-function name); the NTT kernels are templates
# on the cluster size and BConvU on ℓ, so each reports one entry per
# instantiation.
PTXAS_KERNELS = (("automorphism", "perm_cluster_kernel"), ("ntt", "ntt_fwd_kernel"),
                 ("ntt", "ntt_inv_kernel"), ("bconv", "bconv_kernel"),
                 ("automorphism", "auto_ks_kernel"))


def phase_build():
    from repro_torch.kernels import native
    seconds = native.build()
    for name in native.SOURCES:
        native.lib(name)
    reports = {}
    for source, kernel in PTXAS_KERNELS:
        log = native.library_path(source).with_suffix(".log").read_text()
        reports[f"ptxas_{kernel}"] = ptxas_report(log, kernel)
    emit({"phase": "build", "seconds": seconds, "nvcc": native.nvcc(),
          "libraries": [native.library_path(n).name for n in native.SOURCES],
          **reports})
    missing = [k for k, lines in reports.items() if not lines]
    if missing:
        raise AssertionError(f"no ptxas report for {missing}")


def phase_kernels(params):
    """Each kernel vs its plain version at the paper_full pipeline shapes."""
    import torch
    from repro_torch.core import const_cache, ntt as nttm, poly as pl
    from repro_torch.kernels import autotune
    from repro_torch.kernels.automorphism import ops as auto_ops
    from repro_torch.kernels.bconv import ops as bconv_ops
    from repro_torch.kernels.eltwise import ops as elt_ops
    from repro_torch.kernels.ntt import ops as ntt_ops

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    N, L, K = params.N, params.L, params.K
    q48 = params.q[:L]
    rows = []

    def case(kernel, name, family, source, replaces, cuda_fn, plain_fn, args,
             nbytes, ops, library=None, extra=None, info=None):
        got = cuda_fn(*args)
        want = plain_fn(*args)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        checks = extra(got) if extra else {}
        equal = equal and all(checks.values())
        b_ms, b_by = bound_ms(nbytes, ops)
        row = {"kernel": kernel, "name": name, "family": family, "route": "cuda", "source": source,
               "replaces": replaces, "shape": list(args[0].shape),
               "equal": equal, "max_abs_err": err, **checks,
               "ms": gpu_ms(lambda: cuda_fn(*args)),
               "plain_ms": gpu_ms(lambda: plain_fn(*args), reps=2, rounds=3),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": gpu_ms(lambda: library(*args)) if library else None,
               **(info or {})}
        emit({"phase": "kernel", **row})
        if not equal:
            raise AssertionError(f"{name}: kernel differs from its plain version "
                                 f"(max |diff| {err}, checks {checks})")
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

    # BConvU, the whole conversion (pre-scale in the kernel): ModUp of one
    # digit (α = 12 limbs → 36 + 12 = 48) and the stacked ModDown of a
    # hoisted pair of rotations (4 × 12 → 46).  Bytes: x read once, out
    # written once, the u32 table and the per-prime constants the kernel reads
    # (q, q̂⁻¹ as int64 and its u32 Shoup companion per source; p as int64
    # and ⌊2⁶⁴/p⌋ per destination)
    for name, src_b, dst_b, B in (
            ("bconv_moddown_4x12_to_46", params.p, params.q[:L - 2], 4),
            ("bconv_modup_1x12_to_48", params.q[:12], params.q[12:L] + params.p, 1)):
        x = residues(src_b, (B,), N, gen)
        ell, k = len(src_b), len(dst_b)
        resident = bconv_ops.resident_ctas(ell, dev)
        case("bconvu", name, "bconv", src + "bconv.cu", "src/repro/kernels/bconv/kernel.py:59",
             lambda a, s=src_b, d=dst_b: bconv_ops.bconv_cuda(a, s, d),
             lambda a, s=src_b, d=dst_b: bconv_ops.bconv_plain(a, s, d), [x],
             nbytes=(B * ell * N + B * k * N + k * ell) * 4 + ell * 20 + k * 16,
             ops=2 * B * k * ell * N,
             info={"chunk": bconv_ops.chunk_plan(B, k, N, resident),
                   "resident_ctas": resident})

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
         lambda e, a, b: auto_ops.auto_ks_cuda(e, a, b, gs, ext_basis),
         lambda e, a, b: auto_ops.auto_ks_plain(e, a, b, perms, qx),
         [exts, evk_a, evk_b],
         # bytes: digits, keys and outputs once each, two u32 words of the
         # Galois map per rotation, q (int64) and ⌊2⁶⁴/q⌋ per limb
         nbytes=(J * Lx * N + 2 * R * J * Lx * N + 2 * R * Lx * N + 2 * R) * 4 + Lx * 16,
         ops=4 * R * J * Lx * N)

    # the cluster plan the multi-permutation and eager wrappers take at N
    C, S, T = auto_ops.cluster_plan(N)
    cluster_info = {"cluster": C, "smem_bytes_per_cta": 4 * S}

    # multi-permutation: the rotated b-halves, (1, 46, N) → R = 2
    xb = residues(params.q[:L - 2], (1,), N, gen)
    case("automorphism_multi", "automorphism_multi_G1_R2_L46", "automorphism",
         src + "automorphism.cu",
         "src/repro/kernels/automorphism/kernel.py:118",
         lambda x: auto_ops.automorphism_multi_cuda(x, perms),
         lambda x: auto_ops.automorphism_multi_plain(x, perms), [xb],
         nbytes=(xb.numel() + R * xb.numel()) * 4 + R * N * 8, ops=0,
         library=lambda x: torch.gather(
             x.expand(R, -1, -1), 2, perms[:, None, :].expand(R, x.shape[1], N)),
         info=cluster_info)

    # four-step NTT at the default R and cluster size: hmult's operand and a
    # ModUp extension (forward), ModUp's iNTT of the operand and the stacked
    # relinearization ModDown's P-part (inverse); inputs in [0, 2q); each also
    # bit-equal and timed at every other cluster size the split allows
    for fwd, name, basis, lead in (
            (True, "ntt_fwd_1x48", params.q[:L], (1,)),
            (True, "ntt_fwd_modup_ext_1x48", params.q[12:L] + params.p, (1,)),
            (False, "ntt_inv_1x48", params.q[:L], (1,)),
            (False, "ntt_inv_moddown_2x12", params.p, (2,))):
        ell = len(basis)
        qb = const_cache.device_q(basis, dev)
        xl = (residues(basis, lead, N, gen).to(torch.int64)
              + qb * torch.randint(0, 2, (*lead, ell, N), generator=gen,
                                   device=dev)).to(torch.int32)    # [0, 2q)
        split, cluster = ntt_ops.resolve(xl, None, None)
        fc = const_cache.device_four_step_consts(basis, N, split, dev)
        nc = const_cache.device_ntt_consts(basis, N, dev)
        fused = (nttm.ntt if fwd else nttm.intt)(xl, nc)
        back = ntt_ops.ntt_inv if fwd else ntt_ops.ntt_fwd
        reduced = (xl.to(torch.int64) % qb).to(torch.int32)

        sizes = [c for c in ntt_ops.CLUSTER_SIZES if ntt_ops.cluster_ok(N, split, c)]
        run = {c: (lambda x, fc=fc, fwd=fwd, c=c: ntt_ops.ntt_cuda(x, fc, fwd, c))
               for c in sizes}

        def extra(got, fused=fused, back=back, basis=basis, reduced=reduced,
                  run=run, xl=xl):
            return {"equal_fused": torch.equal(got, fused),
                    "round_trip": torch.equal(back(got, basis), reduced),
                    "equal_every_cluster": all(torch.equal(f(xl), got)
                                               for f in run.values())}
        B = xl.numel() // N
        # bytes: data in and out, twiddles and stage tables with companions;
        # operations: per limb (N/2)·log₂N butterflies and N twiddle products
        case("ntt_fwd" if fwd else "ntt_inv", name, "ntt", src + "ntt.cu",
             "src/repro/kernels/ntt/kernel.py:156", run[cluster],
             lambda x, fc=fc, fwd=fwd: ntt_ops.ntt_plain(x, fc, fwd), [xl],
             nbytes=(2 * B * N + 2 * ell * (N + split + N // split)) * 4,
             ops=B * (N // 2 * (N.bit_length() - 1) + N),
             extra=extra,
             info={"R": split, "cluster": cluster,
                   "smem_bytes_per_cta": ntt_ops.smem_bytes_per_cta(N, split, cluster),
                   "ms_by_cluster": {c: gpu_ms(lambda f=f: f(xl))
                                     for c, f in run.items()}})

    # single permutation: φ_g of a stacked pair (2, 46, N); eager: (1, 46, N)
    perm = const_cache.device_galois_perm(N, gs[0], dev)
    x2 = residues(params.q[:L - 2], (2,), N, gen)
    rows_per_cta = autotune.best_config("automorphism", N, L - 2)["rows_per_cta"]
    case("automorphism", "automorphism_2x46", "automorphism",
         src + "automorphism.cu", "src/repro/kernels/automorphism/kernel.py:82",
         lambda x: auto_ops.automorphism_cuda(x, perm, rows_per_cta),
         lambda x: auto_ops.automorphism_plain(x, perm), [x2],
         nbytes=2 * x2.numel() * 4 + N * 8, ops=0,
         library=lambda x: x.index_select(-1, perm))
    case("automorphism_eager", "automorphism_eager_1x46", "automorphism",
         src + "automorphism.cu", "src/repro/kernels/automorphism/kernel.py:54",
         lambda x: auto_ops.automorphism_eager_cuda(x, perm),
         lambda x: auto_ops.automorphism_eager_plain(x, perm), [xb],
         nbytes=2 * xb.numel() * 4 + N * 8, ops=0,
         library=lambda x: x.index_select(-1, perm),
         info=cluster_info)

    # what the gathers' pattern costs on the SM-to-SM network: the eager
    # kernel at its cluster plan on index tables whose reads are all local
    # and in order, partly remote and in order, or scattered, each with the
    # share of its reads that falls outside the reading CTA's window
    k = torch.arange(N, device=dev)
    tables = {"identity": k, "half_shift": (k + N // 2) % N, "galois": perm,
              "random": torch.randint(0, N, (N,), generator=gen, device=dev)}
    chunk = (-(-N // C) + 3) // 4 * 4         # the outputs each CTA writes
    base = torch.clamp((k // chunk) * T, max=N - S)
    remote = {name: float(((t - base < 0) | (t - base >= S)).double().mean())
              for name, t in tables.items()}
    equal = {name: bool(torch.equal(auto_ops.automorphism_eager_cuda(xb, t),
                                    auto_ops.automorphism_eager_plain(xb, t)))
             for name, t in tables.items()}
    emit({"phase": "cluster_tables", "kernel": "automorphism_eager",
          "shape": list(xb.shape), "cluster": C, "equal": equal,
          "remote_share": remote,
          "ms": {name: gpu_ms(lambda t=t: auto_ops.automorphism_eager_cuda(xb, t))
                 for name, t in tables.items()}})
    if not all(equal.values()):
        raise AssertionError(f"eager kernel differs on an index table: {equal}")
    return rows


def _timed_op(fn, sync):
    """(result, host ms ending in a device sync, per-kernel launches), with
    the launch counts reset just before the op and read just after."""
    from repro_torch.kernels import config
    config.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, config.kernel_launch_counts()


def _run_ops(cts, keys, params, rotations, sync):
    """hmult → rescale → hoisted rotations once: ({stage: ciphertext},
    {op: milliseconds on the host clock, each ending in a device sync},
    {op: per-kernel launches})."""
    from repro_torch.core import ckks
    m, hm_ms, hm_l = _timed_op(lambda: ckks.hmult(cts[0], cts[1], keys), sync)
    r, rs_ms, rs_l = _timed_op(lambda: ckks.rescale(m, params), sync)
    rots, rot_ms, rot_l = _timed_op(
        lambda: ckks.hrot_hoisted(r, list(rotations), keys), sync)
    ms = {"hmult_ms": hm_ms, "rescale_ms": rs_ms, "hoisted_rotations_ms": rot_ms}
    launches = {"hmult": hm_l, "rescale": rs_l, "hoisted_rotations": rot_l}
    return {"hmult": m, "rescale": r, "rot1": rots[0], "rot4": rots[1]}, ms, launches


def _sync_for(device):
    import torch

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    return sync


@contextlib.contextmanager
def plain_calls_on_card():
    """Count the calls of the NTT's, the AutoU kernels' and BConvU's plain
    versions on CUDA data while the block runs (the main path, on the kernel
    BConv engine, must make none): the fused plain transform, the plain
    four-step, the plain single, eager and multi-permutation gathers, the
    plain AutoU∘KS, the plain BConv table product."""
    from repro_torch.core import ntt as nttm
    from repro_torch.kernels.automorphism import ops as auto_ops
    from repro_torch.kernels.bconv import ops as bconv_ops
    calls = collections.Counter()
    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (nttm, "ntt"), (nttm, "intt"), (nttm, "four_step_ntt"),
        (nttm, "four_step_intt"), (auto_ops, "automorphism_plain"),
        (auto_ops, "automorphism_eager_plain"),
        (auto_ops, "automorphism_multi_plain"), (auto_ops, "auto_ks_plain"),
        (bconv_ops, "bconv_matmul_plain"))]

    def counted(name, fn):
        def wrapper(x, *args, **kwargs):
            if x.is_cuda:
                calls[name] += 1
            return fn(x, *args, **kwargs)
        return wrapper
    for mod, name, fn in saved:
        setattr(mod, name, counted(name, fn))
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _pipeline(params, device, z1, z2, rotations=(1, 4), warm_reps=0):
    """keygen → encrypt, then the ops once, each with the launch counters
    reset just before and read just after (the cold run, which also stages
    the constants and regenerates the evk a-halves), then ``warm_reps`` more
    runs whose median per-op times are the steady-state latencies."""
    import numpy as np
    from repro_torch.core import encoding as enc, keys as K

    sync = _sync_for(device)

    t0 = time.perf_counter()
    keys = K.keygen(params, rotations=rotations, seed=SEED, device=device)
    scale = params.scale()
    cts = [K.encrypt(enc.encode(z, scale, params.q, params.N), scale, keys.sk,
                     params.q, params.N, rng=np.random.default_rng(i + 1),
                     device=device) for i, z in enumerate((z1, z2))]
    sync()
    times = {"keygen_encrypt_s": time.perf_counter() - t0}
    with plain_calls_on_card() as plain:
        out, cold, launches = _run_ops(cts, keys, params, rotations, sync)
    if plain:
        raise AssertionError(f"plain versions ran on card data: {dict(plain)}")
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
    """Equal bytes from the plain versions on the CPU and the kernels on the
    card, on both engines."""
    import torch
    from repro_torch.core import ckks, params as prm
    p = prm.test_medium()
    z1, z2 = _messages(8, 1), _messages(8, 2)
    equal, gpu_launches = {}, {}
    for engine in ("fused", "eager"):
        with ckks.use_engine(engine):
            _, cpu, _, _ = _pipeline(p, "cpu", z1, z2)
            _, gpu, _, gpu_launches[engine] = _pipeline(p, DEVICE, z1, z2)
        for stage in cpu:
            equal[f"{engine}/{stage}"] = bool(
                torch.equal(cpu[stage].a.data, gpu[stage].a.data.cpu())
                and torch.equal(cpu[stage].b.data, gpu[stage].b.data.cpu()))
    emit({"phase": "cross", "params": "test_medium", "N": p.N, "L": p.L,
          "equal": equal, "gpu_launches": gpu_launches})
    if not all(equal.values()):
        raise AssertionError(f"CPU and GPU ciphertexts differ: {equal}")
    if not any(ops.get("hoisted_rotations", {}).get("automorphism", 0)
               for ops in gpu_launches.values()):
        raise AssertionError("the eager engine never ran the single-permutation kernel")


# Kernels each run of the main path must launch: the fused engine's three ops,
# then the eager engine's hoisted pair.
FUSED_PATH_KERNELS = ("efu", "bconvu", "ntt_fwd", "ntt_inv", "auto_ks",
                      "automorphism_multi")
EAGER_PATH_KERNELS = ("ntt_fwd", "ntt_inv", "automorphism")


def phase_pipeline(params):
    import numpy as np
    from repro_torch.core import ckks, const_cache, encoding as enc, keys as K, rns
    t0 = time.perf_counter()
    for q in params.q + params.p:
        rns.prime_tables(q, params.N)
    tables_s = time.perf_counter() - t0
    n = 16
    z1, z2 = _messages(n, 1), _messages(n, 2)
    keys, cts, times, launches = _pipeline(params, DEVICE, z1, z2, warm_reps=5)
    # the eager engine's hoisted pair: permutes the hoisted digits and b
    # through RnsPoly.automorphism, the single-permutation kernel
    sync = _sync_for(DEVICE)
    eager = lambda: ckks.hrot_hoisted(cts["rescale"], [1, 4], keys)
    with ckks.use_engine("eager"):
        with plain_calls_on_card() as plain:
            rots, cold_ms, launches["eager_hoisted_rotations"] = _timed_op(eager, sync)
        warm = [_timed_op(eager, sync)[1] for _ in range(3)]
    if plain:
        raise AssertionError(f"plain versions ran on card data: {dict(plain)}")
    times.update({"cold_eager_hoisted_rotations_ms": cold_ms,
                  "eager_hoisted_rotations_ms": statistics.median(warm)})
    cts.update({"eager_rot1": rots[0], "eager_rot4": rots[1]})
    prod = np.concatenate([z1 * z2, np.zeros(params.slots - n)])
    want = {"rescale": prod[:n], "rot1": np.roll(prod, -1)[:n],
            "rot4": np.roll(prod, -4)[:n], "eager_rot1": np.roll(prod, -1)[:n],
            "eager_rot4": np.roll(prod, -4)[:n]}
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
          "launches": launches, "plain_calls_on_card": 0,
          "four_step_tables_mb": const_cache.staged_bytes("four_step", DEVICE) / 1e6,
          "host_tables_s": tables_s, "decrypt_decode_s": decode_s, **times})
    if not all(e < 1e-2 for e in errors.values()):
        raise AssertionError(f"decode error ≥ 1e-2: {errors}")
    for op, counts in launches.items():
        path = EAGER_PATH_KERNELS if op.startswith("eager") else ()
        for kernel in path + ("ntt_fwd", "ntt_inv"):
            if counts.get(kernel, 0) <= 0:
                raise AssertionError(f"{op}: kernel {kernel} never launched: {counts}")
    total = collections.Counter()
    for counts in launches.values():
        total.update(counts)
    for kernel in FUSED_PATH_KERNELS + EAGER_PATH_KERNELS:
        if total[kernel] <= 0:
            raise AssertionError(f"kernel {kernel} never launched: {dict(total)}")
    return dict(total)


def phase_autotune(params, cache_file):
    """A quick sweep of the NTT's and the single permutation's knobs through
    the autotuner's command-line entry point."""
    from repro_torch.kernels import autotune
    t0 = time.perf_counter()
    autotune.main(["--families", "ntt", "automorphism", "--N", str(params.N),
                   "--L", str(params.L), "--quick", "--out", str(cache_file)])
    winners = {k: {"config": e["config"], "us": e["us"],
                   "sweep": [(s["config"], s["us"]) for s in e["sweep"]]}
               for k, e in autotune.entries().items()}
    emit({"phase": "autotune", "N": params.N, "L": params.L,
          "seconds": time.perf_counter() - t0, "winners": winners})
    if len(winners) != 2:
        raise AssertionError(f"autotune recorded {sorted(winners)}")


def phase_card_tests():
    """The card tests (``tests/test_torch_cuda.py``, marker ``cuda``) in a
    subprocess with a private autotune cache; fails if any fails."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.pathsep.join(filter(None, (str(ROOT / "src"),
                                             os.environ.get("PYTHONPATH"))))
        env = dict(os.environ, PYTHONPATH=path,
                   REPRO_AUTOTUNE_CACHE=str(Path(tmp) / "autotune.json"))
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
             "no:cacheprovider", str(ROOT / "tests" / "test_torch_cuda.py")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    emit({"phase": "card_tests", "rc": proc.returncode, "summary": summary,
          "seconds": time.perf_counter() - t0})
    if proc.returncode != 0:
        print(proc.stdout[-8000:], proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"card tests failed: {summary}")


# How the kernels that were redesigned for Hopper work (the kernel table
# carries it beside their numbers).
DESIGN = {
    "ntt_fwd": "one launch per transform, no global scratch: each limb held "
               "in the shared memory of a thread-block cluster (R/cluster whole "
               "rows per CTA), stages across CTAs through distributed shared "
               "memory",
    "automorphism_multi": "perm_cluster_kernel: each limb row staged once by "
                          "the TMA across a thread-block cluster",
    "bconvu": "the q̂⁻¹ pre-scale fused in: each thread reads its ℓ source "
              "words once (16-byte loads), Shoup-scales them in registers and "
              "runs its chunk of destination primes against a table staged in "
              "shared memory, one Barrett per output",
    "auto_ks": "limb-major grid, every rotation of a limb in one thread (two "
               "at a time inside the loop over the digits), so the hoisted "
               "digits cross device memory once; the Galois map computed in "
               "registers from its affine form; 16-byte evk loads and stores, "
               "one Barrett per output",
}
DESIGN["ntt_inv"] = DESIGN["ntt_fwd"]
DESIGN["automorphism_eager"] = DESIGN["automorphism_multi"]


def kernel_table(rows, launches):
    """One entry per kernel: its first case's numbers, the main path's
    launches of that kernel, and every measured case."""
    table = []
    for kernel in dict.fromkeys(r["kernel"] for r in rows):
        cases = [r for r in rows if r["kernel"] == kernel]
        main_case = cases[0]
        table.append({"name": kernel, "launches": launches.get(kernel, 0),
                      "on_main_path": kernel in FUSED_PATH_KERNELS + EAGER_PATH_KERNELS,
                      **({"design": DESIGN[kernel]} if kernel in DESIGN else {}),
                      **{k: main_case[k] for k in (
                          "route", "source", "replaces", "max_abs_err", "ms",
                          "plain_ms", "bound_ms", "bound_by", "library_ms",
                          "equal", "shape")},
                      "cases": [{k: c[k] for k in (
                          "name", "shape", "equal", "max_abs_err", "ms",
                          "plain_ms", "bound_ms", "bound_by", "library_ms",
                          "R", "cluster", "smem_bytes_per_cta", "ms_by_cluster",
                          "chunk", "resident_ctas")
                          if k in c} for c in cases]})
    return table


def main() -> int:
    import torch
    t_start = time.perf_counter()
    phase_device()
    from repro_torch.core import params as prm
    from repro_torch.kernels import autotune
    with tempfile.TemporaryDirectory() as tmp:
        # a private, cold launch-config cache: every knob takes its default
        # until the autotune phase, which runs last
        cache_file = Path(tmp) / "autotune.json"
        autotune.set_cache_path(cache_file)
        phase_build()
        paper = prm.paper_full()
        rows = phase_kernels(paper)
        phase_cross()
        launches = phase_pipeline(paper)
        phase_autotune(paper, cache_file)
        autotune.set_cache_path(None)
    phase_card_tests()
    table = kernel_table(rows, launches)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
