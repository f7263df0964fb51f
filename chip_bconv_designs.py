#!/usr/bin/env python3
"""BConvU for ℓ > 16: the port's kernel against a shared-memory design, on one GPU.

    python3 chip_bconv_designs.py

For more than 16 source primes each source word must be loaded and
Shoup-scaled once per CTA and then serve every destination prime of the CTA.
Two designs do that:

* (a) ``bconv_kernel<ℓ>`` / ``bconv_kernel_wide<ℓ>`` in
  ``src/repro_torch/kernels/csrc/bconv.cu`` (the port's): each thread holds
  the scaled words of 2 coefficients (ℓ ≤ 32) or 1 (ℓ ≤ 64) in registers;
* (b) ``bconv_staged_kernel<ℓ>`` below: the CTA stages the scaled ℓ × 256
  block in dynamic shared memory (one word a thread and limb, coalesced),
  then each thread computes 4 coefficients of every fourth destination prime
  of the CTA from it (16-byte shared-memory reads; more than 48 KiB from
  ℓ = 48 on).

Both run at ARK's shard shape on the distributed engine (32 batch rows of
N/16 = 4096 coefficients → 12 primes, N = 2¹⁶) for ℓ ∈ {20, 32, 36, 48, 60}
and at a ModDown-like (4, 48, N) → 12; each must equal the plain version bit
for bit, and each is timed by CUDA-graph replays (``chip_smoke.gpu_ms``).
Prints the card, ptxas's report of both designs and one JSON line per shape.

    python3 chip_bconv_designs.py --parent DIR

first runs ``chip_smoke.py``'s BConvU rows (its kernel phase's single-device
shapes and the distributed engine's shard shapes, every other kernel
skipped) in the checkout at DIR and in this one, in the order parent,
change, change, parent, each in a process of its own, and prints their
times.  Fails without CUDA.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

STAGED_SOURCE = r'''
#include <utility>
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;          // coefficients per CTA
constexpr int kMaxChunk = 64;

__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t w, uint32_t ws,
                                          uint32_t q) {
  const uint32_t r = x * w - __umulhi(x, ws) * q;
  return r >= q ? r - q : r;
}

__host__ __device__ constexpr int ell_of(int ell) { return (ell + 3) & ~3; }

__host__ __device__ constexpr size_t smem_bytes(int ell, int chunk) {
  return static_cast<size_t>(ell_of(ell)) * kTile * 4 +
         static_cast<size_t>(chunk) * (ell_of(ell) * 4 + 12);
}

template <int ELL>
__global__ void __launch_bounds__(kThreads)
bconv_staged_kernel(const uint32_t* __restrict__ x, const int64_t* __restrict__ q_src,
                    const int64_t* __restrict__ qhat_inv,
                    const uint32_t* __restrict__ qhat_inv_shoup,
                    const uint32_t* __restrict__ table, const int64_t* __restrict__ q_dst,
                    const uint64_t* __restrict__ mu, uint32_t* __restrict__ out,
                    int ell, int Bg, int Kg, int n, int chunk, long long sg,
                    long long sb, long long si, int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_x = smem;                                  // [ELL][kTile], scaled
  uint32_t* s_tab = s_x + ELL * kTile;                   // [chunk][ELL]
  uint64_t* s_mu = reinterpret_cast<uint64_t*>(s_tab + chunk * ELL);
  uint32_t* s_p = reinterpret_cast<uint32_t*>(s_mu + chunk);

  const int z = static_cast<int>(blockIdx.z);
  const int g = z / Bg;
  const int b = z - g * Bg;
  const int j0 = static_cast<int>(blockIdx.y) * chunk;
  const int kc = min(chunk, Kg - j0);
  const long long row0 = static_cast<long long>(g) * Kg + j0;
  for (int w = threadIdx.x; w < kc * ELL; w += kThreads) {
    const int jj = w / ELL, i = w - jj * ELL;
    s_tab[w] = i < ell ? table[(row0 + jj) * ell + i] : 0u;
  }
  for (int w = threadIdx.x; w < kc; w += kThreads) {
    s_p[w] = static_cast<uint32_t>(q_dst[row0 + w]);
    s_mu[w] = mu[row0 + w];
  }
  // every source word of the tile loaded and scaled once, by one thread
  const int c = threadIdx.x;
  const int nc = static_cast<int>(blockIdx.x) * kTile + c;
  const uint32_t* xb = x + g * sg + b * sb + nc;
#pragma unroll 8
  for (int i = 0; i < ELL; ++i) {
    uint32_t v = 0u;
    if (i < ell && nc < n)
      v = shoup(__ldg(xb + i * si), static_cast<uint32_t>(qhat_inv[i]),
                qhat_inv_shoup[i], static_cast<uint32_t>(q_src[i]));
    s_x[i * kTile + c] = v;
  }
  __syncthreads();

  const int quad = threadIdx.x & 63, grp = threadIdx.x >> 6;
  const int n0 = static_cast<int>(blockIdx.x) * kTile + 4 * quad;
  if (n0 >= n) return;
  const int left = n - n0;
  uint32_t* ob = out + (static_cast<long long>(z) * Kg + j0) * n + n0;
  for (int jj = grp; jj < kc; jj += 4) {
    const uint32_t* row = s_tab + jj * ELL;
    const uint32_t p = s_p[jj];
    const uint64_t m = s_mu[jj];
    repro::Acc64 acc[4];
#pragma unroll
    for (int i = 0; i < ELL; ++i) {
      const uint4 t = *reinterpret_cast<const uint4*>(s_x + i * kTile + 4 * quad);
      const uint32_t w = row[i];
      acc[0].mac(t.x, w);
      acc[1].mac(t.y, w);
      acc[2].mac(t.z, w);
      acc[3].mac(t.w, w);
      if ((i + 1) % repro::kReduceEvery == 0 && i + 1 < ELL) {
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[v] = {repro::barrett(acc[v].value(), p, m), 0};
      }
    }
    uint32_t o[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) o[v] = repro::barrett(acc[v].value(), p, m);
    repro::store4(ob + static_cast<long long>(jj) * n, o, left, vec);
  }
}

using Kernel = void (*)(const uint32_t*, const int64_t*, const int64_t*,
                        const uint32_t*, const uint32_t*, const int64_t*,
                        const uint64_t*, uint32_t*, int, int, int, int, int,
                        long long, long long, long long, int);

template <int... E>
Kernel pick(int ell, std::integer_sequence<int, E...>) {
  Kernel k = nullptr;
  ((k = ell_of(ell) == 20 + 4 * E ? bconv_staged_kernel<20 + 4 * E> : k), ...);
  return k;
}

Kernel kernel_for(int ell) { return pick(ell, std::make_integer_sequence<int, 12>{}); }

// raises the kernel's shared-memory limit to its largest chunk; called by
// bconv_staged_ctas_per_sm, which the wrapper calls before any launch
int prepare(int ell) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel_for(ell), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(ell, kMaxChunk))));
}

}  // namespace

extern "C" int bconv_staged_ctas_per_sm(int ell, int chunk, int* ctas) {
  if (ell <= 16 || ell > 64 || chunk <= 0 || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (int err = prepare(ell)) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, kernel_for(ell), kThreads, smem_bytes(ell, chunk)));
}

extern "C" int bconv_staged_launch(const void* x, const void* q_src, const void* qhat_inv,
                                   const void* qhat_inv_shoup, const void* table,
                                   const void* q_dst, const void* mu, void* out, int G,
                                   int Bg, int ell, int Kg, int n, int chunk,
                                   long long sg, long long sb, long long si,
                                   void* stream) {
  if (ell <= 16 || ell > 64 || chunk <= 0 || chunk > kMaxChunk ||
      static_cast<long long>(G) * Bg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = n % 4 == 0 && repro::aligned16(out);
  const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile),
                  static_cast<unsigned>((Kg + chunk - 1) / chunk),
                  static_cast<unsigned>(G * Bg));
  kernel_for(ell)<<<grid, kThreads, smem_bytes(ell, chunk),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int64_t*>(q_src),
      static_cast<const int64_t*>(qhat_inv),
      static_cast<const uint32_t*>(qhat_inv_shoup),
      static_cast<const uint32_t*>(table), static_cast<const int64_t*>(q_dst),
      static_cast<const uint64_t*>(mu), static_cast<uint32_t*>(out), ell, Bg, Kg, n,
      chunk, sg, sb, si, vec);
  return static_cast<int>(cudaGetLastError());
}
'''


def build_staged():
    """Compile design (b) next to the port's libraries; (library, ptxas log)."""
    from repro_torch.kernels import native
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = native.BUILD_DIR / "bconv_staged.cu"
    so = native.BUILD_DIR / "libbconv_staged.so"
    src.write_text(STAGED_SOURCE)
    proc = subprocess.run([native.nvcc(), *native.NVCC_FLAGS, "-I", str(native.CSRC),
                           "-o", str(so), str(src)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"design (b) failed to build:\n{log}")
    lib = ctypes.CDLL(str(so))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bconv_staged_launch.argtypes = [P] * 8 + [I] * 6 + [LL] * 3 + [P]
    lib.bconv_staged_ctas_per_sm.argtypes = [I, I, P]
    return lib, log


_staged_ctas: dict[int, int] = {}


def staged(lib, x, src, dst):
    """Design (b) on a (G, Bg, ℓ, n) operand read through its strides."""
    import torch
    from repro_torch.core import const_cache
    from repro_torch.kernels import native
    from repro_torch.kernels.bconv import ops as bconv_ops
    G, _, ell, n = x.shape
    k = len(dst) // G
    Bg, sg, sb, si = bconv_ops.batch_layout(x)
    if ell not in _staged_ctas:
        ctas = ctypes.c_int(0)
        native.check("bconv", lib.bconv_staged_ctas_per_sm(
            ell, bconv_ops.PLAN_CHUNK, ctypes.byref(ctas)), "design (b) occupancy")
        _staged_ctas[ell] = max(1, ctas.value)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunk = bconv_ops.chunk_plan(G * Bg, k, n, _staged_ctas[ell] * sms, 256)
    c = const_cache.device_bconv_consts(tuple(src), tuple(dst), x.device)
    out = torch.empty((G, Bg, k, n), dtype=torch.int32, device=x.device)
    err = lib.bconv_staged_launch(
        x.data_ptr(), c.q_src.data_ptr(), c.qhat_inv.data_ptr(),
        c.qhat_inv_shoup.data_ptr(), c.table_u32.data_ptr(), c.q_dst.data_ptr(),
        c.barrett.data_ptr(), out.data_ptr(), G, Bg, ell, k, n, chunk, sg, sb, si,
        native.stream_of(x))
    native.check("bconv", err, "design (b)")
    return out, {"chunk": chunk, "ctas_per_sm": _staged_ctas[ell]}


def bconv_rows(root: Path) -> None:
    """Print chip_smoke.py's BConvU rows in the checkout at ``root``."""
    os.chdir(root)
    sys.path[:0] = [str(root), str(root / "src"), str(root / "tests")]
    import torch
    import chip_smoke as CS
    from repro_torch.core import params as prm
    kernel_case = CS.kernel_case

    def bconv_only(rows, kernel, *args, **kwargs):
        if kernel == "bconvu":
            kernel_case(rows, kernel, *args, **kwargs)
    CS.kernel_case = bconv_only
    CS.phase_build()
    p = prm.paper_full()
    CS.phase_kernels(p)
    CS._dist_kernel_rows(p, torch.Generator(device="cuda").manual_seed(CS.SEED + 20))


def parent_and_change(parent: Path) -> None:
    """BConvU rows of the parent and of this checkout: parent, change,
    change, parent, each in a process of its own."""
    for who, root in (("parent", parent), ("change", ROOT), ("change", ROOT),
                      ("parent", parent)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--rows",
                               str(root)], capture_output=True, text=True)
        rows = {}
        for line in proc.stdout.splitlines():
            if line.startswith('{"phase": "kernel"'):
                r = json.loads(line)
                rows[r["name"]] = {k: r[k] for k in ("shape", "equal", "ms", "bound_ms")}
        print(json.dumps({"phase": "rows", "checkout": who, "rc": proc.returncode,
                          "rows": rows}), flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{who} rows failed:\n{proc.stderr[-4000:]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="checkout to compare the rows with")
    ap.add_argument("--rows", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rows:
        bconv_rows(args.rows.resolve())
        return 0
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import chip_smoke as CS
    from repro_torch.core import params as prm, rns
    from repro_torch.kernels import native
    from repro_torch.kernels.bconv import ops as bconv_ops
    CS.phase_device()
    if args.parent:
        parent_and_change(args.parent.resolve())
    native.build(("bconv",))
    lib, log = build_staged()
    print(json.dumps({"phase": "build", "ptxas_bconv_staged_kernel":
                      CS.ptxas_report(log, "bconv_staged_kernel"),
                      "ptxas_bconv_kernel": CS.ptxas_report(
                          native.library_path("bconv").with_suffix(".log").read_text(),
                          "bconv_kernel")}), flush=True)
    p = prm.paper_full()
    N, L = p.N, p.L
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    qp = p.q[:L] + p.p
    extra = tuple(rns.gen_ntt_primes(12, N, exclude=qp))    # past all of Q·P
    cases = [(f"ark_32x{ell}_to_12", qp[:ell], p.p if ell <= L else extra, (1, 32),
              N // 16) for ell in (20, 32, 36, 48, 60)]
    cases.append(("wide_4x48_to_12", qp[:L], p.p, (1, 4), N))
    ok = True
    for name, src, dst, lead, n in cases:
        x = CS.residues(src, lead, n, gen)
        ell, k = len(src), len(dst)
        want = bconv_ops.bconv_grouped_plain(x, src, dst)
        got_a = bconv_ops.bconv_grouped_cuda(x, src, dst)
        got_b, info = staged(lib, x, src, dst)
        torch.cuda.synchronize()
        rows = lead[1]
        b_ms, b_by = CS.bound_ms((rows * ell * n + rows * k * n + k * ell) * 4
                                 + ell * 20 + k * 16, 2 * rows * k * ell * n)
        row = {"phase": "design", "name": name, "shape": list(x.shape), "K": k,
               "equal_a": bool(torch.equal(got_a, want)),
               "equal_b": bool(torch.equal(got_b, want)),
               "ms_a": CS.gpu_ms(lambda: bconv_ops.bconv_grouped_cuda(x, src, dst)),
               "ms_b": CS.gpu_ms(lambda: staged(lib, x, src, dst)),
               "bound_ms": b_ms, "bound_by": b_by,
               "chunk_a": bconv_ops.chunk_plan(
                   rows, k, n, bconv_ops.resident_ctas(ell, dev), bconv_ops.tile_of(ell)),
               "resident_a": bconv_ops.resident_ctas(ell, dev), **{
                   f"{key}_b": v for key, v in info.items()}}
        print(json.dumps(row), flush=True)
        ok = ok and row["equal_a"] and row["equal_b"]
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
