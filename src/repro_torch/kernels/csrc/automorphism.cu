// AutoU: Galois automorphisms as natural-order NTT-domain index permutations,
// and the fused AutoU∘KS multiply-accumulate of hoisted key-switching.
//
// auto_ks replaces the TPU kernel
// src/repro/kernels/automorphism/kernel.py:auto_ks_pallas:
//
//   out[r, 0, i, k] = Σ_j exts[j, g, i, perm_r[k]] · evk_a[r, j, i, k]  mod q_i
//   out[r, 1, i, k] = Σ_j exts[j, g, i, perm_r[k]] · evk_b[r, j, i, k]  mod q_i
//
// with g = 0 when exts is shared by all R rotations (G = 1, hoisting) and
// g = r when each rotation has its own decomposition (G = R).  No permuted
// digit is written to memory: the permutation is a gather inside the MAC.
//
// automorphism_multi replaces
// src/repro/kernels/automorphism/kernel.py:automorphism_multi_pallas:
//
//   out[r, i, k] = x[g, i, perms[r, k]]        (same G ∈ {1, R} broadcast)
//
// One thread per output (r, i, k).  The TPU kernels keep a whole (limb block,
// N) tile in VMEM and gather there; a limb row at N = 2^16 is 256 KiB, more
// than a CTA's 227 KB of shared memory, so here the gather reads global
// memory directly and the 50 MB L2 carries it: the J·L·N·4 B of hoisted
// digits (3.6 MB per digit at the paper's L = 58) stay L2-resident while the
// R rotations' threads sweep them.
//
// Bound on the H100: bytes.  auto_ks must read the digits once and both evk
// halves (2·R·J·L·N words), and write 2·R·L·N words, for 2·R·J·L·N modular
// products; automorphism_multi only copies.  Design response: evk reads and
// all writes are coalesced (consecutive k per warp); the scattered digit
// reads stay within one 256 KiB limb row per warp, i.e. in L2; the u64
// accumulator is reduced every 15 products (common.cuh), so both halves of a
// rotation are summed in registers with one `%` per output at the end.
#include "common.cuh"

namespace {

__global__ void auto_ks_kernel(const uint32_t* __restrict__ exts,
                               const uint32_t* __restrict__ evk_a,
                               const uint32_t* __restrict__ evk_b,
                               const int64_t* __restrict__ perms,
                               const int64_t* __restrict__ q,
                               uint32_t* __restrict__ out,
                               int J, int G, int R, int L, int N) {
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long LN = static_cast<long long>(L) * N;
  if (idx >= R * LN) return;
  const int k = static_cast<int>(idx % N);
  const int i = static_cast<int>((idx / N) % L);
  const int r = static_cast<int>(idx / LN);
  const int g = (G == 1) ? 0 : r;
  const long long src_k = perms[static_cast<long long>(r) * N + k];
  const uint64_t qi = static_cast<uint64_t>(q[i]);
  uint64_t acc_a = 0, acc_b = 0;
  int pending = 0;
  for (int j = 0; j < J; ++j) {
    const uint64_t e =
        exts[(static_cast<long long>(j) * G + g) * LN + i * static_cast<long long>(N) + src_k];
    const long long off = (static_cast<long long>(r) * J + j) * LN +
                          i * static_cast<long long>(N) + k;
    acc_a += e * evk_a[off];
    acc_b += e * evk_b[off];
    if (++pending == repro::kReduceEvery) {
      acc_a %= qi;
      acc_b %= qi;
      pending = 0;
    }
  }
  const long long o = (static_cast<long long>(r) * 2) * LN + i * static_cast<long long>(N) + k;
  out[o] = static_cast<uint32_t>(acc_a % qi);
  out[o + LN] = static_cast<uint32_t>(acc_b % qi);
}

__global__ void multi_perm_kernel(const uint32_t* __restrict__ x,
                                  const int64_t* __restrict__ perms,
                                  uint32_t* __restrict__ out,
                                  int G, int R, int L, int N) {
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long LN = static_cast<long long>(L) * N;
  if (idx >= R * LN) return;
  const int k = static_cast<int>(idx % N);
  const long long row = idx / N;                 // r·L + i
  const int r = static_cast<int>(row / L);
  const int i = static_cast<int>(row % L);
  const int g = (G == 1) ? 0 : r;
  out[idx] = x[g * LN + i * static_cast<long long>(N) +
               perms[static_cast<long long>(r) * N + k]];
}

}  // namespace

// exts (J, G, L, N) u32, evk_a/evk_b (R, J, L, N) u32, perms (R, N) int64,
// q (L,) int64 → out (R, 2, L, N) u32.
extern "C" int auto_ks_launch(const void* exts, const void* evk_a,
                              const void* evk_b, const void* perms,
                              const void* q, void* out, int J, int G, int R,
                              int L, int N, void* stream) {
  const long long total = static_cast<long long>(R) * L * N;
  if (total <= 0) return 0;
  auto_ks_kernel<<<repro::grid_for(total), repro::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(exts), static_cast<const uint32_t*>(evk_a),
      static_cast<const uint32_t*>(evk_b), static_cast<const int64_t*>(perms),
      static_cast<const int64_t*>(q), static_cast<uint32_t*>(out),
      J, G, R, L, N);
  return static_cast<int>(cudaGetLastError());
}

// x (G, L, N) u32, perms (R, N) int64 → out (R, L, N) u32.
extern "C" int automorphism_multi_launch(const void* x, const void* perms,
                                         void* out, int G, int R, int L, int N,
                                         void* stream) {
  const long long total = static_cast<long long>(R) * L * N;
  if (total <= 0) return 0;
  multi_perm_kernel<<<repro::grid_for(total), repro::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int64_t*>(perms),
      static_cast<uint32_t*>(out), G, R, L, N);
  return static_cast<int>(cudaGetLastError());
}
