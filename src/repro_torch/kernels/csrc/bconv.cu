// BConvU: the whole HPS fast base conversion, q̂⁻¹ pre-scale included.
//
// Replaces the TPU kernel src/repro/kernels/bconv/kernel.py:bconv_matmul_pallas
// (output-stationary grid (B/block_b, K, N/tile), per-term Shoup product,
// lazy hi16/lo16 column sum, one Barrett per output) together with the
// pre-scale its wrapper runs before it (src/repro/kernels/bconv/ops.py,
// mulmod_shoup by qhat_inv / qhat_inv_shoup):
//
//   out[b, j, n] = Σ_i [x[b, i, n] · q̂_i⁻¹]_{q_i} · T[j, i]  mod p_j
//
// x canonical residues in the ℓ source primes q_i, out canonical residues in
// the K destination primes p_j.  HPS-style: no fractional correction,
// exactly the reference's formula.
//
// Bound on the H100: bytes by the roofline — B·ℓ·N words in, B·K·N words out
// (ModDown (4, 12, N) → 46: 61 MB, 0.018 ms at 3.35 TB/s).  In practice the
// CUDA cores bind it: each output costs ℓ 64-bit multiply-adds and a
// reduction, and the kernel with its loads and stores removed takes most of
// the full kernel's time (PERF.md §6).  Design response:
//
//   - grid (N / 1024, ⌈K / chunk⌉, B), 256 threads: each thread owns four
//     consecutive coefficients n of one batch element, reads their ℓ source
//     words once as 16-byte loads (word by word where N % 4 ≠ 0), applies
//     the pre-scale as a Shoup product in registers and keeps the ℓ·4
//     scaled words there (ℓ a template parameter up to 16; any larger ℓ
//     takes a generic loop that re-reads its words, from L1/L2, for every
//     destination prime);
//   - the CTA's chunk of destination rows of the table T (u32, every entry
//     < p_j < 2³⁰), the per-source (q_i, q̂_i⁻¹, Shoup companion) and the
//     per-destination (p_j, ⌊2⁶⁴/p_j⌋) are staged once in shared memory; a
//     warp reads each entry at one address (a broadcast);
//   - per destination prime: ℓ 32×32→64-bit multiply-adds into a u64 per
//     coefficient (one IMAD.WIDE.U32 each, common.cuh's Acc64), a Barrett
//     reduction every 15 terms and one per output, no division; the four
//     outputs go out as one 16-byte store, so every row is written
//     coalesced;
//   - `chunk` (the wrapper's chunk_plan, from the SM count and
//     bconv_ctas_per_sm) splits the destination primes over the grid's y
//     axis so that a small conversion (ModUp: one batch element) still
//     fills the SMs and the grid ends on a whole wave;
//     each chunk re-reads its input from L2 and re-scales it, which costs
//     little beside the outputs it writes.
//
// No division by a runtime value anywhere: the grid is 3-D, index math is
// 32-bit within a row, and row offsets are 64-bit multiplies.
#include <utility>

#include "common.cuh"

namespace {

constexpr int kBconvThreads = 256;
constexpr int kBconvTile = 4 * kBconvThreads;   // coefficients per CTA
constexpr int kMaxTemplateEll = 16;
constexpr int kMaxChunk = 64;

// x·w mod q for any u32 x, with w < q < 2³¹ and ws = ⌊w·2³²/q⌋ (Shoup).
__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t w, uint32_t ws,
                                          uint32_t q) {
  const uint32_t r = x * w - __umulhi(x, ws) * q;
  return r >= q ? r - q : r;
}

// Shared memory of a CTA: the chunk's table rows, each padded to a multiple
// of four words (16-byte reads), then per destination mu (u64) and p, then
// per source q, w, ws.
__host__ __device__ constexpr int padded(int ell) { return (ell + 3) & ~3; }

__host__ __device__ constexpr size_t smem_bytes(int ell, int chunk) {
  return static_cast<size_t>(chunk) * (padded(ell) * 4 + 12) +
         static_cast<size_t>(ell) * 12;
}

template <int ELL>
__global__ void __launch_bounds__(kBconvThreads)
bconv_kernel(const uint32_t* __restrict__ x, const int64_t* __restrict__ q_src,
             const int64_t* __restrict__ qhat_inv,
             const uint32_t* __restrict__ qhat_inv_shoup,
             const uint32_t* __restrict__ table, const int64_t* __restrict__ q_dst,
             const uint64_t* __restrict__ mu, uint32_t* __restrict__ out,
             int ell_runtime, int K, int N, int chunk, int vec) {
  const int ell = ELL > 0 ? ELL : ell_runtime;
  const int stride = padded(ell);
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_tab = smem;
  uint64_t* s_mu = reinterpret_cast<uint64_t*>(s_tab + chunk * stride);
  uint32_t* s_p = reinterpret_cast<uint32_t*>(s_mu + chunk);
  uint32_t* s_q = s_p + chunk;
  uint32_t* s_w = s_q + ell;
  uint32_t* s_ws = s_w + ell;

  const int j0 = static_cast<int>(blockIdx.y) * chunk;
  const int kc = min(chunk, K - j0);
  for (int jj = 0; jj < kc; ++jj)
    for (int i = threadIdx.x; i < ell; i += kBconvThreads)
      s_tab[jj * stride + i] = table[static_cast<long long>(j0 + jj) * ell + i];
  for (int w = threadIdx.x; w < kc; w += kBconvThreads) {
    s_p[w] = static_cast<uint32_t>(q_dst[j0 + w]);
    s_mu[w] = mu[j0 + w];
  }
  for (int w = threadIdx.x; w < ell; w += kBconvThreads) {
    s_q[w] = static_cast<uint32_t>(q_src[w]);
    s_w[w] = static_cast<uint32_t>(qhat_inv[w]);
    s_ws[w] = qhat_inv_shoup[w];
  }
  __syncthreads();

  const int n = static_cast<int>(blockIdx.x) * kBconvTile + 4 * static_cast<int>(threadIdx.x);
  if (n >= N) return;
  const int left = N - n;
  const long long b = blockIdx.z;
  const uint32_t* xb = x + b * ell * N + n;
  uint32_t* ob = out + (b * K + j0) * N + n;

  if constexpr (ELL > 0) {
    uint32_t t[ELL][4];
#pragma unroll
    for (int i = 0; i < ELL; ++i) {
      repro::load4(t[i], xb + static_cast<long long>(i) * N, left, vec);
#pragma unroll
      for (int v = 0; v < 4; ++v) t[i][v] = shoup(t[i][v], s_w[i], s_ws[i], s_q[i]);
    }
    for (int jj = 0; jj < kc; ++jj) {
      const uint32_t* row = s_tab + jj * padded(ELL);
      const uint32_t p = s_p[jj];
      const uint64_t m = s_mu[jj];
      repro::Acc64 acc[4];
#pragma unroll
      for (int i = 0; i < ELL; ++i) {
        const uint32_t w = row[i];
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[v].mac(t[i][v], w);
        if ((i + 1) % repro::kReduceEvery == 0 && i + 1 < ELL) {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[v] = {repro::barrett(acc[v].value(), p, m), 0};
        }
      }
      uint32_t o[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) o[v] = repro::barrett(acc[v].value(), p, m);
      repro::store4(ob + static_cast<long long>(jj) * N, o, left, vec);
    }
  } else {
    for (int jj = 0; jj < kc; ++jj) {
      const uint32_t* row = s_tab + jj * stride;
      const uint32_t p = s_p[jj];
      const uint64_t m = s_mu[jj];
      repro::Acc64 acc[4];
      int pending = 0;
      for (int i = 0; i < ell; ++i) {
        uint32_t t[4];
        repro::load4(t, xb + static_cast<long long>(i) * N, left, vec);
        const uint32_t w = row[i];
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[v].mac(shoup(t[v], s_w[i], s_ws[i], s_q[i]), w);
        if (++pending == repro::kReduceEvery) {
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[v] = {repro::barrett(acc[v].value(), p, m), 0};
          pending = 0;
        }
      }
      uint32_t o[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) o[v] = repro::barrett(acc[v].value(), p, m);
      repro::store4(ob + static_cast<long long>(jj) * N, o, left, vec);
    }
  }
}

using BconvKernel = void (*)(const uint32_t*, const int64_t*, const int64_t*,
                             const uint32_t*, const uint32_t*, const int64_t*,
                             const uint64_t*, uint32_t*, int, int, int, int, int);

template <int... E>
constexpr BconvKernel pick(int ell, std::integer_sequence<int, E...>) {
  BconvKernel k = bconv_kernel<0>;
  ((k = ell == E + 1 ? bconv_kernel<E + 1> : k), ...);
  return k;
}

}  // namespace

// CTAs of the kernel for ℓ source primes that one SM of the current device
// holds at once, with the shared memory of `chunk` destination primes.
extern "C" int bconv_ctas_per_sm(int ell, int chunk, int* ctas) {
  if (ell <= 0 || chunk <= 0 || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const BconvKernel kernel =
      pick(ell, std::make_integer_sequence<int, kMaxTemplateEll>{});
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, kernel, kBconvThreads, smem_bytes(ell, chunk)));
}

// x (B, ℓ, N) u32 canonical residues in the source primes; q_src, qhat_inv
// (ℓ,) int64; qhat_inv_shoup (ℓ,) u32; table (K, ℓ) u32; q_dst (K,) int64;
// mu (K,) u64 = ⌊2⁶⁴/p_j⌋ → out (B, K, N) u32.  `chunk` destination primes
// per CTA (1..64).
extern "C" int bconv_launch(const void* x, const void* q_src, const void* qhat_inv,
                            const void* qhat_inv_shoup, const void* table,
                            const void* q_dst, const void* mu, void* out, int B,
                            int ell, int K, int N, int chunk, void* stream) {
  if (B <= 0 || K <= 0 || N <= 0) return 0;
  if (ell <= 0 || chunk <= 0 || chunk > kMaxChunk || B > 65535 ||
      smem_bytes(ell, chunk) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const BconvKernel kernel =
      pick(ell, std::make_integer_sequence<int, kMaxTemplateEll>{});
  const int vec = N % 4 == 0 && repro::aligned16(x) && repro::aligned16(out);
  const dim3 grid(static_cast<unsigned>((N + kBconvTile - 1) / kBconvTile),
                  static_cast<unsigned>((K + chunk - 1) / chunk),
                  static_cast<unsigned>(B));
  kernel<<<grid, kBconvThreads, smem_bytes(ell, chunk),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int64_t*>(q_src),
      static_cast<const int64_t*>(qhat_inv),
      static_cast<const uint32_t*>(qhat_inv_shoup),
      static_cast<const uint32_t*>(table), static_cast<const int64_t*>(q_dst),
      static_cast<const uint64_t*>(mu), static_cast<uint32_t*>(out), ell, K, N,
      chunk, vec);
  return static_cast<int>(cudaGetLastError());
}
