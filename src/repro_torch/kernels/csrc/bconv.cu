// BConvU: the whole HPS fast base conversion, q̂⁻¹ pre-scale included, over
// G groups of destination primes in one launch.
//
// Replaces the TPU kernel src/repro/kernels/bconv/kernel.py:bconv_matmul_pallas
// (output-stationary grid (B/block_b, K, N/tile), per-term Shoup product,
// lazy hi16/lo16 column sum, one Barrett per output) together with the
// pre-scale its wrapper runs before it (src/repro/kernels/bconv/ops.py,
// mulmod_shoup by qhat_inv / qhat_inv_shoup):
//
//   out[g, b, j, n] = Σ_i [x[g, b, i, n] · q̂_i⁻¹]_{q_i} · T[g·Kg + j, i]  mod p_{g·Kg + j}
//
// x canonical residues in the ℓ source primes q_i, out canonical residues in
// the destination primes p.  HPS-style: no fractional correction, exactly
// the reference's formula.  G = 1 is a single-device BConv (ModUp, ModDown,
// a batch of them); G > 1 is limb duplication on the distributed engine's
// mesh, group g the limb cluster that owns destination rows g·Kg … (g+1)·Kg − 1
// (src/repro/core/distributed.py:722-730 slices the table the same way by
// axis_index("limb")).  x is read through its strides: a replicated operand
// has group stride 0, so its words are read from L2 by every group's CTAs and
// never copied.
//
// Bound on the H100: bytes by the roofline — G·Bg·ℓ·n words in, G·Bg·Kg·n
// out (ModDown (4, 12, N) → 46: 61 MB, 0.018 ms at 3.35 TB/s).  In practice
// the CUDA cores bind it: each output costs ℓ 64-bit multiply-adds and a
// reduction (PERF.md §6).  Design response:
//
//   - grid (⌈n / tile⌉, ⌈Kg / chunk⌉, G·Bg), 256 threads: each thread owns V
//     consecutive coefficients of one batch row, reads their ℓ source words
//     once (V-word loads where the strides allow, word by word otherwise),
//     applies the pre-scale as a Shoup product in registers and keeps the
//     ℓ·V scaled words there for every destination prime of its CTA.
//     V = 4 up to ℓ = 16, 2 up to 32, 1 up to 64, so the held words stay at
//     most 64 registers; tile = 256·V coefficients.  ℓ ≤ 16 has one
//     instantiation per ℓ; above, ℓ is rounded up to a multiple of 4 and
//     the missing words are zeros (their constants and table entries too),
//     which add nothing to a sum; above ℓ = 32 the kernel declares one CTA
//     an SM enough (bconv_kernel_wide), so ptxas may spend more registers;
//   - the CTA's chunk of destination rows of the table T (u32, every entry
//     < p_j < 2³⁰), the per-source (q_i, q̂_i⁻¹, Shoup companion) and the
//     per-destination (p_j, ⌊2⁶⁴/p_j⌋) are staged once in shared memory; a
//     warp reads each entry at one address (a broadcast);
//   - per destination prime: ℓ 32×32→64-bit multiply-adds into a u64 per
//     coefficient (one IMAD.WIDE.U32 each, common.cuh's Acc64), a Barrett
//     reduction every 15 terms and one per output, no division; the V
//     outputs go out as one store, so every row is written coalesced;
//   - `chunk` (the wrapper's chunk_plan, from the SM count and
//     bconv_ctas_per_sm) splits a group's destination primes over the grid's
//     y axis so that a small conversion (ModUp: one batch row) still fills
//     the SMs and the grid ends on a whole wave; each chunk re-reads its
//     input from L2 and re-scales it, which costs little beside the outputs
//     it writes.
//
// One division per CTA (its group and batch row from blockIdx.z), none per
// word; index math is 32-bit within a row and row offsets are 64-bit.
#include <utility>

#include "common.cuh"

namespace {

constexpr int kBconvThreads = 256;
constexpr int kMaxExactEll = 16;   // one instantiation per ℓ up to here
constexpr int kMaxEll = 64;
constexpr int kMaxChunk = 64;

// Coefficients a thread owns for ℓ source primes: ℓ·V held words ≤ 64.
__host__ __device__ constexpr int vec_of(int ell) {
  return ell <= 16 ? 4 : ell <= 32 ? 2 : 1;
}

// The instantiation that serves ℓ: ℓ itself up to 16, else ℓ rounded up to
// a multiple of 4.
__host__ __device__ constexpr int ell_of(int ell) {
  return ell <= kMaxExactEll ? ell : (ell + 3) & ~3;
}

// x·w mod q for any u32 x, with w < q < 2³¹ and ws = ⌊w·2³²/q⌋ (Shoup); 0
// for the zero padding (w = ws = q = 0).
__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t w, uint32_t ws,
                                          uint32_t q) {
  const uint32_t r = x * w - __umulhi(x, ws) * q;
  return r >= q ? r - q : r;
}

// V consecutive words p[0..V-1] as one access when `vec` (p aligned to 4·V
// bytes), else word by word with the words from `left` on zero (left ≥ 1).
template <int V>
__device__ __forceinline__ void load_words(uint32_t (&w)[V], const uint32_t* __restrict__ p,
                                           int left, bool vec) {
  if constexpr (V == 4) {
    repro::load4(w, p, left, vec);
  } else if constexpr (V == 2) {
    if (vec) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x, w[1] = v.y;
    } else {
      w[0] = __ldg(p);
      w[1] = left > 1 ? __ldg(p + 1) : 0u;
    }
  } else {
    w[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ p, const uint32_t (&w)[V],
                                            int left, bool vec) {
  if constexpr (V == 4) {
    repro::store4(p, w, left, vec);
  } else if constexpr (V == 2) {
    if (vec) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      p[0] = w[0];
      if (left > 1) p[1] = w[1];
    }
  } else {
    p[0] = w[0];
  }
}

// Shared memory of a CTA for ℓ source primes: the chunk's table rows, each
// padded to the instantiation's ℓ rounded up to four words (16-byte reads),
// then per destination mu (u64) and p, then per source q, w, ws (padded).
__host__ __device__ constexpr int row_words(int ell) { return (ell_of(ell) + 3) & ~3; }

__host__ __device__ constexpr size_t smem_bytes(int ell, int chunk) {
  return static_cast<size_t>(chunk) * (row_words(ell) * 4 + 12) +
         static_cast<size_t>(ell_of(ell)) * 12;
}
static_assert(smem_bytes(kMaxEll, kMaxChunk) <= 48 * 1024,
              "the widest CTA must fit the default shared-memory limit");

template <int ELL>
__device__ __forceinline__ void bconv_body(
    const uint32_t* __restrict__ x, const int64_t* __restrict__ q_src,
    const int64_t* __restrict__ qhat_inv, const uint32_t* __restrict__ qhat_inv_shoup,
    const uint32_t* __restrict__ table, const int64_t* __restrict__ q_dst,
    const uint64_t* __restrict__ mu, uint32_t* __restrict__ out, int ell_runtime,
    int Bg, int Kg, int n, int chunk, long long sg, long long sb, long long si,
    int vec) {
  constexpr int V = vec_of(ELL);
  constexpr int kTile = V * kBconvThreads;
  constexpr int kStride = (ELL + 3) & ~3;
  // exact instantiations know ℓ; padded ones hold ℓ in (ELL − 4, ELL]
  const int ell = ELL <= kMaxExactEll ? ELL : ell_runtime;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_tab = smem;
  uint64_t* s_mu = reinterpret_cast<uint64_t*>(s_tab + chunk * kStride);
  uint32_t* s_p = reinterpret_cast<uint32_t*>(s_mu + chunk);
  uint32_t* s_q = s_p + chunk;
  uint32_t* s_w = s_q + ELL;
  uint32_t* s_ws = s_w + ELL;

  const int z = static_cast<int>(blockIdx.z);
  const int g = z / Bg;
  const int b = z - g * Bg;
  const int j0 = static_cast<int>(blockIdx.y) * chunk;
  const int kc = min(chunk, Kg - j0);
  const long long row0 = static_cast<long long>(g) * Kg + j0;   // in the table
  for (int w = threadIdx.x; w < kc * kStride; w += kBconvThreads) {
    const int jj = w / kStride, i = w - jj * kStride;
    s_tab[w] = i < ell ? table[(row0 + jj) * ell + i] : 0u;
  }
  for (int w = threadIdx.x; w < kc; w += kBconvThreads) {
    s_p[w] = static_cast<uint32_t>(q_dst[row0 + w]);
    s_mu[w] = mu[row0 + w];
  }
  for (int w = threadIdx.x; w < ELL; w += kBconvThreads) {
    const bool real = w < ell;
    s_q[w] = real ? static_cast<uint32_t>(q_src[w]) : 0u;
    s_w[w] = real ? static_cast<uint32_t>(qhat_inv[w]) : 0u;
    s_ws[w] = real ? qhat_inv_shoup[w] : 0u;
  }
  __syncthreads();

  const int n0 = static_cast<int>(blockIdx.x) * kTile + V * static_cast<int>(threadIdx.x);
  if (n0 >= n) return;
  const int left = n - n0;
  const uint32_t* xb = x + g * sg + b * sb + n0;
  uint32_t* ob = out + (static_cast<long long>(z) * Kg + j0) * n + n0;

  uint32_t t[ELL][V];
#pragma unroll
  for (int i = 0; i < ELL; ++i) {
    if (i < ELL - 3 || i < ell) {
      load_words<V>(t[i], xb + i * si, left, vec);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) t[i][v] = 0u;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) t[i][v] = shoup(t[i][v], s_w[i], s_ws[i], s_q[i]);
  }
  for (int jj = 0; jj < kc; ++jj) {
    const uint32_t* row = s_tab + jj * kStride;
    const uint32_t p = s_p[jj];
    const uint64_t m = s_mu[jj];
    repro::Acc64 acc[V];
#pragma unroll
    for (int i = 0; i < ELL; ++i) {
      const uint32_t w = row[i];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v].mac(t[i][v], w);
      if ((i + 1) % repro::kReduceEvery == 0 && i + 1 < ELL) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = {repro::barrett(acc[v].value(), p, m), 0};
      }
    }
    uint32_t o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = repro::barrett(acc[v].value(), p, m);
    store_words<V>(ob + static_cast<long long>(jj) * n, o, left, vec);
  }
}

#define BCONV_PARAMS                                                              \
  const uint32_t *__restrict__ x, const int64_t *__restrict__ q_src,              \
      const int64_t *__restrict__ qhat_inv,                                       \
      const uint32_t *__restrict__ qhat_inv_shoup,                                \
      const uint32_t *__restrict__ table, const int64_t *__restrict__ q_dst,      \
      const uint64_t *__restrict__ mu, uint32_t *__restrict__ out, int ell, int Bg, \
      int Kg, int n, int chunk, long long sg, long long sb, long long si, int vec
#define BCONV_ARGS \
  x, q_src, qhat_inv, qhat_inv_shoup, table, q_dst, mu, out, ell, Bg, Kg, n, chunk, sg, sb, si, vec

// Up to ℓ = 32 ptxas's own register budget.  Above, one CTA an SM is declared
// enough (minBlocks 1): ptxas then spends more registers on the 33–64 held
// words' loads and table reads in flight, and ARK's ℓ = 48 runs faster than
// at its own budget; at ℓ ≤ 32 the same declaration makes the held words
// cost far more registers and runs slower (PERF.md §6).
constexpr int kMaxNarrowEll = 32;

template <int ELL>
__global__ void __launch_bounds__(kBconvThreads) bconv_kernel(BCONV_PARAMS) {
  bconv_body<ELL>(BCONV_ARGS);
}

template <int ELL>
__global__ void __launch_bounds__(kBconvThreads, 1) bconv_kernel_wide(BCONV_PARAMS) {
  bconv_body<ELL>(BCONV_ARGS);
}
#undef BCONV_PARAMS
#undef BCONV_ARGS

using BconvKernel = void (*)(const uint32_t*, const int64_t*, const int64_t*,
                             const uint32_t*, const uint32_t*, const int64_t*,
                             const uint64_t*, uint32_t*, int, int, int, int, int,
                             long long, long long, long long, int);

template <int ELL>
BconvKernel instance() {
  if constexpr (ELL > kMaxNarrowEll)
    return bconv_kernel_wide<ELL>;
  else
    return bconv_kernel<ELL>;
}

// The instantiation for ℓ (1 … 64), at ell_of(ℓ).
template <int... E>
BconvKernel pick(int ell, std::integer_sequence<int, E...>) {
  BconvKernel k = nullptr;
  ((k = ell_of(ell) == ell_of(E + 1) ? instance<ell_of(E + 1)>() : k), ...);
  return k;
}

BconvKernel kernel_for(int ell) {
  return pick(ell, std::make_integer_sequence<int, kMaxEll>{});
}

}  // namespace

// CTAs of the kernel for ℓ source primes that one SM of the current device
// holds at once, with the shared memory of `chunk` destination primes.
extern "C" int bconv_ctas_per_sm(int ell, int chunk, int* ctas) {
  if (ell <= 0 || ell > kMaxEll || chunk <= 0 || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, kernel_for(ell), kBconvThreads, smem_bytes(ell, chunk)));
}

// x: G × Bg batch rows of ℓ u32 canonical residues in the source primes,
// row (g, b) limb i at x + g·sg + b·sb + i·si (strides in words, each row's
// n words contiguous); q_src, qhat_inv (ℓ,) int64; qhat_inv_shoup (ℓ,) u32;
// table (G·Kg, ℓ) u32; q_dst (G·Kg,) int64; mu (G·Kg,) u64 = ⌊2⁶⁴/p⌋ →
// out (G, Bg, Kg, n) u32, contiguous.  `chunk` destination primes per CTA
// (1..64); 1 ≤ ℓ ≤ 64.
extern "C" int bconv_launch(const void* x, const void* q_src, const void* qhat_inv,
                            const void* qhat_inv_shoup, const void* table,
                            const void* q_dst, const void* mu, void* out, int G,
                            int Bg, int ell, int Kg, int n, int chunk, long long sg,
                            long long sb, long long si, void* stream) {
  if (G <= 0 || Bg <= 0 || Kg <= 0 || n <= 0) return 0;
  if (ell <= 0 || ell > kMaxEll || chunk <= 0 || chunk > kMaxChunk ||
      static_cast<long long>(G) * Bg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int V = vec_of(ell);
  const long long words = V;
  const int vec = V == 1 || (n % V == 0 && sg % words == 0 && sb % words == 0 &&
                             si % words == 0 &&
                             reinterpret_cast<uintptr_t>(x) % (4 * V) == 0 &&
                             reinterpret_cast<uintptr_t>(out) % (4 * V) == 0);
  const int tile = V * kBconvThreads;
  const dim3 grid(static_cast<unsigned>((n + tile - 1) / tile),
                  static_cast<unsigned>((Kg + chunk - 1) / chunk),
                  static_cast<unsigned>(G * Bg));
  kernel_for(ell)<<<grid, kBconvThreads, smem_bytes(ell, chunk),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int64_t*>(q_src),
      static_cast<const int64_t*>(qhat_inv),
      static_cast<const uint32_t*>(qhat_inv_shoup),
      static_cast<const uint32_t*>(table), static_cast<const int64_t*>(q_dst),
      static_cast<const uint64_t*>(mu), static_cast<uint32_t*>(out), ell, Bg, Kg, n,
      chunk, sg, sb, si, vec);
  return static_cast<int>(cudaGetLastError());
}
