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
// One thread per output (r, i, k); the gather reads global memory directly
// and the 50 MB L2 carries it: the J·L·N·4 B of hoisted digits (3.6 MB per
// digit at the paper's L = 58) stay L2-resident while the R rotations'
// threads sweep them.  Bound: bytes (the digits once, both evk halves,
// 2·R·L·N words out, for 2·R·J·L·N modular products).  evk reads and all
// writes are coalesced; the u64 accumulator is reduced every 15 products
// (common.cuh), with one `%` per output at the end.
//
// automorphism_rows replaces
// src/repro/kernels/automorphism/kernel.py:automorphism_pallas:
//
//   out[b, k] = x[b, perm[k]]       (every leading dim flattened into b)
//
// grid (ceil(B / rows), ceil(N / 256)); each thread reads perm[k] once and
// gathers it for the CTA's block of ``rows`` rows (the autotuner's knob), so
// the index read is shared by the block.
//
// automorphism_multi replaces
// src/repro/kernels/automorphism/kernel.py:automorphism_multi_pallas (:118),
// and automorphism_eager replaces automorphism_pallas_eager (:54):
//
//   multi: out[r, i, k] = x[g, i, perms[r, k]],  g = 0 if G == 1 else r
//   eager: out[p, i, k] = x[p, i, perm[k]]       (multi with G = R = 1)
//
// for any index table with entries in [0, N) (not only Galois tables).  The
// TPU kernels keep a whole (limbs, N) block in VMEM and gather there.  One
// limb row at N = 2^16 is 256 KiB, more than the 227 KB a CTA can hold, but
// it fits the distributed shared memory of a thread-block cluster.  Both
// entry points launch one kernel body, perm_cluster_kernel:
//
//   - a cluster of C CTAs (C ∈ {1, 2, 4, 8}) owns one source row; CTA r
//     holds the window [base_r, base_r + S) of it in dynamic shared memory,
//     base_r = min(r·T, N - S), T a power of two with T·C ≥ N, S up to the
//     per-CTA budget (the wrapper's cluster_plan: the smallest C whose T
//     fits 224 KiB, S = min(N, 224 KiB); at N = 2^16, C = 2, T = 32768,
//     S = 57344, so the two windows overlap and 7/8 of any table's reads
//     are local);
//   - each CTA stages its window once, as TMA bulk copies completing on an
//     mbarrier where N % 4 == 0 and the pointers are 16-byte aligned (else
//     word by word), then cluster.sync();
//   - each CTA writes an equal share of the output row: for output k it
//     reads src = perm[r, k] from its own window where that holds it, else
//     word src - base_o of CTA o = src >> log2 T through
//     cluster.map_shared_rank (32-bit shift and compare, no division), four
//     consecutive k per thread as one 16-byte store;
//   - multi with G = 1 runs one cluster per limb i and loops over the R
//     rotations, so the shared operand crosses device memory once; G = R
//     runs one cluster per (r, i); eager runs one cluster per (p, i) row;
//   - a last cluster.sync() keeps every CTA resident until its neighbours
//     have finished reading its shared memory.
//
// Bound on the H100: bytes — each input word read once, each output word
// written once, the int64 index table once: (1, 46, N) → R = 2 is 37.2 MB
// (0.0111 ms at 3.35 TB/s), the eager (1, 46, N) 24.6 MB (0.0074 ms).  The
// design moves that through device memory (the overlapping windows and the
// index rows are re-read from L2); what it adds is the remote gathers on
// the SM-to-SM network, (N - S)/N of the reads (1/8 at N = 2^16), the
// staging before the first gather, and one read of the index row per
// source row.  Scattered 4-byte remote reads cost several times a local
// one, which is why the windows are as large as a CTA's shared memory
// allows rather than disjoint slices; a window that large leaves little
// L1, which is why the TMA stages it.
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

__global__ void perm_rows_kernel(const uint32_t* __restrict__ x,
                                 const int64_t* __restrict__ perm,
                                 uint32_t* __restrict__ out,
                                 long long B, int N, int rows) {
  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  if (k >= N) return;
  const long long src = perm[k];
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const long long r1 = r0 + rows < B ? r0 + rows : B;
  for (long long r = r0; r < r1; ++r) out[r * N + k] = x[r * N + src];
}

constexpr int kClusterThreads = 512;

// One cluster of C CTAs per source row c = g·L + i (see the header note):
// windows of S words at stride 2^stride_log2; chunk = the output words each
// CTA writes (a multiple of 4); vec = 16-byte staging and stores.
__global__ void __launch_bounds__(kClusterThreads)
perm_cluster_kernel(const uint32_t* __restrict__ x,
                    const int64_t* __restrict__ perms,
                    uint32_t* __restrict__ out, int G, int R, int L, int N,
                    int S, int stride_log2, int chunk, int vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = static_cast<int>(blockIdx.x) / C;
  const int g = c / L, i = c - g * L;
  const repro::ClusterRow row = repro::stage_cluster_row(
      cluster, smem, x + static_cast<long long>(c) * N, N, S, stride_log2, vec);
  const int lo = min(N, rank * chunk), hi = min(N, lo + chunk);
  const int r0 = G == 1 ? 0 : g, r1 = G == 1 ? R : g + 1;
  for (int r = r0; r < r1; ++r) {
    const int64_t* p = perms + static_cast<long long>(r) * N;
    uint32_t* o = out + (static_cast<long long>(r) * L + i) * N;
    if (vec) {
#pragma unroll 2
      for (int k = lo + 4 * static_cast<int>(threadIdx.x); k < hi;
           k += 4 * kClusterThreads) {
        const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p + k));
        const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p + k + 2));
        uint4 w;
        w.x = repro::cluster_word(cluster, row, a.x);
        w.y = repro::cluster_word(cluster, row, a.y);
        w.z = repro::cluster_word(cluster, row, b.x);
        w.w = repro::cluster_word(cluster, row, b.y);
        *reinterpret_cast<uint4*>(o + k) = w;
      }
    } else {
      for (int k = lo + static_cast<int>(threadIdx.x); k < hi; k += kClusterThreads)
        o[k] = repro::cluster_word(cluster, row, __ldg(p + k));
    }
  }
  cluster.sync();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Launch perm_cluster_kernel with clusters of C CTAs holding windows of S
// words at stride T over the G·L source rows.  Returns the CUDA error of a
// refused plan or launch; never launches anything else.
int launch_perm_cluster(const void* x, const void* perms, void* out, int G,
                        int R, int L, int N, int C, int S, int T,
                        cudaStream_t stream) {
  if (G <= 0 || R <= 0 || L <= 0 || N <= 0) return 0;
  if ((C != 1 && C != 2 && C != 4 && C != 8) || T < 4 || (T & (T - 1)) != 0 ||
      static_cast<long long>(T) * C < N || S > N || S < min(T, N) ||
      static_cast<long long>(S) * 4 > repro::kMaxSmemPerCta ||
      static_cast<long long>(G) * L * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (S + 3) / 4 * 16;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(G * L * C));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static repro::ClusterLaunchState state;
  cudaError_t err = repro::prepare_cluster_launch(perm_cluster_kernel, cfg, state, C, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk = ((N + C - 1) / C + 3) / 4 * 4;
  const int vec = N % 4 == 0 && S % 4 == 0 && aligned16(x) && aligned16(perms) &&
                  aligned16(out);
  int stride_log2 = 0;
  while ((1 << stride_log2) < T) ++stride_log2;
  err = cudaLaunchKernelEx(&cfg, perm_cluster_kernel,
                           static_cast<const uint32_t*>(x),
                           static_cast<const int64_t*>(perms),
                           static_cast<uint32_t*>(out), G, R, L, N, S,
                           stride_log2, chunk, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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

// x (G, L, N) u32, perms (R, N) int64 → out (R, L, N) u32; clusters of C
// CTAs holding windows of S words at stride T (the wrapper's cluster_plan).
extern "C" int automorphism_multi_launch(const void* x, const void* perms,
                                         void* out, int G, int R, int L, int N,
                                         int C, int S, int T, void* stream) {
  return launch_perm_cluster(x, perms, out, G, R, L, N, C, S, T,
                             static_cast<cudaStream_t>(stream));
}

// x (B, N) u32, perm (N,) int64 → out (B, N) u32; ``rows`` rows per CTA.
extern "C" int automorphism_rows_launch(const void* x, const void* perm,
                                        void* out, long long B, int N, int rows,
                                        void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((B + rows - 1) / rows),
                  static_cast<unsigned>((N + repro::kThreads - 1) / repro::kThreads));
  perm_rows_kernel<<<grid, repro::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int64_t*>(perm),
      static_cast<uint32_t*>(out), B, N, rows);
  return static_cast<int>(cudaGetLastError());
}

// x (B, N) u32, perm (N,) int64 → out (B, N) u32; one cluster per row.
extern "C" int automorphism_eager_launch(const void* x, const void* perm,
                                         void* out, long long B, int N, int C,
                                         int S, int T, void* stream) {
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return launch_perm_cluster(x, perm, out, 1, 1, static_cast<int>(B), N, C,
                             S, T, static_cast<cudaStream_t>(stream));
}
