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
// Bound on the H100: bytes — the digits once (J·G·L·N words), both evk
// halves (2·R·J·L·N), 2·R·L·N words out: (4, 1, 58, N) × 2 rotations is
// 365 MB, 0.109 ms at 3.35 TB/s, two thirds of it the evk halves.  The
// hoisted digits alone are 61 MB at L = 58, more than the 50 MB L2, so a
// rotation-major order reads them from device memory once per rotation.
// Design response:
//
//   - limb-major: grid (N / 1024, L), 256 threads; each thread owns four
//     consecutive k of limb i and runs every rotation, so all rotations of
//     limb i run while its J digit rows (J·N words, 1 MB at N = 2^16, J = 4)
//     are in L2, and the digits cross device memory once; the rotations go
//     two at a time inside the loop over the digits, so a pair gathers from
//     one digit row together;
//   - the Galois map is computed in registers: perm_r[k] = (g_r·k + (g_r −
//     1)/2) mod N for a power-of-two N, in 32-bit arithmetic from the two
//     per-rotation words (g_r mod N, (g_r − 1)/2 mod N) — no index table;
//   - evk_a / evk_b are read as 16-byte streaming loads (read once, first out
//     of L2) and the outputs written as 16-byte stores;
//   - u64 accumulators (one IMAD.WIDE.U32 a product, common.cuh's Acc64),
//     a Barrett reduction every 15 digits and one per output, with per-limb
//     constants: no division.
//
// What remains is the gather: each 4-byte word of a digit costs a 32-byte
// L2 sector, and a warp's words lie g apart (5 and 625 for rotations 1 and
// 4), so L2 carries several times the digits' bytes.
// automorphism_rows replaces
// src/repro/kernels/automorphism/kernel.py:automorphism_pallas:
//
//   out[b, k] = x[b, perm[k]]       (every leading dim flattened into b)
//
// grid (ceil(B / rows), ceil(N / 256)); each thread reads perm[k] once and
// gathers it for the CTA's block of ``rows`` rows (the autotuner's knob), so
// the index read is shared by the block.  The same kernel is the AutoU
// gather of the distributed engine's slot-parallel automorphism
// (automorphism_blocks, src/repro/core/distributed.py:780-788): the rows
// there are the blocks of a (limb, coef) mesh, each all-gathered to the
// n_in = N words of its row, and block j of each limb cluster writes its
// n_out = N/cs outputs out[b, p] = x[b, perm[j*n_out + p]], j the group of
// group_rows consecutive rows that b lies in, modulo the groups.  The plain
// permutation is the case n_in = n_out = N, one group.
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

constexpr int kAutoKsThreads = 256;

// One thread per four consecutive k of limb blockIdx.y (see the header
// note); galois (R, 2): g_r mod N and (g_r − 1)/2 mod N; N a power of two.
// The rotations go two at a time, inside the loop over the digits, so both
// of a pair gather from digit row j while it is hot and a thread keeps eight
// gathers and four 16-byte evk loads in flight per digit.  One CTA per SM
// is the stated minimum: without it ptxas caps the registers to fit three
// and spills, which is slower than two CTAs with every value in registers.
__global__ void __launch_bounds__(kAutoKsThreads, 1)
auto_ks_kernel(const uint32_t* __restrict__ exts, const uint32_t* __restrict__ evk_a,
               const uint32_t* __restrict__ evk_b, const uint32_t* __restrict__ galois,
               const int64_t* __restrict__ q, const uint64_t* __restrict__ mu,
               uint32_t* __restrict__ out, int J, int G, int R, int L, int N, int vec) {
  const int i = blockIdx.y;
  const int k = (static_cast<int>(blockIdx.x) * kAutoKsThreads + static_cast<int>(threadIdx.x)) * 4;
  if (k >= N) return;
  const int left = N - k;
  const uint32_t mask = static_cast<uint32_t>(N) - 1;
  const uint32_t qi = static_cast<uint32_t>(q[i]);
  const uint64_t mi = mu[i];
  const long long LN = static_cast<long long>(L) * N;
  for (int r0 = 0; r0 < R; r0 += 2) {
    const int pair = min(2, R - r0);
    uint32_t src[2][4];
    const uint32_t* e[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + min(h, pair - 1);
      const uint32_t g = galois[2 * r], c = galois[2 * r + 1];
#pragma unroll
      for (int v = 0; v < 4; ++v) src[h][v] = (g * static_cast<uint32_t>(k + v) + c) & mask;
      e[h] = exts + (G == 1 ? 0 : r) * LN + static_cast<long long>(i) * N;
    }
    repro::Acc64 acc_a[2][4], acc_b[2][4];
    int pending = 0;
#pragma unroll 2
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h >= pair) break;
        const uint32_t* ej = e[h] + j * G * LN;
        const long long koff = (static_cast<long long>(r0 + h) * J + j) * LN +
                               static_cast<long long>(i) * N + k;
        uint32_t a[4], b[4];
        repro::load4<true>(a, evk_a + koff, left, vec);
        repro::load4<true>(b, evk_b + koff, left, vec);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const uint32_t w = __ldg(ej + src[h][v]);
          acc_a[h][v].mac(w, a[v]);
          acc_b[h][v].mac(w, b[v]);
        }
      }
      if (++pending == repro::kReduceEvery) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            acc_a[h][v] = {repro::barrett(acc_a[h][v].value(), qi, mi), 0};
            acc_b[h][v] = {repro::barrett(acc_b[h][v].value(), qi, mi), 0};
          }
        pending = 0;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h >= pair) break;
      uint32_t oa[4], ob[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        oa[v] = repro::barrett(acc_a[h][v].value(), qi, mi);
        ob[v] = repro::barrett(acc_b[h][v].value(), qi, mi);
      }
      uint32_t* o = out + 2 * (r0 + h) * LN + static_cast<long long>(i) * N + k;
      repro::store4(o, oa, left, vec);
      repro::store4(o + LN, ob, left, vec);
    }
  }
}

// The rows of a CTA lie in one group: rows divides group_rows.
__global__ void perm_rows_kernel(const uint32_t* __restrict__ x,
                                 const int64_t* __restrict__ perm,
                                 uint32_t* __restrict__ out,
                                 long long B, int n_in, int n_out, int rows,
                                 long long group_rows, int groups) {
  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  if (k >= n_out) return;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows;
  const long long src =
      perm[static_cast<long long>((r0 / group_rows) % groups) * n_out + k];
  const long long r1 = r0 + rows < B ? r0 + rows : B;
  for (long long r = r0; r < r1; ++r) out[r * n_out + k] = x[r * n_in + src];
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
  const int vec = N % 4 == 0 && S % 4 == 0 && repro::aligned16(x) && repro::aligned16(perms) &&
                  repro::aligned16(out);
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

// exts (J, G, L, N) u32, evk_a/evk_b (R, J, L, N) u32, galois (R, 2) u32
// (g_r mod N, (g_r − 1)/2 mod N), q (L,) int64, mu (L,) u64 = ⌊2⁶⁴/q_i⌋ →
// out (R, 2, L, N) u32.  N a power of two ≥ 4.
extern "C" int auto_ks_launch(const void* exts, const void* evk_a,
                              const void* evk_b, const void* galois,
                              const void* q, const void* mu, void* out, int J,
                              int G, int R, int L, int N, void* stream) {
  if (J <= 0 || R <= 0 || L <= 0) return 0;
  if (N < 4 || (N & (N - 1)) != 0 || (G != 1 && G != R) || L > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = repro::aligned16(exts) && repro::aligned16(evk_a) &&
                  repro::aligned16(evk_b) && repro::aligned16(out);
  const dim3 grid(static_cast<unsigned>((N / 4 + kAutoKsThreads - 1) / kAutoKsThreads),
                  static_cast<unsigned>(L));
  auto_ks_kernel<<<grid, kAutoKsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(exts), static_cast<const uint32_t*>(evk_a),
      static_cast<const uint32_t*>(evk_b), static_cast<const uint32_t*>(galois),
      static_cast<const int64_t*>(q), static_cast<const uint64_t*>(mu),
      static_cast<uint32_t*>(out), J, G, R, L, N, vec);
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
      static_cast<uint32_t*>(out), B, N, N, rows, B, 1);
  return static_cast<int>(cudaGetLastError());
}

// x (B, n_in) u32, perm (groups * n_out,) int64 → out (B, n_out) u32 with
// out[b, p] = x[b, perm[((b / group_rows) % groups) * n_out + p]]; ``rows``
// rows per CTA, a divisor of group_rows, and B a multiple of group_rows.
extern "C" int automorphism_blocks_launch(const void* x, const void* perm,
                                          void* out, long long B, int n_in,
                                          int n_out, int rows,
                                          long long group_rows, int groups,
                                          void* stream) {
  if (B <= 0 || n_out <= 0) return 0;
  if (rows <= 0 || group_rows <= 0 || groups <= 0 || group_rows % rows ||
      B % group_rows || n_in <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(B / rows),
                  static_cast<unsigned>((n_out + repro::kThreads - 1) / repro::kThreads));
  perm_rows_kernel<<<grid, repro::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int64_t*>(perm),
      static_cast<uint32_t*>(out), B, n_in, n_out, rows, group_rows, groups);
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
