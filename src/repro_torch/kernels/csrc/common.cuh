// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel here reads residues as u32 (the bits PyTorch stores as int32:
// all primes are < 2^30, so residues are non-negative either way), per-limb
// primes and index tables as int64 (how repro_torch.core.const_cache stages
// them), and writes fully reduced u32 residues in [0, q).
//
// Products of two residues are < 2^60, so up to 15 of them plus a reduced
// running sum (< 2^30) fit a u64 without overflow: accumulators add raw
// products and reduce every kReduceEvery terms (Barrett, `barrett` below:
// no division).  That keeps a sum exact for any number of terms, as the
// reference's hi16/lo16 column sum is.
//
// A limb row larger than one CTA's shared memory (N = 2^16 u32 words is
// 256 KiB) is staged across a thread-block cluster: stage_cluster_row puts
// one window of it in each CTA's shared memory, cluster_word reads any word
// of it from any CTA of the cluster (distributed shared memory), and
// prepare_cluster_launch readies a kernel for such a launch.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace repro {

constexpr int kThreads = 256;
constexpr int kReduceEvery = 15;
constexpr int kMaxSmemPerCta = 227 * 1024;     // Hopper: 232,448 bytes

// A u64 sum of 32×32-bit products, kept as its two words.  acc.mac(a, b) is
// one IMAD.WIDE.U32, written as PTX's carry pair (mad.lo.cc / madc.hi): the
// C++ form `acc += uint64_t(a) * b` compiles to the same instruction plus an
// add to the high word per product, which a chain of products pays for in
// issue slots.
struct Acc64 {
  uint32_t lo = 0, hi = 0;
  __device__ __forceinline__ void mac(uint32_t a, uint32_t b) {
    asm("mad.lo.cc.u32 %0, %2, %3, %0;\n\tmadc.hi.u32 %1, %2, %3, %1;"
        : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
  }
  __device__ __forceinline__ uint64_t value() const {
    return (static_cast<uint64_t>(hi) << 32) | lo;
  }
};

// x mod p for any u64 x, with mu = ⌊2⁶⁴/p⌋ and 2 < p < 2³⁰ (staged per prime
// by const_cache.device_barrett).  The quotient estimate keeps three of the
// four partial products of x·mu/2⁶⁴ (x = xh·2³² + xl, mu = mh·2³² + ml):
// a = xh·mh + ⌊xh·ml/2³²⌋ + ⌊xl·mh/2³²⌋ falls short of ⌊x/p⌋ by at most 3
// (the dropped fractions sum to < 2, Barrett's own estimate to < 1), so
// x − a·p lies in [0, 4p) and its low word is exact; two unsigned-min steps
// finish.  Four 32-bit multiplies, no division.
__device__ __forceinline__ uint32_t barrett(uint64_t x, uint32_t p, uint64_t mu) {
  const uint32_t xh = static_cast<uint32_t>(x >> 32), xl = static_cast<uint32_t>(x);
  const uint32_t mh = static_cast<uint32_t>(mu >> 32), ml = static_cast<uint32_t>(mu);
  const uint32_t a = xh * mh + __umulhi(xh, ml) + __umulhi(xl, mh);
  uint32_t r = xl - a * p;
  r = min(r, r - 2 * p);
  return min(r, r - p);
}

// The four consecutive words p[0..3] as one 16-byte access when `vec` (p
// 16-byte aligned), else word by word with the words from `left` on masked
// (left ≥ 1).  kStream loads bypass L1 and go first out of L2 (read once).
template <bool kStream = false>
__device__ __forceinline__ void load4(uint32_t (&w)[4], const uint32_t* __restrict__ p,
                                      int left, bool vec) {
  if (vec) {
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
    const uint4 v = kStream ? __ldcs(p4) : __ldg(p4);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    return;
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) w[v] = v < left ? (kStream ? __ldcs(p + v) : __ldg(p + v)) : 0u;
}

__device__ __forceinline__ void store4(uint32_t* __restrict__ p, const uint32_t (&w)[4],
                                       int left, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int v = 0; v < 4; ++v)
    if (v < left) p[v] = w[v];
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A row of N u32 words staged across a cluster of C CTAs, one window of it
// in each CTA's shared memory: CTA r holds words [base_r, base_r + S) with
// base_r = min(r·T, N - S), T = 2^stride_log2, T·C ≥ N and S ≥ min(T, N).
// Window r then covers [r·T, (r+1)·T) ∩ [0, N), so word w lies in the window
// of CTA w >> stride_log2; with S larger than T the windows overlap, and a
// CTA finds most words in its own.
struct ClusterRow {
  uint32_t* smem;
  int N, S, stride_log2, base;   // base: this CTA's window start
};

// Stage this CTA's window of `src`, then sync the cluster, after which any
// CTA may read any word through cluster_word.  When `vec` (N and S multiples
// of 4, `src` 16-byte aligned) one thread hands the window to the TMA in
// kBulkBytes pieces that complete on an mbarrier: the copy takes no
// registers and no L1, which a 224 KiB window leaves little of.  Otherwise
// the threads copy it word by word.
constexpr int kBulkBytes = 16 * 1024;

__device__ __forceinline__ ClusterRow stage_cluster_row(cg::cluster_group& cluster,
                                                        uint32_t* smem,
                                                        const uint32_t* __restrict__ src,
                                                        int N, int S,
                                                        int stride_log2, int vec) {
  __shared__ uint64_t staged;                    // the window's mbarrier
  const int base =
      min(static_cast<int>(cluster.block_rank()) << stride_log2, N - S);
  src += base;
  if (vec) {
    const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(&staged));
    if (threadIdx.x == 0) {
      const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
      const int bytes = S * 4;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"(bytes) : "memory");
      for (int off = 0; off < bytes; off += kBulkBytes)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];"
            :: "r"(dst + off), "l"(reinterpret_cast<const char*>(src) + off),
               "r"(min(kBulkBytes, bytes - off)), "r"(bar) : "memory");
    }
    __syncthreads();                             // the mbarrier is initialised
    uint32_t done = 0;
    while (!done)
      asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;"
                   " selp.u32 %0, 1, 0, p; }"
                   : "=r"(done) : "r"(bar) : "memory");
  } else {
    for (int v = threadIdx.x; v < S; v += blockDim.x) smem[v] = __ldg(src + v);
  }
  cluster.sync();
  return {smem, N, S, stride_log2, base};
}

// Word `src` of the staged row: from this CTA's own window where it holds
// it, else through distributed shared memory from CTA src >> stride_log2.
__device__ __forceinline__ uint32_t cluster_word(cg::cluster_group& cluster,
                                                 const ClusterRow& row,
                                                 long long src) {
  const uint32_t w = static_cast<uint32_t>(src);
  const uint32_t local = w - static_cast<uint32_t>(row.base);
  if (local < static_cast<uint32_t>(row.S)) return row.smem[local];
  const int owner = static_cast<int>(w >> row.stride_log2);
  const int base = min(owner << row.stride_log2, row.N - row.S);
  return *cluster.map_shared_rank(row.smem + (w - base), owner);
}

// What a kernel's cluster launches have set up so far, per device (both the
// function attribute and the occupancy answer hold for the device that was
// current when they were made): its dynamic shared-memory limit, and per
// cluster size the largest shared memory per CTA at which a cluster was found
// to fit on the card.
constexpr int kMaxDevices = 64;

struct ClusterLaunchState {
  struct OnDevice {
    int smem_allowed = 48 * 1024;
    int resident_smem[9] = {};
  };
  OnDevice device[kMaxDevices];
};

// Ready `kernel` for the launch `cfg` (clusters of C CTAs, `smem` dynamic
// bytes each) on the current device: raise its shared-memory limit there
// where needed and check, once per (device, C, smem), that at least one such
// cluster can be resident.  The state changes only outside stream capture in
// practice: the first launch of a plan is an ordinary one.  Returns the CUDA
// error, cudaErrorInvalidConfiguration when no cluster fits.
template <typename Kernel>
cudaError_t prepare_cluster_launch(Kernel kernel, const cudaLaunchConfig_t& cfg,
                                   ClusterLaunchState& state, int C, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  ClusterLaunchState::OnDevice& on = state.device[dev];
  if (smem > on.smem_allowed) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    on.smem_allowed = smem;
  }
  if (smem > on.resident_smem[C]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    on.resident_smem[C] = smem;
  }
  return cudaSuccess;
}

}  // namespace repro

// Human-readable text for the cudaError_t a launcher returned.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
