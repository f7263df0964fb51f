// BConvU: the (K×ℓ)·(ℓ×N) modular table product of fast base conversion.
//
// Replaces the TPU kernel src/repro/kernels/bconv/kernel.py:bconv_matmul_pallas
// (output-stationary grid (B/block_b, K, N/tile), per-term Shoup product,
// lazy hi16/lo16 column sum, one Barrett per output).
//
//   out[b, j, n] = Σ_i t[b, i, n] · T[j, i]  mod p_j
//
// t holds the source limbs already scaled by q̂_i⁻¹ (the caller does that in
// torch, as the reference's kernels/bconv/ops.py does).  HPS-style: no
// fractional correction, exactly the reference's formula.
//
// One thread per output (b, j, n), looping over the ℓ source limbs with a u64
// accumulator that is reduced every 15 raw products (common.cuh), so the sum
// is exact for any ℓ.
//
// Bound on the H100: bytes.  The function must read B·ℓ·N input words and
// write B·K·N output words; its 2·B·K·ℓ·N integer operations are far below
// what the card does in the same time.  Design response: threads of a warp
// share (b, j) and take consecutive n, so every read of t[b, i, ·] and every
// write is a coalesced line; the K threads that need the same t element hit
// it in L2 (a (ℓ, N) source block at the paper's ℓ = 12, N = 2^16 is 3 MB,
// well inside the 50 MB L2), so HBM sees each input word about once.
#include "common.cuh"

namespace {

__global__ void bconv_kernel(const uint32_t* __restrict__ t,
                             const int64_t* __restrict__ table,
                             const int64_t* __restrict__ p,
                             uint32_t* __restrict__ out,
                             int B, int ell, int K, int N) {
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(B) * K * N;
  if (idx >= total) return;
  const int n = static_cast<int>(idx % N);
  const int j = static_cast<int>((idx / N) % K);
  const long long b = idx / (static_cast<long long>(N) * K);
  const uint64_t pj = static_cast<uint64_t>(p[j]);
  const uint32_t* src = t + b * ell * N + n;
  const int64_t* row = table + static_cast<long long>(j) * ell;
  uint64_t acc = 0;
  int pending = 0;
  for (int i = 0; i < ell; ++i) {
    acc += static_cast<uint64_t>(src[static_cast<long long>(i) * N]) *
           static_cast<uint64_t>(row[i]);
    if (++pending == repro::kReduceEvery) {
      acc %= pj;
      pending = 0;
    }
  }
  out[idx] = static_cast<uint32_t>(acc % pj);
}

}  // namespace

// t: (B, ℓ, N) u32, table: (K, ℓ) int64, p: (K,) int64 → out (B, K, N) u32.
extern "C" int bconv_launch(const void* t, const void* table, const void* p,
                            void* out, int B, int ell, int K, int N,
                            void* stream) {
  const long long total = static_cast<long long>(B) * K * N;
  if (total <= 0) return 0;
  bconv_kernel<<<repro::grid_for(total), repro::kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(t), static_cast<const int64_t*>(table),
      static_cast<const int64_t*>(p), static_cast<uint32_t*>(out),
      B, ell, K, N);
  return static_cast<int>(cudaGetLastError());
}
