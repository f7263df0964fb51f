// EFU: element-wise modular ops over RNS residues (paper §III-C compound ops).
//
// Replaces the TPU kernel src/repro/kernels/eltwise/kernel.py:eltwise_pallas
// (double-REDC Montgomery over a (P*ℓ/Lb, N/tile) grid of VMEM blocks).
//
//   mul    : a ⊙ b              add/sub : a ± b
//   mac    : a ⊙ b + c ⊙ d      muladd  : a ⊙ b + c        (all mod q_limb)
//
// Operands are (rows, N) with every leading dim flattened into rows; the limb
// of a row is row % ℓ.  One thread per output element, u64 products, exact
// `%` by the limb's prime.
//
// Bound on the H100: bytes.  Each element moves 2-4 input words and one
// output word (12-20 B) for one or two modular products, far below the
// card's ratio of operations to bytes, so the kernel is limited by the
// 3.35 TB/s of HBM.  Design response: neighbouring threads touch
// neighbouring words (fully coalesced 128 B lines), each word is read once,
// and the compound mac/muladd forms write one output instead of the two or
// three round trips a chain of separate ops would make.
#include "common.cuh"

namespace {

enum Op { kMul = 0, kAdd = 1, kSub = 2, kMac = 3, kMulAdd = 4 };

template <int OP>
__global__ void efu_kernel(const uint32_t* __restrict__ a,
                           const uint32_t* __restrict__ b,
                           const uint32_t* __restrict__ c,
                           const uint32_t* __restrict__ d,
                           uint32_t* __restrict__ out,
                           const int64_t* __restrict__ q,
                           long long total, int ell, int N) {
  long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const uint64_t p = static_cast<uint64_t>(q[(idx / N) % ell]);
  const uint64_t x = a[idx], y = b[idx];
  uint64_t r;
  if (OP == kMul) {
    r = x * y % p;
  } else if (OP == kAdd) {
    r = x + y;
    if (r >= p) r -= p;
  } else if (OP == kSub) {
    r = x + p - y;
    if (r >= p) r -= p;
  } else if (OP == kMac) {
    r = x * y % p + static_cast<uint64_t>(c[idx]) * d[idx] % p;
    if (r >= p) r -= p;
  } else {  // kMulAdd
    r = x * y % p + c[idx];
    if (r >= p) r -= p;
  }
  out[idx] = static_cast<uint32_t>(r);
}

}  // namespace

// Launch one EFU op on `stream`; returns cudaGetLastError() (0 on success).
// Unused operand pointers (c, d for the two-input ops) may be null.
extern "C" int efu_launch(int op, const void* a, const void* b, const void* c,
                          const void* d, void* out, const void* q,
                          long long total, int ell, int N, void* stream) {
  if (total <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned grid = repro::grid_for(total);
  auto A = static_cast<const uint32_t*>(a);
  auto B = static_cast<const uint32_t*>(b);
  auto C = static_cast<const uint32_t*>(c);
  auto D = static_cast<const uint32_t*>(d);
  auto O = static_cast<uint32_t*>(out);
  auto Q = static_cast<const int64_t*>(q);
  switch (op) {
    case kMul:
      efu_kernel<kMul><<<grid, repro::kThreads, 0, s>>>(A, B, C, D, O, Q, total, ell, N);
      break;
    case kAdd:
      efu_kernel<kAdd><<<grid, repro::kThreads, 0, s>>>(A, B, C, D, O, Q, total, ell, N);
      break;
    case kSub:
      efu_kernel<kSub><<<grid, repro::kThreads, 0, s>>>(A, B, C, D, O, Q, total, ell, N);
      break;
    case kMac:
      efu_kernel<kMac><<<grid, repro::kThreads, 0, s>>>(A, B, C, D, O, Q, total, ell, N);
      break;
    case kMulAdd:
      efu_kernel<kMulAdd><<<grid, repro::kThreads, 0, s>>>(A, B, C, D, O, Q, total, ell, N);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
