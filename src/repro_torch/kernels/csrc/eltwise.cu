// EFU: element-wise modular ops over RNS residues (paper §III-C compound ops).
//
// Replaces the TPU kernel src/repro/kernels/eltwise/kernel.py:eltwise_pallas
// (double-REDC Montgomery over a (P*ℓ/Lb, N/tile) grid of VMEM blocks), and
// takes on the ring ops the reference computes in jnp on the same path:
//
//   mul   : a ⊙ b              add/sub  : a ± b             neg : −a
//   mac   : a ⊙ b + c ⊙ d      muladd   : a ⊙ b + c
//   scale : a · w_i            subscale : (a − b) · w_i     (all mod q_i)
//
// with i the limb of the row and w an (ℓ,) column of per-limb scalars.
//
// Layout.  Each operand and the output is (outer, ℓ, N) u32 words: the last
// dim contiguous, the rows of one outer element N words apart, the outer
// elements `stride` words apart (0 repeats one element).  So views such as
// x[..., :ℓ', :] or k[:, 0] are read in place, with no copy pass.
//
// Grid (⌈N / (4·kThreads)⌉, rows), rows = outer·ℓ: a CTA covers 4·kThreads
// words of one row, so its limb (row % ℓ, in 32 bits, once per CTA) and the
// limb's constants sit in registers: q, ⌊2⁶⁴/q⌋ and, for the scalar ops,
// w_i and its Shoup companion w′_i = ⌊w_i·2³²/q_i⌋.  Each thread moves four
// consecutive words of each operand by one 16-byte load or store.
//
// Reductions.  A product (or mac's sum of two, < 2⁶¹) by the division-free
// Barrett of common.cuh; a scalar product by Shoup (one mulhi, two mullo);
// sums and differences by one unsigned-min step.  No division or `%` is left.
// Every op ends in the canonical residue in [0, q), so the bytes equal the
// reference's whatever the internal reduction.
//
// Bound on the H100: bytes.  An element moves 8-20 bytes for at most two
// modular products, far below the card's ratio of operations to bytes, so
// the kernel is limited by the 3.35 TB/s of HBM.  Design response: 16-byte
// accesses on neighbouring addresses, each word moved once, strided views
// read where they lie, and compound ops (mac, muladd, subscale) in one pass
// where a chain of single ops would make two or three round trips.
#include "common.cuh"

namespace {

enum Op { kMul = 0, kAdd = 1, kSub = 2, kMac = 3, kMulAdd = 4, kNeg = 5,
          kScale = 6, kSubScale = 7 };

constexpr int kWordsPerCta = 4 * repro::kThreads;
constexpr unsigned kMaxGridY = 65535;

struct EfuArgs {
  const uint32_t* in[4];     // operands (unused ones null)
  long long in_stride[4];    // outer strides in words
  uint32_t* out;
  long long out_stride;
  const int64_t* q;          // (ℓ,) primes
  const int64_t* mu;         // (ℓ,) ⌊2⁶⁴/q⌋
  const uint32_t* w;         // (2, ℓ): scalars, then their Shoup companions
  int rows, ell, N;
};

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t s = a + b;                      // < 2p < 2³¹
  return min(s, s - p);
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
  const uint32_t d = a + p - b;                  // in (0, 2p)
  return min(d, d - p);
}

// x·w mod p for any u32 x and w < p: x·w − ⌊x·w′/2³²⌋·p lies in [0, 2p).
__device__ __forceinline__ uint32_t shoup_mod(uint32_t x, uint32_t w, uint32_t ws,
                                              uint32_t p) {
  const uint32_t r = x * w - __umulhi(x, ws) * p;
  return min(r, r - p);
}

// Operands an op reads.
__host__ __device__ constexpr int arity(int op) {
  return op == kMac ? 4 : op == kMulAdd ? 3 : (op == kNeg || op == kScale) ? 1 : 2;
}

template <int OP>
__global__ void __launch_bounds__(repro::kThreads) efu_kernel(const EfuArgs args) {
  const int k = (static_cast<int>(blockIdx.x) * repro::kThreads + threadIdx.x) * 4;
  if (k >= args.N) return;
  for (int row = blockIdx.y; row < args.rows; row += gridDim.y) {
    const int outer = row / args.ell;
    const int limb = row - outer * args.ell;
    const uint32_t p = static_cast<uint32_t>(args.q[limb]);
    const uint64_t mu = static_cast<uint64_t>(args.mu[limb]);
    const long long col = static_cast<long long>(limb) * args.N + k;
    uint32_t x[arity(OP)][4];
#pragma unroll
    for (int i = 0; i < arity(OP); ++i)
      repro::load4<true>(x[i], args.in[i] + outer * args.in_stride[i] + col, 4, true);
    uint32_t w = 0, ws = 0;
    if constexpr (OP == kScale || OP == kSubScale) {
      w = args.w[limb];
      ws = args.w[args.ell + limb];
    }
    uint32_t r[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if constexpr (OP == kMul) {
        r[v] = repro::barrett(static_cast<uint64_t>(x[0][v]) * x[1][v], p, mu);
      } else if constexpr (OP == kAdd) {
        r[v] = add_mod(x[0][v], x[1][v], p);
      } else if constexpr (OP == kSub) {
        r[v] = sub_mod(x[0][v], x[1][v], p);
      } else if constexpr (OP == kMac) {
        r[v] = repro::barrett(static_cast<uint64_t>(x[0][v]) * x[1][v] +
                              static_cast<uint64_t>(x[2][v]) * x[3][v], p, mu);
      } else if constexpr (OP == kMulAdd) {
        r[v] = repro::barrett(static_cast<uint64_t>(x[0][v]) * x[1][v] + x[2][v], p, mu);
      } else if constexpr (OP == kNeg) {
        r[v] = sub_mod(0u, x[0][v], p);
      } else if constexpr (OP == kScale) {
        r[v] = shoup_mod(x[0][v], w, ws, p);
      } else {
        r[v] = shoup_mod(sub_mod(x[0][v], x[1][v], p), w, ws, p);
      }
    }
    repro::store4(args.out + outer * args.out_stride + col, r, 4, true);
  }
}

template <int OP>
cudaError_t launch(const EfuArgs& args, cudaStream_t stream) {
  const unsigned rows = static_cast<unsigned>(args.rows);
  const dim3 grid((args.N + kWordsPerCta - 1) / kWordsPerCta,
                  rows < kMaxGridY ? rows : kMaxGridY);
  efu_kernel<OP><<<grid, repro::kThreads, 0, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// Launch one EFU op on `stream`; returns the CUDA error (0 on success).
// a..d: operand base pointers (null where the op takes fewer), sa..sd their
// outer strides in words; out and so the output's; q and mu the (ℓ,) int64
// primes and Barrett constants; w the (2, ℓ) u32 scalars and companions of
// scale/subscale (else null).  Every operand used and the output must be
// 16-byte aligned with N and the strides multiples of 4 words
// (cudaErrorInvalidValue otherwise).
extern "C" int efu_launch(int op, const void* a, const void* b, const void* c,
                          const void* d, long long sa, long long sb, long long sc,
                          long long sd, void* out, long long so, const void* q,
                          const void* mu, const void* w, int outer, int ell, int N,
                          void* stream) {
  if (outer < 0 || ell <= 0 || N <= 0 || op < kMul || op > kSubScale)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(outer) * ell;
  if (rows == 0) return 0;
  const void* in[4] = {a, b, c, d};
  const long long stride[4] = {sa, sb, sc, sd};
  bool ok = rows <= 0x7fffffffLL && N % 4 == 0 && so % 4 == 0 && repro::aligned16(out) &&
            (w != nullptr || (op != kScale && op != kSubScale));
  for (int i = 0; i < arity(op); ++i)
    ok = ok && in[i] != nullptr && repro::aligned16(in[i]) && stride[i] % 4 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const EfuArgs args = {
      {static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
       static_cast<const uint32_t*>(c), static_cast<const uint32_t*>(d)},
      {sa, sb, sc, sd}, static_cast<uint32_t*>(out), so,
      static_cast<const int64_t*>(q), static_cast<const int64_t*>(mu),
      static_cast<const uint32_t*>(w), static_cast<int>(rows), ell, N};
  auto s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kMul: return static_cast<int>(launch<kMul>(args, s));
    case kAdd: return static_cast<int>(launch<kAdd>(args, s));
    case kSub: return static_cast<int>(launch<kSub>(args, s));
    case kMac: return static_cast<int>(launch<kMac>(args, s));
    case kMulAdd: return static_cast<int>(launch<kMulAdd>(args, s));
    case kNeg: return static_cast<int>(launch<kNeg>(args, s));
    case kScale: return static_cast<int>(launch<kScale>(args, s));
    default: return static_cast<int>(launch<kSubScale>(args, s));
  }
}
