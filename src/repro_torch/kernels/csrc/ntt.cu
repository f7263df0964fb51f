// Four-step negacyclic NTT and iNTT of (B, N) u32 residues, one prime per
// row (row b uses limb b mod ell of the stacked tables).
//
// Replaces the TPU kernel src/repro/kernels/ntt/kernel.py:ntt_pallas (bodies
// _fwd_body / _inv_body with _col_ntt, _col_intt, _row_dft).  The same R x C
// dataflow, with A[n1, n2] = a[C*n1 + n2]:
//
//   forward: R-point negacyclic column NTT (root psi^C, lazy fused CT, output
//            bit-reversed -> natural k1), times the twiddle psi^{(2k1+1)n2},
//            C-point cyclic row DFT (root psi^{2R}, lazy DIT), one [0,2q) ->
//            [0,q) correction, out[k1 + R*k2] = B[k1, k2];
//   inverse: the transposed load B[k1, k2] = x[k1 + R*k2], the inverse row
//            DFT, times C^-1 and the inverse twiddle, the column iNTT (lazy
//            GS) whose final R^-1 Shoup multiply fully reduces.
//
// Butterflies are Harvey's lazy [0, 2q) Shoup butterflies of the reference
// (u32: __umulhi for the Shoup quotient; lazy values < 2q < 2^31 and
// a + b*w before its conditional subtract < 4q < 2^32).  Inputs may be any
// value below 2q; outputs are canonical [0, q), so every R gives the fused
// transform's bytes.
//
// Bound on the H100: bytes.  Per limb the transform does (N/2)*log2(N)
// butterflies plus N twiddle products, about 20 integer operations per byte
// it must move at most, far under the card's operations-per-byte balance.
// Design: the TPU kernel keeps a whole (limb block, N) tile in VMEM; one limb
// at N = 2^16 is 256 KiB, more than a CTA's 227 KB of shared memory, so the
// column and row phases are two passes that meet in global memory (a scratch
// buffer the wrapper allocates):
//
//   column pass: grid (B * C/TC); a CTA loads an R x TC tile of whole
//                columns (rows of TC consecutive words: coalesced), runs the
//                R-point transform on each column in shared memory, and
//                writes the tile back;
//   row pass:    grid (B * R/TR); a CTA loads TR rows of C words, runs the
//                C-point transform per row, and stores through a padded
//                shared-memory transpose (stride C+1: no bank conflicts) so
//                that the strided output a[k1 + R*k2] is written TR words at
//                a time.
//
// TC is the autotuner's knob; TR is the largest power of two <= R whose tile
// fits 48 KB.  A tile above 48 KB takes dynamic shared memory after
// cudaFuncSetAttribute; the wrapper refuses one above 227 KB.  The data make
// two round trips through device memory, and the twiddle tables one: the
// bound counts one.  A thread-block cluster sharing its shared memory could
// keep a limb on chip in one pass; that is later work.
//
// Tables are u32 bit patterns in int32 tensors (Shoup companions reach
// 2^32-1): col_w/col_ws (ell, R) psi_rev order; tw/tws (ell, R, C);
// st/sts (ell, C-1) stage-major; q, n_inv, c_inv and their companions (ell, 1).
#include "common.cuh"

namespace {

constexpr int kSmallSmem = 48 * 1024;

__device__ __forceinline__ uint32_t mul_shoup_lazy(uint32_t x, uint32_t w,
                                                   uint32_t ws, uint32_t q) {
  return x * w - __umulhi(x, ws) * q;          // in [0, 2q) for any u32 x
}

__device__ __forceinline__ uint32_t add_lazy(uint32_t a, uint32_t b,
                                             uint32_t two_q) {
  const uint32_t s = a + b;
  return s >= two_q ? s - two_q : s;
}

__device__ __forceinline__ uint32_t sub_lazy(uint32_t a, uint32_t b,
                                             uint32_t two_q) {
  const uint32_t d = a + two_q - b;
  return d >= two_q ? d - two_q : d;
}

__device__ __forceinline__ uint32_t reduce_once(uint32_t x, uint32_t q) {
  return x >= q ? x - q : x;
}

__device__ __forceinline__ int bit_reverse(int v, int bits) {
  return bits == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - bits));
}

// Forward column pass: x -> y = twiddle * column-NTT(x), both (B, R, C).
__global__ void ntt_fwd_col_kernel(const uint32_t* __restrict__ x,
                                   uint32_t* __restrict__ y,
                                   const uint32_t* __restrict__ col_w,
                                   const uint32_t* __restrict__ col_ws,
                                   const uint32_t* __restrict__ tw,
                                   const uint32_t* __restrict__ tws,
                                   const uint32_t* __restrict__ q_tab,
                                   int ell, int R, int C, int TC, int log_r) {
  extern __shared__ uint32_t s[];
  const int tiles = C / TC;
  const long long b = blockIdx.x / tiles;
  const int c0 = static_cast<int>(blockIdx.x % tiles) * TC;
  const int limb = static_cast<int>(b % ell);
  const long long N = static_cast<long long>(R) * C;
  const uint32_t q = q_tab[limb], two_q = q + q;
  const uint32_t* xb = x + b * N;
  const int n = R * TC;
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    s[e] = xb[static_cast<long long>(e / TC) * C + c0 + e % TC];
  __syncthreads();
  const uint32_t* w = col_w + static_cast<long long>(limb) * R;
  const uint32_t* ws = col_ws + static_cast<long long>(limb) * R;
  const int half = (R / 2) * TC;
  for (int m = 1, t = R / 2; m < R; m *= 2, t /= 2) {   // fused CT stages
    for (int f = threadIdx.x; f < half; f += blockDim.x) {
      const int c = f % TC, k = f / TC;
      const int i = k / t, j = i * 2 * t + k % t;
      const uint32_t a = s[j * TC + c];
      const uint32_t bw = mul_shoup_lazy(s[(j + t) * TC + c], w[m + i], ws[m + i], q);
      s[j * TC + c] = add_lazy(a, bw, two_q);
      s[(j + t) * TC + c] = sub_lazy(a, bw, two_q);
    }
    __syncthreads();
  }
  const uint32_t* twl = tw + limb * N;
  const uint32_t* twsl = tws + limb * N;
  uint32_t* yb = y + b * N;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int k1 = e / TC, c = e % TC;                  // bit-reversed -> natural
    const long long off = static_cast<long long>(k1) * C + c0 + c;
    yb[off] = mul_shoup_lazy(s[bit_reverse(k1, log_r) * TC + c], twl[off], twsl[off], q);
  }
}

// C-point cyclic DIT over TR rows held at stride S in shared memory (the
// rows were loaded in bit-reversed order); lazy in and out.
__device__ __forceinline__ void row_dft(uint32_t* s, int S, int TR, int C,
                                        const uint32_t* __restrict__ st,
                                        const uint32_t* __restrict__ sts,
                                        uint32_t q) {
  const uint32_t two_q = q + q;
  const int hc = C / 2;
  const int half = TR * hc;
  for (int m = 1; m < C; m *= 2) {
    for (int f = threadIdx.x; f < half; f += blockDim.x) {
      const int r = f / hc, k = f % hc;
      const int i = k % m, j = (k / m) * 2 * m + i;
      uint32_t* row = s + r * S;
      const uint32_t a = row[j];
      const uint32_t bw = mul_shoup_lazy(row[j + m], st[m - 1 + i], sts[m - 1 + i], q);
      row[j] = add_lazy(a, bw, two_q);
      row[j + m] = sub_lazy(a, bw, two_q);
    }
    __syncthreads();
  }
}

// Forward row pass: y (B, R, C) -> out with out[k1 + R*k2] = DFT(y[k1])[k2].
__global__ void ntt_fwd_row_kernel(const uint32_t* __restrict__ y,
                                   uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ st,
                                   const uint32_t* __restrict__ sts,
                                   const uint32_t* __restrict__ q_tab,
                                   int ell, int R, int C, int TR, int log_c) {
  extern __shared__ uint32_t s[];
  const int S = C + 1;
  const int tiles = R / TR;
  const long long b = blockIdx.x / tiles;
  const int k0 = static_cast<int>(blockIdx.x % tiles) * TR;
  const int limb = static_cast<int>(b % ell);
  const long long N = static_cast<long long>(R) * C;
  const uint32_t q = q_tab[limb];
  const uint32_t* yb = y + b * N + static_cast<long long>(k0) * C;
  const int n = TR * C;
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    s[(e / C) * S + bit_reverse(e % C, log_c)] = yb[e];
  __syncthreads();
  row_dft(s, S, TR, C, st + static_cast<long long>(limb) * (C - 1),
          sts + static_cast<long long>(limb) * (C - 1), q);
  uint32_t* ob = out + b * N + k0;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int k2 = e / TR, r = e % TR;
    ob[r + static_cast<long long>(R) * k2] = reduce_once(s[r * S + k2], q);
  }
}

// Inverse row pass: x with B[k1, k2] = x[k1 + R*k2] -> y (B, R, C) =
// twiddle_inv * C^-1 * inverse-DFT(B[k1]).
__global__ void ntt_inv_row_kernel(const uint32_t* __restrict__ x,
                                   uint32_t* __restrict__ y,
                                   const uint32_t* __restrict__ st,
                                   const uint32_t* __restrict__ sts,
                                   const uint32_t* __restrict__ twi,
                                   const uint32_t* __restrict__ twis,
                                   const uint32_t* __restrict__ c_inv,
                                   const uint32_t* __restrict__ c_inv_s,
                                   const uint32_t* __restrict__ q_tab,
                                   int ell, int R, int C, int TR, int log_c) {
  extern __shared__ uint32_t s[];
  const int S = C + 1;
  const int tiles = R / TR;
  const long long b = blockIdx.x / tiles;
  const int k0 = static_cast<int>(blockIdx.x % tiles) * TR;
  const int limb = static_cast<int>(b % ell);
  const long long N = static_cast<long long>(R) * C;
  const uint32_t q = q_tab[limb];
  const uint32_t* xb = x + b * N + k0;
  const int n = TR * C;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int k2 = e / TR, r = e % TR;
    s[r * S + bit_reverse(k2, log_c)] = xb[r + static_cast<long long>(R) * k2];
  }
  __syncthreads();
  row_dft(s, S, TR, C, st + static_cast<long long>(limb) * (C - 1),
          sts + static_cast<long long>(limb) * (C - 1), q);
  const uint32_t ci = c_inv[limb], cis = c_inv_s[limb];
  const long long base = static_cast<long long>(k0) * C;
  const uint32_t* twl = twi + limb * N + base;
  const uint32_t* twsl = twis + limb * N + base;
  uint32_t* yb = y + b * N + base;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const uint32_t v = mul_shoup_lazy(s[(e / C) * S + e % C], ci, cis, q);
    yb[e] = mul_shoup_lazy(v, twl[e], twsl[e], q);
  }
}

// Inverse column pass: y (B, R, C) -> out (B, R, C), the R-point column iNTT
// with its R^-1 scaling, fully reduced.
__global__ void ntt_inv_col_kernel(const uint32_t* __restrict__ y,
                                   uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ col_wi,
                                   const uint32_t* __restrict__ col_wis,
                                   const uint32_t* __restrict__ r_inv,
                                   const uint32_t* __restrict__ r_inv_s,
                                   const uint32_t* __restrict__ q_tab,
                                   int ell, int R, int C, int TC, int log_r) {
  extern __shared__ uint32_t s[];
  const int tiles = C / TC;
  const long long b = blockIdx.x / tiles;
  const int c0 = static_cast<int>(blockIdx.x % tiles) * TC;
  const int limb = static_cast<int>(b % ell);
  const long long N = static_cast<long long>(R) * C;
  const uint32_t q = q_tab[limb], two_q = q + q;
  const uint32_t* yb = y + b * N;
  const int n = R * TC;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int k1 = e / TC, c = e % TC;                  // natural -> bit-reversed
    s[bit_reverse(k1, log_r) * TC + c] = yb[static_cast<long long>(k1) * C + c0 + c];
  }
  __syncthreads();
  const uint32_t* w = col_wi + static_cast<long long>(limb) * R;
  const uint32_t* ws = col_wis + static_cast<long long>(limb) * R;
  const int half = (R / 2) * TC;
  for (int m = R, t = 1; m > 1; m /= 2, t *= 2) {       // fused GS stages
    const int h = m / 2;
    for (int f = threadIdx.x; f < half; f += blockDim.x) {
      const int c = f % TC, k = f / TC;
      const int i = k / t, j = i * 2 * t + k % t;
      const uint32_t a = s[j * TC + c], v = s[(j + t) * TC + c];
      s[j * TC + c] = add_lazy(a, v, two_q);
      s[(j + t) * TC + c] = mul_shoup_lazy(sub_lazy(a, v, two_q), w[h + i], ws[h + i], q);
    }
    __syncthreads();
  }
  const uint32_t ri = r_inv[limb], ris = r_inv_s[limb];
  uint32_t* ob = out + b * N;
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    ob[static_cast<long long>(e / TC) * C + c0 + e % TC] =
        reduce_once(mul_shoup_lazy(s[e], ri, ris, q), q);
}

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kSmallSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// x, out, scratch (B, N) u32 with N = R*C; tables as in the header note.
// TC divides C, TR divides R; the wrapper checks the tile sizes.
extern "C" int ntt_fwd_launch(const void* x, void* out, void* scratch,
                              const void* col_w, const void* col_ws,
                              const void* tw, const void* tws,
                              const void* st, const void* sts, const void* q,
                              int B, int ell, int R, int C, int TC, int TR,
                              void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t col_smem = static_cast<size_t>(R) * TC * 4;
  const size_t row_smem = static_cast<size_t>(TR) * (C + 1) * 4;
  cudaError_t err = allow_smem(ntt_fwd_col_kernel, col_smem);
  if (err == cudaSuccess) err = allow_smem(ntt_fwd_row_kernel, row_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_fwd_col_kernel<<<static_cast<unsigned>(static_cast<long long>(B) * (C / TC)),
                       repro::kThreads, col_smem, s>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(scratch),
      static_cast<const uint32_t*>(col_w), static_cast<const uint32_t*>(col_ws),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tws),
      static_cast<const uint32_t*>(q), ell, R, C, TC, log2i(R));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_fwd_row_kernel<<<static_cast<unsigned>(static_cast<long long>(B) * (R / TR)),
                       repro::kThreads, row_smem, s>>>(
      static_cast<const uint32_t*>(scratch), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(st), static_cast<const uint32_t*>(sts),
      static_cast<const uint32_t*>(q), ell, R, C, TR, log2i(C));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ntt_inv_launch(const void* x, void* out, void* scratch,
                              const void* col_wi, const void* col_wis,
                              const void* twi, const void* twis,
                              const void* sti, const void* stis,
                              const void* r_inv, const void* r_inv_s,
                              const void* c_inv, const void* c_inv_s,
                              const void* q, int B, int ell, int R, int C,
                              int TC, int TR, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t col_smem = static_cast<size_t>(R) * TC * 4;
  const size_t row_smem = static_cast<size_t>(TR) * (C + 1) * 4;
  cudaError_t err = allow_smem(ntt_inv_row_kernel, row_smem);
  if (err == cudaSuccess) err = allow_smem(ntt_inv_col_kernel, col_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_inv_row_kernel<<<static_cast<unsigned>(static_cast<long long>(B) * (R / TR)),
                       repro::kThreads, row_smem, s>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(scratch),
      static_cast<const uint32_t*>(sti), static_cast<const uint32_t*>(stis),
      static_cast<const uint32_t*>(twi), static_cast<const uint32_t*>(twis),
      static_cast<const uint32_t*>(c_inv), static_cast<const uint32_t*>(c_inv_s),
      static_cast<const uint32_t*>(q), ell, R, C, TR, log2i(C));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_inv_col_kernel<<<static_cast<unsigned>(static_cast<long long>(B) * (C / TC)),
                       repro::kThreads, col_smem, s>>>(
      static_cast<const uint32_t*>(scratch), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(col_wi), static_cast<const uint32_t*>(col_wis),
      static_cast<const uint32_t*>(r_inv), static_cast<const uint32_t*>(r_inv_s),
      static_cast<const uint32_t*>(q), ell, R, C, TC, log2i(R));
  return static_cast<int>(cudaGetLastError());
}
