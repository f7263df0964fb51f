// Four-step negacyclic NTT and iNTT of (B, N) u32 residues, one prime per
// row (row b uses limb b mod ell of the stacked tables), each in one launch.
//
// Replaces the TPU kernel src/repro/kernels/ntt/kernel.py:156 ntt_pallas
// (bodies _fwd_body / _inv_body with _col_ntt, _col_intt, _row_dft).  The
// same R x C dataflow, with A[n1, n2] = a[C*n1 + n2]:
//
//   forward: R-point negacyclic column NTT (root psi^C), times the twiddle
//            psi^{(2k1+1)n2}, C-point cyclic row DFT (root psi^{2R}), one
//            [0,2q) -> [0,q) correction, out[k1 + R*k2] = B[k1, k2];
//   inverse: the transposed load B[k1, k2] = x[k1 + R*k2], the inverse row
//            DFT, times C^-1 and the inverse twiddle, the column iNTT, R^-1
//            and one full reduction.
//
// Butterflies are Harvey's lazy [0, 2q) Shoup butterflies of the reference
// (u32: __umulhi for the Shoup quotient; lazy values < 2q < 2^31, sums
// < 4q < 2^32 folded back by one unsigned min).  Inputs may be any value
// below 2q; outputs are canonical [0, q), so every R and every cluster size
// gives the fused transform's bytes.  The tables are those of the plain
// four-step (u32 bit patterns in int32 tensors): col_w/col_ws (ell, R)
// psi_rev order; tw/tws (ell, R, C); st/sts (ell, C-1) stage-major; q,
// r_inv, c_inv and their companions (ell, 1).
//
// Bound on the H100: bytes.  Per limb the transform does (N/2)*log2(N)
// butterflies plus N twiddle products, about 20 integer operations per byte
// it must move (data in and out, the twiddle tables, the stage tables).
//
// Design.  One limb lives in the shared memory of one thread-block cluster
// of CCL CTAs for the whole transform (N = 2^16: 256 KiB, more than one
// CTA's 227 KB): CTA r holds Rl = R/CCL whole rows, so the data cross device
// memory once in and once out and nothing else is written.  Positions
// p = r*Rl + pl of the column transform are ordered so that its stages that
// cross CTAs come last (forward) or first (inverse):
//
//   forward: CTA r loads rows n1 = brev(p) (whole rows, coalesced), runs the
//            column NTT as a decimation in time on bit-reversed input, which
//            leaves natural k1 = p: CTA r ends with the contiguous k1 range
//            [r*Rl, (r+1)*Rl).  Its stages m < Rl are local, the last
//            log2(CCL) stages pair CTAs.  The twiddle rows tw[k1, :] are then
//            read in order, the row DFT (decimation in frequency: natural in,
//            bit-reversed out) is local, and out[k1 + R*k2] is written in runs
//            of Rl words per k2;
//   inverse: the mirror.  CTA r reads the contiguous k1 range in runs of Rl
//            words per k2, writing k2 bit-reversed; the row iDFT (decimation
//            in time) leaves natural n2; the column iNTT (Gentleman-Sande on
//            natural input) crosses CTAs in its first log2(CCL) stages and
//            leaves rows n1 = brev(p), which are stored whole.
//
// A stage that crosses CTAs reads the partner CTAs' words at the thread's
// own local offsets, 16 bytes at a time through map_shared_rank (in order:
// on the H100 a scattered remote read costs 2.5-4x an in-order one), runs all
// log2(CCL) cross stages in registers and writes every result back to its
// owner; cluster.sync() comes before (the local stages are done everywhere)
// and after (the results are in place); each word is read and written by one
// thread only, so nothing else has to be ordered, and no CTA touches another
// CTA's shared memory after the last cluster.sync().  The twiddle product is
// fused into the column pass that touches the twiddle rows in order.  The
// limb's column and row stage twiddles (R + C - 1 of each kind) are copied
// to shared memory beside the tile as (w, w') pairs: a butterfly reads its
// twiddle with one 8-byte shared load instead of two global loads whose
// 64-bit address arithmetic cost more than the butterfly.
//
// What held the two-pass kernel back, and what this design does about it:
//   - one butterfly per thread per stage, then a barrier: each thread holds
//     up to 16 words of a column or a row in registers and runs up to four
//     radix-2 stages between barriers (log2 N = 16 stages: 4-6 barriers);
//   - integer division in every index: R, C, Rl and CCL are powers of two,
//     passed as logarithms (CCL as a template argument); every index is a
//     shift, a mask or a bit reversal (__brev);
//   - shared-memory bank conflicts on the transposed and bit-reversed
//     accesses: word x of local row pl lives at pl*C + (x ^ (pl & 31)) (an
//     XOR swizzle, no padding), so a warp reading along a row or down a
//     column (the transposed store, the bit-reversed load) hits 32 banks;
//     the row passes give each lane its own row for that reason.  The
//     swizzle is why the rows are staged by coalesced loads and not by the
//     TMA, whose 1-D bulk copy cannot scatter words;
//   - two launches meeting in device memory: one launch, no scratch;
//   - few CTAs for small operands: CCL CTAs per limb, so (2, 12, N) runs
//     24*CCL CTAs instead of 24.  The kernel is built for two CTAs of 512
//     threads per SM (64 registers), and the wrapper's default cluster size
//     takes the largest share at which two CTAs fit an SM (N = 2^16: CCL = 4,
//     68 KiB), so that one CTA's loads and stores overlap the other's stages.
//
// The distributed four-step (repro_torch.core.distributed) cuts the same
// dataflow at its one exchange, the paper's §III-B shuffle, into four phase
// kernels that run on every block of a (limb, coef) mesh of logical shards
// in one launch each (the reference's shard bodies,
// src/repro/core/distributed.py:631-660, which cut ntt_pallas's _fwd_body /
// _inv_body in two):
//
//   ntt_fwd_col_kernel: on a block's column slice (R, C/cs), the R-point
//            column NTT, then its twiddle columns psi^{(2k1+1)n2};
//   ntt_row_kernel<false>: on a block's row slice (R/cs, C), the C-point
//            cyclic row DFT;
//   ntt_row_kernel<true>: the inverse row DFT, then C^-1;
//   ntt_inv_col_kernel: the inverse twiddle columns, then the column iNTT
//            with its R^-1.
//
// Each phase ends fully reduced, so whatever the exchange does to the order
// of its chunks, the next phase reads canonical residues.  A block is
// addressed as (i, j, b, l): limb cluster i, core j of the cluster, batch
// row b and local limb l; the input is read through four strides (a view of
// the global tensor, or the exchange's buffer; the n_loc words of a block
// row are contiguous) and the output written contiguous (lc, cs, B, ell,
// n_loc).  Limb l of cluster i uses table row i*limb_block + l (limb_block =
// 0: every cluster holds all limbs).  A simple design that is right first
// (the two passes this transform had before its one-pass form, the tiles
// cut to a block): one CTA per tile of TC whole columns or TR whole rows in
// shared memory (at most kPhaseWords words), one butterfly per thread per
// stage between barriers.
#include "common.cuh"

namespace {

constexpr int kNttThreads = 512;
constexpr int kMaxRadixLog = 4;              // up to 16 words per thread per pass

__device__ __forceinline__ uint32_t mul_shoup_lazy(uint32_t x, uint32_t w,
                                                   uint32_t ws, uint32_t q) {
  return x * w - __umulhi(x, ws) * q;          // in [0, 2q) for any u32 x
}

// [0, 4q) -> [0, 2q): s - 2q wraps above s exactly when s < 2q.
__device__ __forceinline__ uint32_t fold(uint32_t s, uint32_t two_q) {
  return min(s, s - two_q);
}

__device__ __forceinline__ uint32_t reduce_once(uint32_t x, uint32_t q) {
  return min(x, x - q);
}

// v reversed in its low `bits` bits (0 <= bits <= 31).
__device__ __forceinline__ int brev(int v, int bits) {
  return static_cast<int>((__brev(static_cast<unsigned>(v)) >> 1) >> (31 - bits));
}

// Cooley-Tukey (decimation in time): (a, b) -> (a + w b, a - w b).
__device__ __forceinline__ void ct(uint32_t& a, uint32_t& b, uint32_t w,
                                   uint32_t ws, uint32_t q, uint32_t two_q) {
  const uint32_t bw = mul_shoup_lazy(b, w, ws, q);
  const uint32_t u = a;
  a = fold(u + bw, two_q);
  b = fold(u + two_q - bw, two_q);
}

// Gentleman-Sande (decimation in frequency): (a, b) -> (a + b, (a - b) w).
__device__ __forceinline__ void gs(uint32_t& a, uint32_t& b, uint32_t w,
                                   uint32_t ws, uint32_t q, uint32_t two_q) {
  const uint32_t u = a;
  a = fold(u + b, two_q);
  b = mul_shoup_lazy(u + two_q - b, w, ws, q);
}

// The CTA's Rl x C block of the limb in shared memory, XOR-swizzled.
struct Tile {
  uint32_t* s;
  int lg_rl, lg_c, key;                        // key = min(C, 32) - 1
  __device__ __forceinline__ int at(int pl, int x) const {
    return (pl << lg_c) | (x ^ (pl & key));
  }
};

// Per-limb tables, u32 bits.  col_w: psi_rev (forward) or psi_inv_rev
// (inverse); tw: the twiddle or the inverse twiddle; st: the row stages.
struct NttTables {
  const uint32_t *col_w, *col_ws, *tw, *tws, *st, *sts, *q;
  const uint32_t *r_inv, *r_inv_s, *c_inv, *c_inv_s;   // inverse only
};

// One limb's tables.  kStaged: the column and row twiddles were copied to
// shared memory as (w, w') pairs (the wrapper's choice: when they are small
// beside the tile, as at R and C near sqrt(N)), else they are read from
// device memory.
template <bool kStaged>
struct Limb {
  const uint32_t *col_w, *col_ws, *st, *sts, *tw, *tws;
  const uint2 *col, *row;
  uint32_t q, two_q, r_inv, r_inv_s, c_inv, c_inv_s;
  __device__ __forceinline__ uint2 col_pair(int i) const {
    if constexpr (kStaged) return col[i];
    else return make_uint2(__ldg(col_w + i), __ldg(col_ws + i));
  }
  __device__ __forceinline__ uint2 row_pair(int i) const {
    if constexpr (kStaged) return row[i];
    else return make_uint2(__ldg(st + i), __ldg(sts + i));
  }
};

// The limb's tables; with kStaged its column and row twiddles are copied,
// as (w, w') pairs, to `pairs` in shared memory (R + C - 1 pairs, read
// after the barrier that ends the staging loads).
template <bool kStaged>
__device__ __forceinline__ Limb<kStaged> limb_tables(const NttTables& t, int limb,
                                                     int lg_r, int lg_c,
                                                     bool forward, uint2* pairs) {
  const int R = 1 << lg_r, C = 1 << lg_c;
  Limb<kStaged> l;
  l.col_w = t.col_w + static_cast<long long>(limb) * R;
  l.col_ws = t.col_ws + static_cast<long long>(limb) * R;
  l.st = t.st + static_cast<long long>(limb) * (C - 1);
  l.sts = t.sts + static_cast<long long>(limb) * (C - 1);
  if constexpr (kStaged) {
    for (int i = threadIdx.x; i < R; i += kNttThreads)
      pairs[i] = make_uint2(__ldg(l.col_w + i), __ldg(l.col_ws + i));
    for (int i = threadIdx.x; i < C - 1; i += kNttThreads)
      pairs[R + i] = make_uint2(__ldg(l.st + i), __ldg(l.sts + i));
  }
  l.col = pairs;
  l.row = pairs + R;
  l.tw = t.tw + (static_cast<long long>(limb) << (lg_r + lg_c));
  l.tws = t.tws + (static_cast<long long>(limb) << (lg_r + lg_c));
  l.q = __ldg(t.q + limb);
  l.two_q = l.q + l.q;
  l.r_inv = forward ? 0u : __ldg(t.r_inv + limb);
  l.r_inv_s = forward ? 0u : __ldg(t.r_inv_s + limb);
  l.c_inv = forward ? 0u : __ldg(t.c_inv + limb);
  l.c_inv_s = forward ? 0u : __ldg(t.c_inv_s + limb);
  return l;
}

// Twiddle product of element (k1, n2): forward psi^{(2k1+1)n2}; inverse
// C^-1 psi^{-(2k1+1)n2}.
template <bool kForward, class L>
__device__ __forceinline__ uint32_t twiddle(uint32_t v, const L& l, int k1,
                                            int n2, int lg_c) {
  const int off = (k1 << lg_c) | n2;
  if (!kForward) v = mul_shoup_lazy(v, l.c_inv, l.c_inv_s, l.q);
  return mul_shoup_lazy(v, __ldg(l.tw + off), __ldg(l.tws + off), l.q);
}

// Column stages on row-index bits [b0, b0 + K) within the CTA (stages
// m = 2^(b0+h) < Rl, so p mod m = pl mod m): each thread holds 2^K words of
// one column, lanes on consecutive columns.  Forward: DIT, twiddle
// psi_rev[m + brev(p mod m)].  Inverse: GS in the reverse order with
// psi_inv_rev at the same index.  `tw_too`: the twiddle product after the
// stages (forward) or before them (inverse), with k1 = pl (CCL = 1 only).
template <int K, bool kForward, class L>
__device__ __forceinline__ void col_pass(const Tile& t, const L& l, int b0,
                                         bool tw_too) {
  constexpr int E = 1 << K;
  const int C = 1 << t.lg_c;
  const int groups = 1 << (t.lg_rl + t.lg_c - K);
  for (int g = threadIdx.x; g < groups; g += kNttThreads) {
    const int c = g & (C - 1);
    const int rest = g >> t.lg_c;
    const int lo = rest & ((1 << b0) - 1);
    const int p0 = lo | ((rest >> b0) << (b0 + K));
    uint32_t v[E];
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = t.s[t.at(p0 | (j << b0), c)];
    if (!kForward && tw_too) {
#pragma unroll
      for (int j = 0; j < E; ++j) v[j] = twiddle<false>(v[j], l, p0 | (j << b0), c, t.lg_c);
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int h = kForward ? i : K - 1 - i;
      const int lg_m = b0 + h;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (j & (1 << h)) continue;
        const int k = lo | ((j & ((1 << h) - 1)) << b0);
        const int idx = (1 << lg_m) | brev(k, lg_m);
        const uint2 w = l.col_pair(idx);
        if (kForward) ct(v[j], v[j | (1 << h)], w.x, w.y, l.q, l.two_q);
        else gs(v[j], v[j | (1 << h)], w.x, w.y, l.q, l.two_q);
      }
    }
    if (kForward && tw_too) {
#pragma unroll
      for (int j = 0; j < E; ++j) v[j] = twiddle<true>(v[j], l, p0 | (j << b0), c, t.lg_c);
    }
#pragma unroll
    for (int j = 0; j < E; ++j) t.s[t.at(p0 | (j << b0), c)] = v[j];
  }
}

// Row stages on column-index bits [b0, b0 + K): each thread holds 2^K words
// of one row, lanes on consecutive rows (distinct banks under the swizzle).
// Forward: DIF (natural in, bit-reversed out); inverse: DIT (bit-reversed
// in, natural out); both with the stage table st[m - 1 + (x mod m)].
template <int K, bool kForward, class L>
__device__ __forceinline__ void row_pass(const Tile& t, const L& l, int b0) {
  constexpr int E = 1 << K;
  const int Rl = 1 << t.lg_rl;
  const int groups = 1 << (t.lg_rl + t.lg_c - K);
  for (int g = threadIdx.x; g < groups; g += kNttThreads) {
    const int pl = g & (Rl - 1);
    const int rest = g >> t.lg_rl;
    const int lo = rest & ((1 << b0) - 1);
    const int x0 = lo | ((rest >> b0) << (b0 + K));
    uint32_t v[E];
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = t.s[t.at(pl, x0 | (j << b0))];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int h = kForward ? K - 1 - i : i;
      const int m = 1 << (b0 + h);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (j & (1 << h)) continue;
        const int idx = m - 1 + (lo | ((j & ((1 << h) - 1)) << b0));
        const uint2 w = l.row_pair(idx);
        if (kForward) gs(v[j], v[j | (1 << h)], w.x, w.y, l.q, l.two_q);
        else ct(v[j], v[j | (1 << h)], w.x, w.y, l.q, l.two_q);
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) t.s[t.at(pl, x0 | (j << b0))] = v[j];
  }
}

template <bool kForward, int K, class L>
__device__ __forceinline__ void run_pass(bool col, const Tile& t, const L& l,
                                         int b0, bool tw_too) {
  if (col) col_pass<K, kForward>(t, l, b0, tw_too);
  else row_pass<K, kForward>(t, l, b0);
}

// Stages on bits [0, bits) of the column (col) or row index, in passes of
// at most kMaxRadixLog bits of near-equal size: upwards for a DIT, downwards
// for a DIF/GS, with a barrier after each pass.  `tw_first` / `tw_last`: the
// twiddle product in the first / last column pass.
template <bool kForward, class L>
__device__ __forceinline__ void local_stages(bool col, int bits, const Tile& t,
                                             const L& l, bool tw_first,
                                             bool tw_last) {
  static_assert(kMaxRadixLog == 4, "passes = ceil(bits / 4) below");
  if (bits == 0) return;
  const bool up = col == kForward;         // column DIT forward, row DIT inverse
  const int passes = (bits + 3) >> 2;
  int base = 1;
  while ((base + 1) * passes <= bits) ++base;       // bits = base*passes + extra
  const int extra = bits - base * passes;
  for (int i = 0; i < passes; ++i) {
    const int n = up ? i : passes - 1 - i;          // which slice of the bits
    const int K = base + (n < extra);
    const int b0 = n * base + min(n, extra);
    const bool tw_too = (i == 0 && tw_first) || (i == passes - 1 && tw_last);
    switch (K) {
      case 1: run_pass<kForward, 1>(col, t, l, b0, tw_too); break;
      case 2: run_pass<kForward, 2>(col, t, l, b0, tw_too); break;
      case 3: run_pass<kForward, 3>(col, t, l, b0, tw_too); break;
      default: run_pass<kForward, 4>(col, t, l, b0, tw_too); break;
    }
    __syncthreads();
  }
}

// The column stages that pair CTAs (m >= Rl): each thread takes 4 words at
// one local offset from every CTA of the cluster, runs the log2(CCL) stages
// in registers, and writes each word back to its owner.  The twiddle product
// comes after the stages (forward) or before them (inverse).  CTA r handles
// the r-th share of the offsets.  Called between two cluster.sync().
template <int CCL, bool kForward, class L>
__device__ __forceinline__ void cross_pass(cg::cluster_group& cluster,
                                           const Tile& t, const L& l,
                                           int rank) {
  constexpr int LG = CCL == 2 ? 1 : CCL == 4 ? 2 : 3;
  const int share = 1 << (t.lg_rl + t.lg_c - LG);
  const int C = 1 << t.lg_c;
  const int end = (rank + 1) * share;
  for (int o = rank * share + 4 * static_cast<int>(threadIdx.x); o < end;
       o += 4 * kNttThreads) {
    uint32_t a[CCL][4];
#pragma unroll
    for (int r = 0; r < CCL; ++r) {
      const uint4 u = *reinterpret_cast<const uint4*>(cluster.map_shared_rank(t.s + o, r));
      a[r][0] = u.x; a[r][1] = u.y; a[r][2] = u.z; a[r][3] = u.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pl = (o + e) >> t.lg_c;
      const int x = ((o + e) & (C - 1)) ^ (pl & t.key);   // logical column
      if (!kForward) {
#pragma unroll
        for (int r = 0; r < CCL; ++r)
          a[r][e] = twiddle<false>(a[r][e], l, (r << t.lg_rl) | pl, x, t.lg_c);
      }
#pragma unroll
      for (int i = 0; i < LG; ++i) {
        const int h = kForward ? i : LG - 1 - i;
        const int lg_m = t.lg_rl + h;
#pragma unroll
        for (int r = 0; r < CCL; ++r) {
          if (r & (1 << h)) continue;
          const int k = ((r & ((1 << h) - 1)) << t.lg_rl) | pl;
          const int idx = (1 << lg_m) | brev(k, lg_m);
          const uint2 w = l.col_pair(idx);
          if (kForward) ct(a[r][e], a[r | (1 << h)][e], w.x, w.y, l.q, l.two_q);
          else gs(a[r][e], a[r | (1 << h)][e], w.x, w.y, l.q, l.two_q);
        }
      }
      if (kForward) {
#pragma unroll
        for (int r = 0; r < CCL; ++r)
          a[r][e] = twiddle<true>(a[r][e], l, (r << t.lg_rl) | pl, x, t.lg_c);
      }
    }
#pragma unroll
    for (int r = 0; r < CCL; ++r)
      *reinterpret_cast<uint4*>(cluster.map_shared_rank(t.s + o, r)) =
          make_uint4(a[r][0], a[r][1], a[r][2], a[r][3]);
  }
}

// One limb row per cluster: blockIdx.x = limb * CCL + rank, blockIdx.y = the
// leading index, so row b = blockIdx.y * ell + limb.
template <int CCL, bool kStaged>
__global__ void __launch_bounds__(kNttThreads, 2)
ntt_fwd_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               NttTables tabs, int ell, int lg_r, int lg_c) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int LG = CCL == 1 ? 0 : CCL == 2 ? 1 : CCL == 4 ? 2 : 3;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(blockIdx.x) & (CCL - 1);
  const int limb = static_cast<int>(blockIdx.x) >> LG;
  const long long row = static_cast<long long>(blockIdx.y) * ell + limb;
  const auto l = limb_tables<kStaged>(tabs, limb, lg_r, lg_c, true,
                             reinterpret_cast<uint2*>(smem + (1 << (lg_r + lg_c - LG))));
  const Tile t{smem, lg_r - LG, lg_c, min(1 << lg_c, 32) - 1};
  const int words = 1 << (t.lg_rl + lg_c);
  const int C = 1 << lg_c, Rl = 1 << t.lg_rl;
  // rows n1 = brev(p), p = rank*Rl + pl: whole rows, in order
  const uint32_t* src = x + (row << (lg_r + lg_c));
#pragma unroll 8
  for (int e = threadIdx.x; e < words; e += kNttThreads) {
    const int pl = e >> lg_c, c = e & (C - 1);
    const int n1 = brev((rank << t.lg_rl) | pl, lg_r);
    smem[t.at(pl, c)] = __ldg(src + ((n1 << lg_c) | c));
  }
  __syncthreads();
  // column NTT: local DIT stages, then the stages across the cluster; the
  // twiddle product ends the last column pass
  local_stages<true>(true, t.lg_rl, t, l, false, CCL == 1);
  if constexpr (CCL > 1) {
    cluster.sync();
    cross_pass<CCL, true>(cluster, t, l, rank);
    cluster.sync();
  }
  // row DFT, natural n2 in, bit-reversed k2 out
  local_stages<true>(false, lg_c, t, l, false, false);
  // out[k1 + R*k2]: runs of Rl words per k2
  uint32_t* dst = out + (row << (lg_r + lg_c)) + (rank << t.lg_rl);
#pragma unroll 8
  for (int e = threadIdx.x; e < words; e += kNttThreads) {
    const int pl = e & (Rl - 1), k2 = e >> t.lg_rl;
    dst[pl + (static_cast<long long>(k2) << lg_r)] =
        reduce_once(smem[t.at(pl, brev(k2, lg_c))], l.q);
  }
}

template <int CCL, bool kStaged>
__global__ void __launch_bounds__(kNttThreads, 2)
ntt_inv_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               NttTables tabs, int ell, int lg_r, int lg_c) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int LG = CCL == 1 ? 0 : CCL == 2 ? 1 : CCL == 4 ? 2 : 3;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(blockIdx.x) & (CCL - 1);
  const int limb = static_cast<int>(blockIdx.x) >> LG;
  const long long row = static_cast<long long>(blockIdx.y) * ell + limb;
  const auto l = limb_tables<kStaged>(tabs, limb, lg_r, lg_c, false,
                             reinterpret_cast<uint2*>(smem + (1 << (lg_r + lg_c - LG))));
  const Tile t{smem, lg_r - LG, lg_c, min(1 << lg_c, 32) - 1};
  const int words = 1 << (t.lg_rl + lg_c);
  const int C = 1 << lg_c, Rl = 1 << t.lg_rl;
  // B[k1, k2] = x[k1 + R*k2] for k1 in [rank*Rl, (rank+1)*Rl): runs of Rl
  // words per k2, written to column brev(k2)
  const uint32_t* src = x + (row << (lg_r + lg_c)) + (rank << t.lg_rl);
#pragma unroll 8
  for (int e = threadIdx.x; e < words; e += kNttThreads) {
    const int pl = e & (Rl - 1), k2 = e >> t.lg_rl;
    smem[t.at(pl, brev(k2, lg_c))] =
        __ldg(src + pl + (static_cast<long long>(k2) << lg_r));
  }
  __syncthreads();
  // row iDFT, bit-reversed in, natural n2 out
  local_stages<false>(false, lg_c, t, l, false, false);
  // column iNTT: C^-1 and the inverse twiddle begin the first column pass,
  // the stages across the cluster come first, then the local GS stages
  if constexpr (CCL > 1) {
    cluster.sync();
    cross_pass<CCL, false>(cluster, t, l, rank);
    cluster.sync();
  }
  local_stages<false>(true, t.lg_rl, t, l, CCL == 1, false);
  // rows n1 = brev(p) times R^-1, fully reduced, stored whole
  uint32_t* dst = out + (row << (lg_r + lg_c));
#pragma unroll 8
  for (int e = threadIdx.x; e < words; e += kNttThreads) {
    const int pl = e >> lg_c, c = e & (C - 1);
    const int n1 = brev((rank << t.lg_rl) | pl, lg_r);
    dst[(n1 << lg_c) | c] =
        reduce_once(mul_shoup_lazy(smem[t.at(pl, c)], l.r_inv, l.r_inv_s, l.q), l.q);
  }
}

// Dynamic shared memory of a CTA: its N / CCL words, and with the twiddle
// pairs staged their R + C - 1 pairs.
long long staged_smem(int lg_r, int lg_c, int ccl, bool staged) {
  const long long words = (1LL << (lg_r + lg_c)) / ccl;
  return (words + (staged ? 2LL * ((1LL << lg_r) + (1LL << lg_c) - 1) : 0)) * 4;
}

int log2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// Launch one direction at cluster size CCL: grid (ell * CCL, B / ell),
// N / CCL words and R + C - 1 twiddle pairs of dynamic shared memory per CTA.
template <bool kForward, int CCL, bool kStaged>
cudaError_t launch_ntt(const void* x, void* out, const NttTables& tabs, int B,
                       int ell, int lg_r, int lg_c, cudaStream_t stream) {
  const int smem = staged_smem(lg_r, lg_c, CCL, kStaged);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ell * CCL), static_cast<unsigned>(B / ell));
  cfg.blockDim = dim3(kNttThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto kernel = kForward ? ntt_fwd_kernel<CCL, kStaged> : ntt_inv_kernel<CCL, kStaged>;
  static repro::ClusterLaunchState state;
  cudaError_t err = repro::prepare_cluster_launch(kernel, cfg, state, CCL, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint32_t*>(x),
                           static_cast<uint32_t*>(out), tabs, ell, lg_r, lg_c);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kForward, int CCL>
cudaError_t launch_at(const void* x, void* out, const NttTables& tabs, int B,
                      int ell, int lg_r, int lg_c, bool staged,
                      cudaStream_t stream) {
  if (staged)
    return launch_ntt<kForward, CCL, true>(x, out, tabs, B, ell, lg_r, lg_c, stream);
  return launch_ntt<kForward, CCL, false>(x, out, tabs, B, ell, lg_r, lg_c, stream);
}

template <bool kForward>
int launch(const void* x, void* out, const NttTables& tabs, int B, int ell,
           int R, int C, int cluster, int staged, void* stream) {
  if (B <= 0) return 0;
  const long long N = static_cast<long long>(R) * C;
  const bool ok =
      ell > 0 && B % ell == 0 && B / ell <= 65535 && R >= 2 && C >= 2 &&
      (R & (R - 1)) == 0 && (C & (C - 1)) == 0 && N <= (1LL << 30) &&
      (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
      cluster <= R && N / cluster * 4 <= repro::kMaxSmemPerCta &&
      (cluster == 1 || N % (4LL * cluster * cluster) == 0) &&
      (staged == 0 || staged == 1) &&
      static_cast<long long>(ell) * cluster <= 0x7fffffffLL;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int lg_r = log2i(R), lg_c = log2i(C);
  if (staged_smem(lg_r, lg_c, cluster, staged) > repro::kMaxSmemPerCta)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (cluster) {
    case 1: err = launch_at<kForward, 1>(x, out, tabs, B, ell, lg_r, lg_c, staged, s); break;
    case 2: err = launch_at<kForward, 2>(x, out, tabs, B, ell, lg_r, lg_c, staged, s); break;
    case 4: err = launch_at<kForward, 4>(x, out, tabs, B, ell, lg_r, lg_c, staged, s); break;
    default: err = launch_at<kForward, 8>(x, out, tabs, B, ell, lg_r, lg_c, staged, s); break;
  }
  return static_cast<int>(err);
}


// -- the distributed four-step's phases ---------------------------------------

constexpr int kPhaseWords = 4096;          // words of a phase kernel's tile

struct BlockGeom {
  long long si, sj, sb, sl;                // input strides of (i, j, b, l)
  int cs, B, ell, limb_block;
  long long n_loc;                         // words of one block row
};

struct BlockRow {
  long long in_off, out_off;
  int limb, j;
};

// Block row r of the launch: r = ((i*cs + j)*B + b)*ell + l.
__device__ __forceinline__ BlockRow block_row(long long r, const BlockGeom& g) {
  const int l = static_cast<int>(r % g.ell);
  long long t = r / g.ell;
  const int b = static_cast<int>(t % g.B);
  t /= g.B;
  const int j = static_cast<int>(t % g.cs);
  const int i = static_cast<int>(t / g.cs);
  return {i * g.si + j * g.sj + b * g.sb + l * g.sl, r * g.n_loc,
          i * g.limb_block + l, j};
}

__device__ __forceinline__ uint32_t add_lazy(uint32_t a, uint32_t b, uint32_t two_q) {
  return fold(a + b, two_q);
}

__device__ __forceinline__ uint32_t sub_lazy(uint32_t a, uint32_t b, uint32_t two_q) {
  return fold(a + two_q - b, two_q);
}

// Forward column phase: a tile of TC columns of the block's (R, Cl) slice,
// the column NTT (fused CT on natural input, bit-reversed result), then the
// twiddle of the block's columns [j*Cl, (j+1)*Cl); canonical out.
__global__ void ntt_fwd_col_kernel(const uint32_t* __restrict__ x,
                                   uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ col_w,
                                   const uint32_t* __restrict__ col_ws,
                                   const uint32_t* __restrict__ tw,
                                   const uint32_t* __restrict__ tws,
                                   const uint32_t* __restrict__ q_tab,
                                   BlockGeom g, int R, int C, int Cl, int TC,
                                   int lg_r) {
  extern __shared__ uint32_t s[];
  const BlockRow br = block_row(blockIdx.x, g);
  const int c0 = blockIdx.y * TC;
  const uint32_t q = q_tab[br.limb], two_q = q + q;
  const uint32_t* xb = x + br.in_off;
  const int n = R * TC;
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    s[e] = xb[static_cast<long long>(e / TC) * Cl + c0 + e % TC];
  __syncthreads();
  const uint32_t* w = col_w + static_cast<long long>(br.limb) * R;
  const uint32_t* ws = col_ws + static_cast<long long>(br.limb) * R;
  const int half = (R / 2) * TC;
  for (int m = 1, t = R / 2; m < R; m *= 2, t /= 2) {
    for (int f = threadIdx.x; f < half; f += blockDim.x) {
      const int c = f % TC, k = f / TC;
      const int i = k / t, jj = i * 2 * t + k % t;
      const uint32_t a = s[jj * TC + c];
      const uint32_t bw = mul_shoup_lazy(s[(jj + t) * TC + c], w[m + i], ws[m + i], q);
      s[jj * TC + c] = add_lazy(a, bw, two_q);
      s[(jj + t) * TC + c] = sub_lazy(a, bw, two_q);
    }
    __syncthreads();
  }
  const long long tw0 = static_cast<long long>(br.limb) * R * C +
                        static_cast<long long>(br.j) * Cl + c0;
  uint32_t* ob = out + br.out_off;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int k1 = e / TC, c = e % TC;
    const long long off = tw0 + static_cast<long long>(k1) * C + c;
    const uint32_t v = mul_shoup_lazy(s[brev(k1, lg_r) * TC + c], tw[off], tws[off], q);
    ob[static_cast<long long>(k1) * Cl + c0 + c] = reduce_once(v, q);
  }
}

// Row phases: a tile of TR rows of the block's (Rl, C) slice, loaded
// bit-reversed, the C-point cyclic DIT with the stage-major table (the
// inverse's: then C^-1); canonical out, rows in place.
template <bool kInverse>
__global__ void ntt_row_kernel(const uint32_t* __restrict__ x,
                               uint32_t* __restrict__ out,
                               const uint32_t* __restrict__ st,
                               const uint32_t* __restrict__ sts,
                               const uint32_t* __restrict__ c_inv,
                               const uint32_t* __restrict__ c_inv_s,
                               const uint32_t* __restrict__ q_tab,
                               BlockGeom g, int C, int TR, int lg_c) {
  extern __shared__ uint32_t s[];
  const BlockRow br = block_row(blockIdx.x, g);
  const long long base = static_cast<long long>(blockIdx.y) * TR * C;
  const uint32_t q = q_tab[br.limb], two_q = q + q;
  const uint32_t* xb = x + br.in_off + base;
  const int n = TR * C;
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    s[(e / C) * C + brev(e % C, lg_c)] = xb[e];
  __syncthreads();
  const uint32_t* w = st + static_cast<long long>(br.limb) * (C - 1);
  const uint32_t* ws = sts + static_cast<long long>(br.limb) * (C - 1);
  const int hc = C / 2, half = TR * hc;
  for (int m = 1; m < C; m *= 2) {
    for (int f = threadIdx.x; f < half; f += blockDim.x) {
      const int r = f / hc, k = f % hc;
      const int i = k % m, jj = (k / m) * 2 * m + i;
      uint32_t* row = s + r * C;
      const uint32_t a = row[jj];
      const uint32_t bw = mul_shoup_lazy(row[jj + m], w[m - 1 + i], ws[m - 1 + i], q);
      row[jj] = add_lazy(a, bw, two_q);
      row[jj + m] = sub_lazy(a, bw, two_q);
    }
    __syncthreads();
  }
  uint32_t* ob = out + br.out_off + base;
  if (kInverse) {
    const uint32_t ci = c_inv[br.limb], cis = c_inv_s[br.limb];
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      ob[e] = reduce_once(mul_shoup_lazy(s[e], ci, cis, q), q);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x) ob[e] = reduce_once(s[e], q);
  }
}

// Inverse column phase: a tile of TC columns of the block's (R, Cl) slice,
// times the inverse twiddle of the block's columns on the way in (stored
// bit-reversed), the column iNTT (fused GS), then R^-1; canonical out.
__global__ void ntt_inv_col_kernel(const uint32_t* __restrict__ x,
                                   uint32_t* __restrict__ out,
                                   const uint32_t* __restrict__ col_wi,
                                   const uint32_t* __restrict__ col_wis,
                                   const uint32_t* __restrict__ twi,
                                   const uint32_t* __restrict__ twis,
                                   const uint32_t* __restrict__ r_inv,
                                   const uint32_t* __restrict__ r_inv_s,
                                   const uint32_t* __restrict__ q_tab,
                                   BlockGeom g, int R, int C, int Cl, int TC,
                                   int lg_r) {
  extern __shared__ uint32_t s[];
  const BlockRow br = block_row(blockIdx.x, g);
  const int c0 = blockIdx.y * TC;
  const uint32_t q = q_tab[br.limb], two_q = q + q;
  const uint32_t* xb = x + br.in_off;
  const long long tw0 = static_cast<long long>(br.limb) * R * C +
                        static_cast<long long>(br.j) * Cl + c0;
  const int n = R * TC;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int k1 = e / TC, c = e % TC;
    const long long off = tw0 + static_cast<long long>(k1) * C + c;
    s[brev(k1, lg_r) * TC + c] =
        mul_shoup_lazy(xb[static_cast<long long>(k1) * Cl + c0 + c], twi[off], twis[off], q);
  }
  __syncthreads();
  const uint32_t* w = col_wi + static_cast<long long>(br.limb) * R;
  const uint32_t* ws = col_wis + static_cast<long long>(br.limb) * R;
  const int half = (R / 2) * TC;
  for (int m = R, t = 1; m > 1; m /= 2, t *= 2) {
    const int h = m / 2;
    for (int f = threadIdx.x; f < half; f += blockDim.x) {
      const int c = f % TC, k = f / TC;
      const int i = k / t, jj = i * 2 * t + k % t;
      const uint32_t a = s[jj * TC + c], v = s[(jj + t) * TC + c];
      s[jj * TC + c] = add_lazy(a, v, two_q);
      s[(jj + t) * TC + c] = mul_shoup_lazy(sub_lazy(a, v, two_q), w[h + i], ws[h + i], q);
    }
    __syncthreads();
  }
  const uint32_t ri = r_inv[br.limb], ris = r_inv_s[br.limb];
  uint32_t* ob = out + br.out_off;
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    ob[static_cast<long long>(e / TC) * Cl + c0 + e % TC] =
        reduce_once(mul_shoup_lazy(s[e], ri, ris, q), q);
}

// The launch geometry of a phase: grid (block rows, tiles of one block).
struct PhasePlan {
  bool ok;
  BlockGeom g;
  long long rows;
  int tiles, tile;                         // tiles per block row, TC or TR
};

PhasePlan phase_plan(bool column, long long si, long long sj, long long sb,
                     long long sl, int lc, int cs, int B, int ell,
                     int limb_block, int R, int C) {
  PhasePlan p{};
  const bool pow2 = R >= 2 && C >= 2 && (R & (R - 1)) == 0 && (C & (C - 1)) == 0;
  p.ok = pow2 && lc > 0 && cs > 0 && B > 0 && ell > 0 && R % cs == 0 &&
         C % cs == 0 && R <= kPhaseWords && C <= kPhaseWords &&
         limb_block >= 0 && (limb_block == 0 || limb_block == ell);
  if (!p.ok) return p;
  const int width = column ? C / cs : C;   // words of a tile's row
  const int height = column ? R : R / cs;  // rows of the block
  if (column) {
    p.tile = width < kPhaseWords / R ? width : kPhaseWords / R;
    p.tiles = width / p.tile;
  } else {
    const int tr = kPhaseWords / C;
    p.tile = height < tr ? height : tr;
    p.tiles = height / p.tile;
  }
  p.rows = static_cast<long long>(lc) * cs * B * ell;
  p.ok = p.rows <= 0x7fffffffLL && p.tiles <= 65535;
  p.g = {si, sj, sb, sl, cs, B, ell, limb_block,
         static_cast<long long>(R) * C / cs};
  return p;
}

}  // namespace

// x, out (B, N) u32 with N = R*C and B a multiple of ell; clusters of
// `cluster` CTAs per row (1, 2, 4 or 8, at most R, N/cluster words fitting
// one CTA, N a multiple of 4*cluster^2 when cluster > 1); `staged`: copy the
// R + C - 1 column and row twiddle pairs to shared memory too; tables as in
// the header note.  Returns the CUDA error of a refused plan or launch.
extern "C" int ntt_fwd_launch(const void* x, void* out, const void* col_w,
                              const void* col_ws, const void* tw,
                              const void* tws, const void* st, const void* sts,
                              const void* q, int B, int ell, int R, int C,
                              int cluster, int staged, void* stream) {
  const NttTables tabs{
      static_cast<const uint32_t*>(col_w), static_cast<const uint32_t*>(col_ws),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tws),
      static_cast<const uint32_t*>(st), static_cast<const uint32_t*>(sts),
      static_cast<const uint32_t*>(q), nullptr, nullptr, nullptr, nullptr};
  return launch<true>(x, out, tabs, B, ell, R, C, cluster, staged, stream);
}

extern "C" int ntt_inv_launch(const void* x, void* out, const void* col_wi,
                              const void* col_wis, const void* twi,
                              const void* twis, const void* sti,
                              const void* stis, const void* r_inv,
                              const void* r_inv_s, const void* c_inv,
                              const void* c_inv_s, const void* q, int B,
                              int ell, int R, int C, int cluster, int staged,
                              void* stream) {
  const NttTables tabs{
      static_cast<const uint32_t*>(col_wi), static_cast<const uint32_t*>(col_wis),
      static_cast<const uint32_t*>(twi), static_cast<const uint32_t*>(twis),
      static_cast<const uint32_t*>(sti), static_cast<const uint32_t*>(stis),
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r_inv),
      static_cast<const uint32_t*>(r_inv_s), static_cast<const uint32_t*>(c_inv),
      static_cast<const uint32_t*>(c_inv_s)};
  return launch<false>(x, out, tabs, B, ell, R, C, cluster, staged, stream);
}


// The distributed four-step's phases on the blocks of a (limb, coef) mesh:
// x read through the strides (si, sj, sb, sl) of its (i, j, b, l) dims, the
// n_loc = R*C/cs words of a block row contiguous; out (lc, cs, B, ell,
// n_loc) contiguous.  Tables as in the header note, each phase its own.
#define PHASE_ARGS long long si, long long sj, long long sb, long long sl, \
    int lc, int cs, int B, int ell, int limb_block, int R, int C, void* stream

extern "C" int ntt_fwd_col_launch(const void* x, void* out, const void* col_w,
                                  const void* col_ws, const void* tw,
                                  const void* tws, const void* q, PHASE_ARGS) {
  const PhasePlan p = phase_plan(true, si, sj, sb, sl, lc, cs, B, ell, limb_block, R, C);
  if (!p.ok) return static_cast<int>(cudaErrorInvalidValue);
  ntt_fwd_col_kernel<<<dim3(static_cast<unsigned>(p.rows), p.tiles), repro::kThreads,
                       static_cast<size_t>(R) * p.tile * 4,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(col_w), static_cast<const uint32_t*>(col_ws),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tws),
      static_cast<const uint32_t*>(q), p.g, R, C, C / cs, p.tile, log2i(R));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ntt_fwd_row_launch(const void* x, void* out, const void* st,
                                  const void* sts, const void* q, PHASE_ARGS) {
  const PhasePlan p = phase_plan(false, si, sj, sb, sl, lc, cs, B, ell, limb_block, R, C);
  if (!p.ok) return static_cast<int>(cudaErrorInvalidValue);
  ntt_row_kernel<false><<<dim3(static_cast<unsigned>(p.rows), p.tiles), repro::kThreads,
                          static_cast<size_t>(C) * p.tile * 4,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(st), static_cast<const uint32_t*>(sts),
      nullptr, nullptr, static_cast<const uint32_t*>(q), p.g, C, p.tile, log2i(C));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ntt_inv_row_launch(const void* x, void* out, const void* sti,
                                  const void* stis, const void* c_inv,
                                  const void* c_inv_s, const void* q, PHASE_ARGS) {
  const PhasePlan p = phase_plan(false, si, sj, sb, sl, lc, cs, B, ell, limb_block, R, C);
  if (!p.ok) return static_cast<int>(cudaErrorInvalidValue);
  ntt_row_kernel<true><<<dim3(static_cast<unsigned>(p.rows), p.tiles), repro::kThreads,
                         static_cast<size_t>(C) * p.tile * 4,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(sti), static_cast<const uint32_t*>(stis),
      static_cast<const uint32_t*>(c_inv), static_cast<const uint32_t*>(c_inv_s),
      static_cast<const uint32_t*>(q), p.g, C, p.tile, log2i(C));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ntt_inv_col_launch(const void* x, void* out, const void* col_wi,
                                  const void* col_wis, const void* twi,
                                  const void* twis, const void* r_inv,
                                  const void* r_inv_s, const void* q, PHASE_ARGS) {
  const PhasePlan p = phase_plan(true, si, sj, sb, sl, lc, cs, B, ell, limb_block, R, C);
  if (!p.ok) return static_cast<int>(cudaErrorInvalidValue);
  ntt_inv_col_kernel<<<dim3(static_cast<unsigned>(p.rows), p.tiles), repro::kThreads,
                       static_cast<size_t>(R) * p.tile * 4,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(col_wi), static_cast<const uint32_t*>(col_wis),
      static_cast<const uint32_t*>(twi), static_cast<const uint32_t*>(twis),
      static_cast<const uint32_t*>(r_inv), static_cast<const uint32_t*>(r_inv_s),
      static_cast<const uint32_t*>(q), p.g, R, C, C / cs, p.tile, log2i(R));
  return static_cast<int>(cudaGetLastError());
}
#undef PHASE_ARGS
