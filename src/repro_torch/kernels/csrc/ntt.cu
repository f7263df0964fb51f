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
// dataflow at its one exchange, the paper's §III-B shuffle, into four phases
// that run on every block of a (limb, coef) mesh of logical shards in one
// launch each (the reference's shard bodies,
// src/repro/core/distributed.py:631-660, which cut ntt_pallas's _fwd_body /
// _inv_body in two), built from two kernels:
//
//   ntt_col_phase_kernel<true>: on a block's column slice (R, C/cs), the
//            R-point column NTT, then its twiddle columns psi^{(2k1+1)n2};
//   ntt_row_phase_kernel<true>: on a block's row slice (R/cs, C), the
//            C-point cyclic row DFT;
//   ntt_row_phase_kernel<false>: the inverse row DFT, then C^-1;
//   ntt_col_phase_kernel<false>: the inverse twiddle columns, then the
//            column iNTT with its R^-1.
//
// Each phase ends fully reduced, so whatever the exchange does to the order
// of its chunks, the next phase reads canonical residues.  A block is
// addressed as (i, j, b, l): limb cluster i, core j of the cluster, batch
// row b and local limb l; the input is read through four strides (a view of
// the global tensor, or the exchange's buffer; the n_loc words of a block
// row are contiguous) and the output written contiguous (lc, cs, B, ell,
// n_loc).  Limb l of cluster i uses table row i*limb_block + l (limb_block =
// 0: every cluster holds all limbs).
//
// Bound on the H100: bytes.  A row phase moves its data in and out once
// (the C - 1 stage pairs per limb are noise); a column phase also the
// twiddle columns of its limbs, (R, C) words twice (w and w'), which at
// B = 2 are half as many bytes as the data.  Each phase does the butterflies
// of half a transform, about 10 integer operations per byte it must move.
//
// Design.  A CTA holds one tile of one batch row of one limb of one block in
// shared memory: R x TC whole columns (TC = 16 at R = 256) or TR x C whole
// rows (TR = 16 at C = 256), 4096 words; kernels/ntt/ops.py:phase_plan
// picks the tile (narrower where a launch would leave SMs idle).  It runs
// the one-pass kernel's column or row half on that tile with the same
// device functions (col_pass, row_pass, local_stages).  Against what held
// the first phase kernels back:
//   - integer division in every index: every size is a power of two passed
//     as its logarithm, every index a shift, a mask or a bit reversal
//     (__brev); the block, limb, tile and batch row come from the grid
//     position once per CTA (one division by B); at C = 256 and TR = 16 the
//     row kernel is built for that geometry and its indices fold to
//     constants;
//   - one butterfly per thread per stage, then a barrier: each thread holds
//     16 words of a column or row in registers and runs four radix-2 stages
//     between barriers (R = 256: two barriers, not eight);
//   - two global loads for every stage twiddle: the limb's R column pairs or
//     C - 1 row pairs sit in shared memory as (w, w') pairs, one 8-byte load
//     per butterfly;
//   - the twiddle columns re-read for every batch row: the column phase
//     copies its tile's twiddle columns to shared memory (two planes, read
//     32 consecutive words a warp), and the B CTAs of a tile are neighbours
//     in the grid, so all but the first can find the columns in L2.  (A CTA
//     that looped over the B rows, with or without prefetching the next
//     row's tile, was as fast or up to 19 % slower on the H100 at B = 2 and
//     8, measured on an earlier build of these kernels: the CTAs of a tile
//     hid each other's loads better than one CTA's loop);
//   - bank conflicts where the order bit-reverses: the column phase gathers
//     slice row brev(p) into tile row p, so its tile is written in order and
//     its swizzle (ColTile) only has to serve the passes; the row tile's
//     swizzle (RowTile) also spreads a warp that walks a row in bit-reversed
//     order (the forward's store, the inverse's load) over 32 banks.
// Every word a CTA reads from device memory arrives by cp.async (16 bytes at
// a time for the column tile and the twiddle columns), all of a thread's
// copies in flight before it waits and no registers held for them; results
// leave by 16-byte stores.
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
template <int K, bool kForward, int NT, class T, class L>
__device__ __forceinline__ void col_pass(const T& t, const L& l, int b0,
                                         bool tw_too) {
  constexpr int E = 1 << K;
  const int C = 1 << t.lg_c;
  const int groups = 1 << (t.lg_rl + t.lg_c - K);
  for (int g = threadIdx.x; g < groups; g += NT) {
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
template <int K, bool kForward, int NT, class T, class L>
__device__ __forceinline__ void row_pass(const T& t, const L& l, int b0) {
  constexpr int E = 1 << K;
  const int Rl = 1 << t.lg_rl;
  const int groups = 1 << (t.lg_rl + t.lg_c - K);
  for (int g = threadIdx.x; g < groups; g += NT) {
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

template <bool kForward, int K, int NT, class T, class L>
__device__ __forceinline__ void run_pass(bool col, const T& t, const L& l,
                                         int b0, bool tw_too) {
  if (col) col_pass<K, kForward, NT>(t, l, b0, tw_too);
  else row_pass<K, kForward, NT>(t, l, b0);
}

// Stages on bits [0, bits) of the column (col) or row index, in passes of
// at most kMaxRadixLog bits of near-equal size: upwards for a DIT, downwards
// for a DIF/GS, with a barrier after each pass.  `tw_first` / `tw_last`: the
// twiddle product in the first / last column pass.  NT threads share a tile
// of type T (its `at` places word x of local row pl).
template <bool kForward, int NT = kNttThreads, class T, class L>
__device__ __forceinline__ void local_stages(bool col, int bits, const T& t,
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
      case 1: run_pass<kForward, 1, NT>(col, t, l, b0, tw_too); break;
      case 2: run_pass<kForward, 2, NT>(col, t, l, b0, tw_too); break;
      case 3: run_pass<kForward, 3, NT>(col, t, l, b0, tw_too); break;
      default: run_pass<kForward, 4, NT>(col, t, l, b0, tw_too); break;
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

constexpr int kPhaseMaxSide = 4096;        // the largest R and C of a phase launch
constexpr int kTileWords = 4096;           // words of a phase's tile, at most
// Threads of a column phase's CTA (16 words each in a radix-16 pass of a
// 4096-word tile) and of a row phase's (32): of 128 and 256 for each, timed
// on the H100 at (4, 4, B, 12, N/4) blocks, these were the faster at B = 1
// and 2 (the column's within 5 % of 128 threads at B = 8).
constexpr int kColThreads = 256;
constexpr int kRowThreads = 128;

// A column phase's tile of R rows of TC words: word w = p*TC + x of the
// 32-word line L = w >> 5 lives at w ^ H(L), H(L) = (L >> sh) << (sh + 1)
// masked to bits 2-4, sh = max(lg_c - 1, 0).  H moves whole 16-byte chunks
// (the tile is loaded and stored 16 bytes at a time) and sends the line bits
// that a warp varies in a radix-16 column pass above the pass's 16 rows onto
// the bank bits that TC < 32 leaves constant, so a pass reaches 32 banks
// (every access conflict-free for R = 128 and 256 at TC >= 4, by a count of
// banks per warp).  At TC >= 32, H is 0: a warp walks along one row.
struct ColTile {
  uint32_t* s;
  int lg_rl, lg_c, sh;
  __device__ __forceinline__ int at(int p, int x) const {
    const int w = (p << lg_c) | x;
    return w ^ (((w >> 5 >> sh) << (sh + 1)) & 28);
  }
};

// A row phase's tile of TR rows of C words: word x of row pl lives at
// pl*C + (x ^ ((pl ^ (x >> sh)) & key)), sh = max(5, lg_c - 5).  The pl term
// spreads a warp that walks down a column (the row passes, lanes on rows)
// over 32 banks as the one-pass Tile does; the x >> sh term spreads one that
// walks along a row in bit-reversed order (the inverse's load, the forward's
// store), whose 32 words differ only in the bits above sh.  A tile of 16
// rows leaves the lanes 16 rows, and one of C = 256's two passes 2-way
// conflicts; 32-row tiles (twice the shared memory) were slower on the H100.
struct RowTile {
  uint32_t* s;
  int lg_rl, lg_c, key, sh;
  __device__ __forceinline__ int at(int pl, int x) const {
    return (pl << lg_c) | (x ^ ((pl ^ (x >> sh)) & key));
  }
};

// A phase launch over every block: grid (tiles * B, ell, lc * cs), each CTA
// one tile of one batch row of one limb of one block.  The B CTAs of a tile
// are neighbours in the grid, so they run together and all but the first
// can find the tile's tables in L2.  Every size but B and ell is a power of
// two and passed as its logarithm.
struct PhaseGeom {
  long long si, sj, sb, sl;                // input strides of (i, j, b, l)
  long long n_loc;                         // words of a block row
  int B, ell, limb_block, vec;             // vec: 16-byte global accesses
  int lg_cs, lg_r, lg_c;                   // blocks per limb cluster, R, C
  int lg_span, lg_tile;                    // the tiled side of a block slice (C/cs
                                           // or R/cs) and a tile's share of it
};

struct PhaseCta {
  int i, j, l, limb, tile, b;
};

// The CTA's block, limb, tile and batch row, from its grid position.
__device__ __forceinline__ PhaseCta phase_cta(const PhaseGeom& g) {
  PhaseCta c;
  c.tile = static_cast<int>(blockIdx.x) / g.B;
  c.b = static_cast<int>(blockIdx.x) - c.tile * g.B;
  c.l = static_cast<int>(blockIdx.y);
  c.j = static_cast<int>(blockIdx.z) & ((1 << g.lg_cs) - 1);
  c.i = static_cast<int>(blockIdx.z) >> g.lg_cs;
  c.limb = c.i * g.limb_block + c.l;
  return c;
}

__device__ __forceinline__ long long in_offset(const PhaseGeom& g, const PhaseCta& c) {
  return c.i * g.si + c.j * g.sj + c.b * g.sb + c.l * g.sl;
}

// Block row (i, j, b, l) of the contiguous (lc, cs, B, ell, n_loc) output.
__device__ __forceinline__ long long out_offset(const PhaseGeom& g, const PhaseCta& c) {
  const long long block = (static_cast<long long>(c.i) << g.lg_cs) | c.j;
  return ((block * g.B + c.b) * g.ell + c.l) * g.n_loc;
}

// Asynchronous copies from device to shared memory (cp.async): a thread
// issues all of its words of a tile and of its tables before it waits, and
// they take no registers on the way.  copy_wait: this thread's copies have
// landed (a barrier after it makes everyone's visible).
__device__ __forceinline__ void copy_async4(uint32_t* dst, const uint32_t* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async16(uint32_t* dst, const uint32_t* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The limb's n stage pairs (w, w') to shared memory, asynchronously.
template <int NT>
__device__ __forceinline__ void stage_pairs(uint2* dst, const uint32_t* __restrict__ w,
                                            const uint32_t* __restrict__ ws, int n) {
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  for (int i = threadIdx.x; i < n; i += NT) {
    copy_async4(d + 2 * i, w + i);
    copy_async4(d + 2 * i + 1, ws + i);
  }
}

// Words e .. e+3 of a tile (four per thread and step) to device memory at
// offsets addr(e + k): one 16-byte store when vec (four words of one tile
// row, 16-byte aligned), else word by word, words from `words` on skipped.
template <class A>
__device__ __forceinline__ void tile_store4(const uint32_t (&v)[4], uint32_t* __restrict__ dst,
                                            int e, int words, bool vec, A addr) {
  if (vec) {
    *reinterpret_cast<uint4*>(dst + addr(e)) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (e + k < words) dst[addr(e + k)] = v[k];
}

// A column phase's limb: its column pairs and, in shared memory, the tile's
// twiddle columns as two planes (w, w') of R x TC words.
struct ColLimb : Limb<true> {
  const uint32_t *tw_w, *tw_s;
  int lg_tc;
};

// The twiddle product of a column phase (col_pass with tw_too): forward
// psi^{(2k1+1)n2}, inverse psi^{-(2k1+1)n2}, from the staged planes (a warp
// reads 32 consecutive words of each).
template <bool kForward>
__device__ __forceinline__ uint32_t twiddle(uint32_t v, const ColLimb& l, int k1, int c,
                                            int) {
  const int i = (k1 << l.lg_tc) | c;
  return mul_shoup_lazy(v, l.tw_w[i], l.tw_s[i], l.q);
}

// Column phases: a tile of TC columns of a block's (R, Cl = C/cs) slice for
// the R-point column transform, the one-pass kernel's column half at one CTA
// per limb (col_pass: up to 16 words a thread, four stages per barrier).
//   forward: tile row p <- slice row n1 = brev(p), DIT -> natural k1 = p,
//            times the twiddle of columns j*Cl + c0 + c on the way out (in
//            the last pass it would cost 64 registers' worth of spills);
//   inverse: tile row p <- slice row k1 = p, times the inverse twiddle in
//            the first pass (col_pass's tw_too), GS -> n1 = brev(p), times
//            R^-1 on the way out to row brev(p).
// Every word the CTA reads from device memory arrives by cp.async: the
// limb's R column pairs, the tile's twiddle columns and the tile.
template <bool kForward>
__global__ void __launch_bounds__(kColThreads, 1024 / kColThreads)
ntt_col_phase_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ col_w, const uint32_t* __restrict__ col_ws,
                     const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tws,
                     const uint32_t* __restrict__ scale, const uint32_t* __restrict__ scale_s,
                     const uint32_t* __restrict__ q_tab, PhaseGeom g) {
  extern __shared__ __align__(16) uint32_t smem[];
  const PhaseCta c = phase_cta(g);
  constexpr int NT = kColThreads;
  const int lg_r = g.lg_r, lg_tc = g.lg_tile, TC = 1 << lg_tc;
  const int words = 1 << (lg_r + lg_tc);
  uint32_t* tw_w = smem + words;
  uint32_t* tw_s = tw_w + words;
  uint2* pairs = reinterpret_cast<uint2*>(tw_s + words);
  const long long limb = c.limb;
  const int c0 = c.tile << lg_tc;
  const ColTile t{smem, lg_r, lg_tc, max(lg_tc - 1, 0)};
  // word e of the tile: its row p, column c0 + (e mod TC) of slice row p
  // (natural) or brev(p)
  const auto natural = [&](int e) {
    return (static_cast<long long>(e >> lg_tc) << g.lg_span) + c0 + (e & (TC - 1));
  };
  const auto reversed = [&](int e) {
    return (static_cast<long long>(brev(e >> lg_tc, lg_r)) << g.lg_span) + c0 +
           (e & (TC - 1));
  };
  stage_pairs<NT>(pairs, col_w + (limb << lg_r), col_ws + (limb << lg_r), 1 << lg_r);
  {
    // the tile's twiddle columns: rows k1 of the limb's (R, C) table,
    // columns j*Cl + c0 ...
    const long long base = (limb << (lg_r + g.lg_c)) +
                           (static_cast<long long>(c.j) << g.lg_span) + c0;
    const int step = g.vec ? 4 : 1;
    for (int e = step * threadIdx.x; e < words; e += step * NT) {
      const long long off = base + (static_cast<long long>(e >> lg_tc) << g.lg_c) + (e & (TC - 1));
      if (g.vec) {
        copy_async16(tw_w + e, tw + off);
        copy_async16(tw_s + e, tws + off);
      } else {
        copy_async4(tw_w + e, tw + off);
        copy_async4(tw_s + e, tws + off);
      }
    }
  }
  const uint32_t* src = x + in_offset(g, c);
  if (g.vec) {
    for (int e = 4 * threadIdx.x; e < words; e += 4 * NT)
      copy_async16(t.s + t.at(e >> lg_tc, e & (TC - 1)), src + (kForward ? reversed(e) : natural(e)));
  } else {
    for (int e = threadIdx.x; e < words; e += NT)
      copy_async4(t.s + t.at(e >> lg_tc, e & (TC - 1)), src + (kForward ? reversed(e) : natural(e)));
  }
  ColLimb l{};
  l.col = l.row = pairs;
  l.q = __ldg(q_tab + limb);
  l.two_q = l.q + l.q;
  l.tw_w = tw_w;
  l.tw_s = tw_s;
  l.lg_tc = lg_tc;
  const uint32_t sc = kForward ? 0u : __ldg(scale + limb);
  const uint32_t sc_s = kForward ? 0u : __ldg(scale_s + limb);
  copy_wait();
  __syncthreads();
  local_stages<kForward, NT>(true, lg_r, t, l, !kForward, false);
  uint32_t* dst = out + out_offset(g, c);
  for (int e = 4 * threadIdx.x; e < words; e += 4 * NT) {
    uint32_t v[4];
    if (g.vec) {                           // a 16-byte chunk of the tile and planes
      const uint4 u = *reinterpret_cast<const uint4*>(t.s + t.at(e >> lg_tc, e & (TC - 1)));
      v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = e + k < words ? t.s[t.at((e + k) >> lg_tc, (e + k) & (TC - 1))] : 0u;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = reduce_once(kForward ? mul_shoup_lazy(v[k], tw_w[e + k], tw_s[e + k], l.q)
                                  : mul_shoup_lazy(v[k], sc, sc_s, l.q), l.q);
    if (kForward) tile_store4(v, dst, e, words, g.vec, natural);
    else tile_store4(v, dst, e, words, g.vec, reversed);
  }
}

// Row phases: a tile of TR rows of a block's (R/cs, C) slice, contiguous in
// device memory, for the C-point cyclic row DFT, the one-pass kernel's row
// half (row_pass, lanes on rows).  Forward: DIF on natural input, the
// bit-reversed result read back in order at the store.  Inverse: the input
// stored bit-reversed, DIT to natural order, then C^-1.  The limb's C - 1
// stage pairs and the tile arrive by cp.async.
template <bool kForward, int kLgC, int kLgTr>
__global__ void __launch_bounds__(kRowThreads, 1024 / kRowThreads)
ntt_row_phase_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                     const uint32_t* __restrict__ st, const uint32_t* __restrict__ sts,
                     const uint32_t* __restrict__ scale, const uint32_t* __restrict__ scale_s,
                     const uint32_t* __restrict__ q_tab, PhaseGeom g) {
  extern __shared__ __align__(16) uint32_t smem[];
  const PhaseCta c = phase_cta(g);
  constexpr int NT = kRowThreads;
  // the geometry, compile-time where the kernel is built for it (kLgC > 0)
  const int lg_c = kLgC ? kLgC : g.lg_c, lg_tr = kLgC ? kLgTr : g.lg_tile, C = 1 << lg_c;
  const int lg_words = lg_tr + lg_c, words = 1 << lg_words;
  uint2* pairs = reinterpret_cast<uint2*>(smem + words);
  const long long limb = c.limb;
  const RowTile t{smem, lg_tr, lg_c, min(C, 32) - 1, max(5, lg_c - 5)};
  const long long base = static_cast<long long>(c.tile) << lg_words;
  stage_pairs<NT>(pairs, st + limb * (C - 1), sts + limb * (C - 1), C - 1);
  const uint32_t* src = x + in_offset(g, c) + base;
  for (int e = threadIdx.x; e < words; e += NT) {
    const int xc = e & (C - 1);
    copy_async4(t.s + t.at(e >> lg_c, kForward ? xc : brev(xc, lg_c)), src + e);
  }
  Limb<true> l{};
  l.col = l.row = pairs;
  l.q = __ldg(q_tab + limb);
  l.two_q = l.q + l.q;
  const uint32_t sc = kForward ? 0u : __ldg(scale + limb);
  const uint32_t sc_s = kForward ? 0u : __ldg(scale_s + limb);
  copy_wait();
  __syncthreads();
  local_stages<kForward, NT>(false, lg_c, t, l, false, false);
  uint32_t* dst = out + out_offset(g, c) + base;
  const auto contiguous = [](int e) { return static_cast<long long>(e); };
  for (int e = 4 * threadIdx.x; e < words; e += 4 * NT) {
    uint32_t v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (e + k >= words) break;
      const int xc = (e + k) & (C - 1);
      const uint32_t u = t.s[t.at((e + k) >> lg_c, kForward ? brev(xc, lg_c) : xc)];
      v[k] = reduce_once(kForward ? u : mul_shoup_lazy(u, sc, sc_s, l.q), l.q);
    }
    tile_store4(v, dst, e, words, g.vec, contiguous);
  }
}

// A checked phase launch: its geometry, grid and dynamic shared memory.
struct PhaseLaunch {
  bool ok;
  PhaseGeom g;
  dim3 grid;
  int smem;
};

bool pow2(long long v) { return v >= 1 && (v & (v - 1)) == 0; }

// The launch of a phase at the wrapper's plan (tile: TC columns of a column
// slice or TR rows of a row slice), or ok = false where the shapes or the
// plan do not fit.
PhaseLaunch phase_launch(bool column, const void* x, const void* out,
                         const void* tw, const void* tws, long long si,
                         long long sj, long long sb, long long sl, int lc, int cs,
                         int B, int ell, int limb_block, int R, int C, int tile) {
  PhaseLaunch p{};
  if (!(pow2(R) && pow2(C) && R >= 2 && C >= 2 && R <= kPhaseMaxSide &&
        C <= kPhaseMaxSide && pow2(cs) && R % cs == 0 && C % cs == 0 && lc > 0 &&
        B > 0 && ell > 0 && (limb_block == 0 || limb_block == ell)))
    return p;
  const int span = column ? C / cs : R / cs;        // the tiled side of a block slice
  const int other = column ? R : C;
  const long long words = static_cast<long long>(other) * tile;
  if (!(pow2(tile) && tile <= span && words <= kTileWords))
    return p;
  const long long ctas = static_cast<long long>(span / tile) * B;
  if (ctas > 0x7fffffffLL || ell > 65535 || static_cast<long long>(lc) * cs > 65535)
    return p;
  p.smem = static_cast<int>(column ? words * 12 + other * 8LL : words * 4 + (C - 1) * 8LL);
  if (p.smem > repro::kMaxSmemPerCta) return p;
  const long long n_loc = static_cast<long long>(R) * C / cs;
  const bool vec = (column ? tile % 4 == 0 : C % 4 == 0) && n_loc % 4 == 0 &&
                   si % 4 == 0 && sj % 4 == 0 && sb % 4 == 0 && sl % 4 == 0 &&
                   repro::aligned16(x) && repro::aligned16(out) &&
                   repro::aligned16(tw) && repro::aligned16(tws);
  p.g = {si, sj, sb, sl, n_loc, B, ell, limb_block, vec ? 1 : 0,
         log2i(cs), log2i(R), log2i(C), log2i(span), log2i(tile)};
  p.grid = dim3(static_cast<unsigned>(ctas), static_cast<unsigned>(ell),
                static_cast<unsigned>(lc * cs));
  p.ok = true;
  return p;
}

// The dynamic shared memory a phase kernel may take on each device so far.
struct SmemAllowance {
  int bytes[repro::kMaxDevices];
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, SmemAllowance& a, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= repro::kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > a.bytes[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    a.bytes[dev] = smem;
  }
  return cudaSuccess;
}

template <bool kForward>
int col_phase(const void* x, void* out, const void* col_w, const void* col_ws,
              const void* tw, const void* tws, const void* scale, const void* scale_s,
              const void* q, long long si, long long sj, long long sb, long long sl,
              int lc, int cs, int B, int ell, int limb_block, int R, int C, int tile,
              void* stream) {
  const PhaseLaunch p = phase_launch(true, x, out, tw, tws, si, sj, sb, sl, lc, cs, B, ell,
                                     limb_block, R, C, tile);
  if (!p.ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = ntt_col_phase_kernel<kForward>;
  static SmemAllowance allowance;
  cudaError_t err = allow_smem(kernel, allowance, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.grid, kColThreads, static_cast<size_t>(p.smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(col_w), static_cast<const uint32_t*>(col_ws),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tws),
      static_cast<const uint32_t*>(scale), static_cast<const uint32_t*>(scale_s),
      static_cast<const uint32_t*>(q), p.g);
  return static_cast<int>(cudaGetLastError());
}

// A row phase at C = 256 with 16-row tiles (N = 2^16 at every block size)
// runs the kernel built for that geometry: its passes' indices fold to
// constants (4-19 % faster than the general build on the H100 at B = 1, 2
// and 8).
template <bool kForward>
int row_phase(const void* x, void* out, const void* st, const void* sts,
              const void* scale, const void* scale_s, const void* q, long long si,
              long long sj, long long sb, long long sl, int lc, int cs, int B, int ell,
              int limb_block, int R, int C, int tile, void* stream) {
  const PhaseLaunch p = phase_launch(false, x, out, nullptr, nullptr, si, sj, sb, sl, lc, cs,
                                     B, ell, limb_block, R, C, tile);
  if (!p.ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool built = p.g.lg_c == 8 && p.g.lg_tile == 4;
  const auto kernel = built ? ntt_row_phase_kernel<kForward, 8, 4>
                            : ntt_row_phase_kernel<kForward, 0, 0>;
  static SmemAllowance allowance[2];
  cudaError_t err = allow_smem(kernel, allowance[built], p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<p.grid, kRowThreads, static_cast<size_t>(p.smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(st), static_cast<const uint32_t*>(sts),
      static_cast<const uint32_t*>(scale), static_cast<const uint32_t*>(scale_s),
      static_cast<const uint32_t*>(q), p.g);
  return static_cast<int>(cudaGetLastError());
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
// n_loc) contiguous.  Tables as in the header note, each phase its own;
// tile the wrapper's plan (repro_torch.kernels.ntt.ops.phase_plan).
#define PHASE_ARGS long long si, long long sj, long long sb, long long sl, int lc, \
    int cs, int B, int ell, int limb_block, int R, int C, int tile, void* stream
#define PHASE_PASS si, sj, sb, sl, lc, cs, B, ell, limb_block, R, C, tile, stream

extern "C" int ntt_fwd_col_launch(const void* x, void* out, const void* col_w,
                                  const void* col_ws, const void* tw,
                                  const void* tws, const void* q, PHASE_ARGS) {
  return col_phase<true>(x, out, col_w, col_ws, tw, tws, nullptr, nullptr, q, PHASE_PASS);
}

extern "C" int ntt_fwd_row_launch(const void* x, void* out, const void* st,
                                  const void* sts, const void* q, PHASE_ARGS) {
  return row_phase<true>(x, out, st, sts, nullptr, nullptr, q, PHASE_PASS);
}

extern "C" int ntt_inv_row_launch(const void* x, void* out, const void* sti,
                                  const void* stis, const void* c_inv,
                                  const void* c_inv_s, const void* q, PHASE_ARGS) {
  return row_phase<false>(x, out, sti, stis, c_inv, c_inv_s, q, PHASE_PASS);
}

extern "C" int ntt_inv_col_launch(const void* x, void* out, const void* col_wi,
                                  const void* col_wis, const void* twi,
                                  const void* twis, const void* r_inv,
                                  const void* r_inv_s, const void* q, PHASE_ARGS) {
  return col_phase<false>(x, out, col_wi, col_wis, twi, twis, r_inv, r_inv_s, q, PHASE_PASS);
}
#undef PHASE_PASS
#undef PHASE_ARGS
