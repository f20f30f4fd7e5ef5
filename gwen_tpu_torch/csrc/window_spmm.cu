// Windowed SpMM for the diag-window (B1, B4), banded (B3, B10), bit-packed
// (packed B1 and B4, B13), windowed-dense (B11), blocked-ELL (B12) and
// block-tile (B14) layouts.
//
// Which kernel computes which form:
//   dense_row1_kernel    batch 1 on a dense S: B1 (_diag_kernel through
//                        _diag_impl) with its escape fix rows, B1 on a runtime
//                        S (diag_matvec's forward), B3 (_sliding_kernel
//                        through _sliding_impl) at every width, the esc2
//                        contraction's 384 columns among them, B11, and B4
//                        and B10 called with one item;
//   dense_rows_kernel    a batch of two or more: B4 (_diag_kernel_b through
//                        _diag_impl_b) with its fix rows, B10
//                        (_sliding_kernel_b through _sliding_impl_b) at every
//                        width, B11 (_sdense_kernel through _sdense_impl);
//   packed_row1_kernel   batch 1 on the S01 bits: packed B1 (the packed branch
//                        of _diag_kernel) with its fix rows, B13 unbatched;
//   packed_rows_kernel   a batch of two or more: packed B4 (the packed branch
//                        of _diag_kernel_b), B13 (_sliding_packed_kernel
//                        through _sliding_packed_impl);
//   ell_spmm_kernel      B12 (_kernel through _spmm_impl);
//   tile_walk_kernel     B14 (_tile_kernel through _spmm_tiles_impl) with
//                        one item;
//   tile_list_kernel     B14 on a batch: the row's live slots listed once,
//                        then gathered for each item.
// Each has its section below, with what bounds it and what its design does
// about that.
//
// Operand modes of the dense S (the dtype code of the entry points): S in
// x's type (0 float32, 1 bfloat16); a float32 x on a bfloat16 S (2), as the
// reference's kernels take it (S cast to x's type per tile; bf16 -> float32
// is exact): S is read as bf16 and widened as it is read; a bfloat16 x on a
// float32 S (3), each nonzero rounded to bf16 as the reference's kernel
// casts its tile; a float32 or bfloat16 x on an int8 S (4, 5): the 0/1
// pattern of a rank-1 banded layout (half the bytes of a bf16 S), read as
// int8. The int8 rank-1 form of B3 and B10 (gwen_tpu/ops/spmm_pallas.py:
// spmm_sliding_rank1, a . K(a . x) with K on the int8 S01) is the SCALES
// instantiation of the dense gathers in modes 4 and 5: each nonzero weighs
// its source's column scale and the sum its row's scale, both rounded to x's
// type, before the one rounding, as the packed gathers weigh their set bits
// (entry gwen_rank1_spmm).
//
// Plain C interface, loaded with ctypes (gwen_tpu_torch/ops/spmm_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A scale as the kernels use it: rounded to the input type, then float32.
template <typename T>
__device__ __forceinline__ float scale_at(const float* v, int64_t i) {
  return to_f32(from_f32<T>(v[i]));
}

// S as it lies in memory for an x of type T: T itself, bf16 under a float32
// x (MIXED = 1), float32 under a bf16 x (MIXED = 2) or int8 (MIXED = 3).
template <typename T, int MIXED>
using s_type = typename std::conditional<
    MIXED == 1, __nv_bfloat16,
    typename std::conditional<
        MIXED == 2, float,
        typename std::conditional<MIXED == 3, int8_t, T>::type>::type>::type;

}  // namespace

// ------------------------------------------------------------ row gathers
//
// B1 and B4, weighted and packed, replacing
// gwen_tpu/ops/spmm_pallas.py:_diag_kernel (through _diag_impl) and
// _diag_kernel_b (through _diag_impl_b), both branches of their `packed`
// flag; B1 on a runtime S (diag_matvec's forward); B3 and B10, replacing
// _sliding_kernel (through _sliding_impl) and _sliding_kernel_b (through
// _sliding_impl_b), weighted and in their int8 rank-1 form; B13, replacing
// _sliding_packed_kernel (through _sliding_packed_impl); and B11, replacing
// _sdense_kernel (through _sdense_impl). The TPU kernels multiply the whole
// window on the MXU because they cannot gather rows, and at L7 a row holds
// about 7 nonzeros of a window of 384 (KD order: B1, B4; B3 and B10 on the
// esc2 graph hold 2), 1,664 (B11, B3 and B10 on an RCM band) or 1,792 (B13)
// columns, so > 98 % of those products are on zeros. The math is the
// gather-scale-sum of B12,
//   dense:  acc[i] = sum_{c < W, S[i, c] != 0} T(S[i, c]) * x[ws + c]
//   packed, and rank-1 on an int8 S01 (SCALES):
//           acc[i] = sum_{S01[i, c] != 0} T(a_s[ws + c]) * x[ws + c]
//   acc[i] += fix[j]  if esc_rows[j] == i, j in [esc_ptr[b], esc_ptr[b+1])
//   out[i] = round(acc[i] * (packed or SCALES ? T(a_r[i]) : 1))
// with b = i / block and ws = window_start[b] (the graph's own block size;
// B11's starts are absolute and need not be monotone), float32 sums in
// ascending column order, the fix added before the row scale (the escape
// tables of packed graphs carry w = a_s), one rounding, and sources at or
// past x_rows read as zero. T() rounds to x's type first, as the reference
// casts its tile. A row with no nonzero and no escape writes zeros. A call
// with one item and one with several compute the same sums in the same
// order.
//
// The design: one warp per destination row, which walks the nonzeros
// instead of the window. The packed gathers read the row's W / 32 bit words
// once, one word a lane (12 at L7 on the diag layout, 56 on the band); the
// dense gathers stream the S row once with coalesced 16-byte loads,
// evict-first (48 vectors of bf16 S on the diag layout, 208 on the band),
// and a lane masks its vectors' nonzeros. No product is taken on a zero. The
// escape epilogue (HAS_ESC) finds the row's slot once: a block's receivers
// are unique and sorted (about 8 a block at L7), and the warp compares 32
// of them a round with one ballot; the row's fix row is then added like one
// more nonzero of weight 1.
//
// A batch of two or more (dense_rows_kernel, packed_rows_kernel): a ballot
// picks the lanes (words, vectors) with a nonzero; the warp walks them in
// ascending order, broadcasts each one's word or vector with shuffles and
// walks its nonzeros. Each nonzero's x row is read with one 16-byte load a
// lane for every batch item, up to four issued together, so the bits,
// scales and S are decoded once for a batch of up to four, not once per
// item, and S leaves device memory once (a larger batch, or F over one pass
// of 32 vectors, 256 bf16 or 128 float32 values, decodes the row again per
// group of four and per pass, mostly from L2). The escape instantiations
// take more registers a thread than the others, so fewer CTAs fit an SM;
// capping them with launch bounds trades that for spills and was not faster
// at every batch size.
//
// One item (dense_row1_kernel, packed_row1_kernel): walked as above, a lane
// would hold one 16-byte load in flight per nonzero and wait a full L2
// latency for each of the row's ~7. So the walk lists first, then gathers:
//   1. list: each lane takes K consecutive S vectors (or KW bit words) of a
//      round of the row, masks their nonzeros (those with a source below
//      x_rows), and the warp writes them to its list in shared memory in
//      ascending column order, the column and, for a dense S, the weight
//      (an inclusive scan of each lane's popcount over the lanes gives each
//      lane its first slot; a round with no nonzero is skipped on a ballot);
//   2. gather: the warp takes the list 8 entries at a time; each lane copies
//      the 8 x rows' 16-byte column slices into its staging slots in shared
//      memory at once (cp.async: in flight without holding registers, so
//      more warps fit an SM) and, packed or SCALES, loads their column
//      scales, then adds them in list order.
// K and KW are chosen per launch so that one round covers the diag layout's
// row (two bf16 vectors or one word a lane) and few the RCM band's (four
// vectors or two words a lane): the decode work a round costs grows with
// K, the scan and list work with the rounds. A list holds LIST entries; a
// row with more (a hub) gathers whenever it fills, so the order of
// summation stays ascending. A warp walks ROWS1 consecutive rows and loads
// the next row's S vectors or words while it gathers the current one's;
// the escape slot search loads its first receivers before the list is
// built and resolves after it, and the fix row is loaded with the gathers.
//
// What bounds it: bytes. The packed gathers read the bits (7.9 MB on the L7
// diag layout, 35 MB on the band), the scales and x (mostly from L2: a row
// is gathered by its ~7 neighbours, once per batch item) and write the
// output; the dense gathers must read S as stored (126.6 MB bf16 on the L7
// diag layout, 545.7 MB bf16, 1.09 GB float32 and 273 MB int8 on the band,
// 7.9 MB bf16 on the esc2 graph), a floor no kernel on such a layout can
// pass, plus x, the fix rows, the rank-1 scales (read from L2 beside each
// gathered row, as the packed gathers read theirs) and the output. On the
// diag layout S is the smaller part: the gathered x rows (about 590 MB an
// item at F 256 bf16, from L2) and the warps in flight set the time. A
// runtime S with every window column nonzero (a dense random tile) costs W
// gathers a row; diag_matvec's probabilities are zero off the window's mask,
// about 7 a row.

namespace {

// Destination rows per CTA: small CTAs fit more warps on an SM at the
// ~90 registers a thread of the batch-4 kernels takes.
constexpr int ROW_WARPS = 4;
constexpr int NB = 4;  // batch items a walk of the batched gathers
constexpr unsigned FULL = 0xffffffffu;

// The escape fix rows a gather adds: block b's receivers are rows[ptr[b]]
// .. rows[ptr[b+1] - 1], unique and sorted; fix holds one row per receiver
// and batch item, in x's type. ptr == null: no escapes.
struct Escapes {
  const int* ptr;       // (n_pad / block + 1,)
  const int64_t* rows;  // (n_fix,)
  const void* fix;      // (batch, n_fix, f)
  int n_fix;
};

// The first round of a slot search in the receivers [j0, j1): lane l holds
// receiver j0 + l, or -1.
__device__ __forceinline__ int64_t escape_candidate(const Escapes& esc, int j0,
                                                    int j1, int lane) {
  return j0 + lane < j1 ? esc.rows[j0 + lane] : -1;
}

// The slot j of destination `row` (esc.rows[j] == row) in [j0, j1), or -1,
// from the first round's candidates; a block of more than 32 receivers
// loads the later rounds here. The whole warp takes part: 32 receivers a
// round, one ballot each.
__device__ __forceinline__ int escape_slot_in(const Escapes& esc, int64_t row,
                                              int j0, int j1, int64_t cand,
                                              int lane) {
  for (int k = j0;;) {
    const unsigned hit = __ballot_sync(FULL, cand == row);
    if (hit) return k + __ffs(hit) - 1;
    k += 32;
    if (k >= j1) return -1;
    cand = k + lane < j1 ? esc.rows[k + lane] : -1;
  }
}

// The slot of destination `row` in its block b's range, or -1.
__device__ __forceinline__ int escape_slot(const Escapes& esc, int64_t row,
                                           int64_t b, int lane) {
  const int j0 = esc.ptr[b], j1 = esc.ptr[b + 1];
  return escape_slot_in(esc, row, j0, j1, escape_candidate(esc, j0, j1, lane), lane);
}

// Adds one nonzero, weight w on the source row whose 16-byte column vector
// (item 0) is at xr, for the nb (<= NB) batch items, item stride `item`.
// The items' loads are issued together.
template <typename T>
__device__ __forceinline__ void add_row(float (&acc)[NB][16 / sizeof(T)],
                                        float w, const T* __restrict__ xr,
                                        int64_t item, int nb) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 raw[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < nb) raw[b] = __ldg(reinterpret_cast<const uint4*>(xr + b * item));
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (b < nb) {
      const T* xv = reinterpret_cast<const T*>(&raw[b]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[b][e] = fmaf(w, to_f32(xv[e]), acc[b][e]);
    }
  }
}

// The row's fix rows (slot >= 0) into the accumulators, then the
// accumulators times the row scale, rounded once, into the nb items' output
// rows (`out` at item 0, this row and column c0; item stride `out_item`).
template <typename T, bool HAS_ESC>
__device__ __forceinline__ void finish_row(float (&acc)[NB][16 / sizeof(T)],
                                           const Escapes& esc, int slot,
                                           int b0, int c0, int f, float rs,
                                           T* __restrict__ out,
                                           int64_t out_item, int nb) {
  constexpr int VEC = 16 / sizeof(T);
  if constexpr (HAS_ESC) {
    if (slot >= 0) {
      const int64_t fix_item = (int64_t)esc.n_fix * f;
      add_row<T>(acc, 1.f,
                     static_cast<const T*>(esc.fix) + b0 * fix_item +
                         (int64_t)slot * f + c0,
                     fix_item, nb);
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (b < nb) {
      __align__(16) T tmp[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) tmp[e] = from_f32<T>(acc[b][e] * rs);
      *reinterpret_cast<uint4*>(out + b * out_item) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

// Packed B4 and B13 on a batch of two or more: bits (n_pad, words) S01,
// window-relative (bit j of word k of row i is column 32k + j of its
// window); col_scale and row_scale a on source and destination rows.
template <typename T, bool HAS_ESC>
__global__ void __launch_bounds__(ROW_WARPS * 32)
packed_rows_kernel(const uint32_t* __restrict__ bits,
                   const float* __restrict__ col_scale,
                   const float* __restrict__ row_scale,
                   const int* __restrict__ window_start,
                   const T* __restrict__ x, T* __restrict__ out,
                   const Escapes esc, int n_pad, int words, int block, int f,
                   int x_rows, int batch) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (row >= n_pad) return;  // the whole warp
  const int ws = window_start[row / block];
  const uint32_t* brow = bits + row * words;
  const float rs = scale_at<T>(row_scale, row);
  const int slot = HAS_ESC ? escape_slot(esc, row, row / block, lane) : -1;
  const int64_t item = (int64_t)x_rows * f, out_item = (int64_t)n_pad * f;

  // The whole warp walks the column passes and batch groups together (the
  // ballots and shuffles need every lane); a lane past F skips its loads
  // and its store.
  for (int cb = 0; cb < f; cb += 32 * VEC) {
    const int c0 = cb + lane * VEC;
    const bool on = c0 < f;
    for (int b0 = 0; b0 < batch; b0 += NB) {
      const int nb = min(NB, batch - b0);
      const T* xb = x + b0 * item + c0;
      float acc[NB][VEC];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[b][e] = 0.f;
      for (int k0 = 0; k0 < words; k0 += 32) {
        const uint32_t word = k0 + lane < words ? brow[k0 + lane] : 0u;
        // Words with a set bit, ascending, then their bits, ascending.
        for (unsigned live = __ballot_sync(FULL, word != 0u); live; live &= live - 1) {
          const int j = __ffs(live) - 1;
          const int col0 = ws + (k0 + j) * 32;
          for (uint32_t m = __shfl_sync(FULL, word, j); m; m &= m - 1) {
            const int src = col0 + __ffs(m) - 1;
            if (on && src < x_rows)
              add_row<T>(acc, scale_at<T>(col_scale, src),
                         xb + (int64_t)src * f, item, nb);
          }
        }
      }
      if (on)
        finish_row<T, HAS_ESC>(acc, esc, slot, b0, c0, f, rs,
                               out + b0 * out_item + row * f + c0, out_item, nb);
    }
  }
}

// Entry e of a 16-byte vector of S as a weight for an x of type T: S cast
// to T (as the reference casts its tile), then float32. Selects and
// shifts, so a runtime e stays in registers.
template <typename T, int MIXED>
__device__ __forceinline__ float s_entry(const uint4& v, int e) {
  using TS = s_type<T, MIXED>;
  constexpr int PER = 4 / (int)sizeof(TS);  // entries per 32-bit word
  const int q = e / PER;
  const uint32_t word = q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  const uint32_t bits = word >> (32 / PER * (e % PER));
  if constexpr (MIXED == 3) {
    return to_f32(from_f32<T>((float)(int8_t)(bits & 0xffu)));
  } else if constexpr (sizeof(TS) == 2) {  // bf16 S: under a bf16 or float32 x, exact
    return to_f32(__ushort_as_bfloat16((unsigned short)(bits & 0xffffu)));
  } else {
    const float s = __uint_as_float(bits);
    return MIXED == 2 ? to_f32(from_f32<T>(s)) : s;
  }
}

// B4, B10 and B11 on a batch of two or more: S (n_pad, window)
// window-relative in the type the operand mode names (s_type). SCALES (the
// int8 rank-1 form of B10): each nonzero weighs T(col_scale[source]), the
// sum T(row_scale[row]); null scales otherwise.
template <typename T, int MIXED, bool HAS_ESC, bool SCALES>
__global__ void __launch_bounds__(ROW_WARPS * 32)
dense_rows_kernel(const void* __restrict__ s, const float* __restrict__ col_scale,
                  const float* __restrict__ row_scale,
                  const int* __restrict__ window_start,
                  const T* __restrict__ x, T* __restrict__ out, const Escapes esc,
                  int n_pad, int window, int block, int f, int x_rows, int batch) {
  using TS = s_type<T, MIXED>;
  static_assert(!SCALES || MIXED == 3, "the rank-1 scales go with an int8 S01");
  constexpr int VEC = 16 / sizeof(T);
  constexpr int SVEC = 16 / sizeof(TS);  // S entries per 16-byte vector
  constexpr int GROUP = 4;  // S vectors a lane loads at once
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (row >= n_pad) return;  // the whole warp
  const int ws = window_start[row / block];
  const int vpr = window / SVEC;  // S vectors per row
  const uint4* srow =
      reinterpret_cast<const uint4*>(static_cast<const TS*>(s) + row * window);
  const int slot = HAS_ESC ? escape_slot(esc, row, row / block, lane) : -1;
  const float rs = SCALES ? scale_at<T>(row_scale, row) : 1.f;
  const int64_t item = (int64_t)x_rows * f, out_item = (int64_t)n_pad * f;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int cb = 0; cb < f; cb += 32 * VEC) {
    const int c0 = cb + lane * VEC;
    const bool on = c0 < f;
    for (int b0 = 0; b0 < batch; b0 += NB) {
      const int nb = min(NB, batch - b0);
      const T* xb = x + b0 * item + c0;
      float acc[NB][VEC];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[b][e] = 0.f;
      for (int v0 = 0; v0 < vpr; v0 += 32 * GROUP) {
        uint4 raw[GROUP];  // issued together: GROUP loads in flight a lane
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          const int v = v0 + 32 * g + lane;
          raw[g] = v < vpr ? __ldcs(srow + v) : zero;
        }
#pragma unroll
        for (int g = 0; g < GROUP; ++g) {
          if (v0 + 32 * g >= vpr) break;
          unsigned mask = 0;  // this lane's nonzero entries
#pragma unroll
          for (int e = 0; e < SVEC; ++e)
            mask |= (s_entry<T, MIXED>(raw[g], e) != 0.f ? 1u : 0u) << e;
          // Vectors with a nonzero, ascending, then their entries, ascending.
          for (unsigned live = __ballot_sync(FULL, mask != 0u); live; live &= live - 1) {
            const int j = __ffs(live) - 1;
            const uint4 v = make_uint4(
                __shfl_sync(FULL, raw[g].x, j), __shfl_sync(FULL, raw[g].y, j),
                __shfl_sync(FULL, raw[g].z, j), __shfl_sync(FULL, raw[g].w, j));
            const int col0 = ws + (v0 + 32 * g + j) * SVEC;
            for (unsigned m = __shfl_sync(FULL, mask, j); m; m &= m - 1) {
              const int e = __ffs(m) - 1;
              if (on && col0 + e < x_rows)
                add_row<T>(acc,
                           SCALES ? scale_at<T>(col_scale, col0 + e)
                                  : s_entry<T, MIXED>(v, e),
                           xb + (int64_t)(col0 + e) * f, item, nb);
            }
          }
        }
      }
      if (on)
        finish_row<T, HAS_ESC>(acc, esc, slot, b0, c0, f, rs,
                               out + b0 * out_item + row * f + c0, out_item, nb);
    }
  }
}

// ---- one item: list, then gather (see the top of this section)

constexpr int LIST = 32;     // listed nonzeros a warp holds
constexpr int INFLIGHT = 8;  // gathered x rows in flight a lane
constexpr int ROWS1 = 4;     // consecutive destination rows a warp walks

__device__ __forceinline__ int popc(unsigned m) { return __popc(m); }
__device__ __forceinline__ int popc(unsigned long long m) { return __popcll(m); }
__device__ __forceinline__ int lowest(unsigned m) { return __ffs(m) - 1; }
__device__ __forceinline__ int lowest(unsigned long long m) { return __ffsll(m) - 1; }

// Bits [0, k) of an M, k clamped to [0, bits of M].
template <typename M>
__device__ __forceinline__ M low_bits(int k) {
  constexpr int BITS = 8 * sizeof(M);
  return k <= 0 ? M(0) : k >= BITS ? ~M(0) : (M(1) << k) - 1;
}

// Adds list entries [0, n) into acc, in list order: the source row of entry
// k is lcol[k] (its 16-byte column slice at xc + lcol[k] * f), its weight
// lw[k] or, with SCALES, the source's column scale rounded to T. INFLIGHT
// rows are copied at once into the warp's staging rows in shared memory
// (cp.async: in flight without holding registers), then added. A lane past
// F (on false) copies nothing.
template <typename T, bool SCALES>
__device__ __forceinline__ void gather_list(float (&acc)[16 / sizeof(T)],
                                            const int* lcol, const float* lw,
                                            int n, const float* __restrict__ col_scale,
                                            const T* __restrict__ xc, int f, bool on) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ uint4 stage[ROW_WARPS][INFLIGHT][32];
  uint4* st = &stage[threadIdx.x >> 5][0][threadIdx.x & 31];  // this lane's
  for (int k0 = 0; k0 < n; k0 += INFLIGHT) {
    float w[INFLIGHT];
#pragma unroll
    for (int k = 0; k < INFLIGHT; ++k) {
      const bool live = k0 + k < n;
      const int src = live ? lcol[k0 + k] : 0;
      const unsigned dst = (unsigned)__cvta_generic_to_shared(st + k * 32);
      // 16 bytes, or with a source size of 0 none read and zeros written.
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                   "l"(xc + (int64_t)src * f), "r"(live && on ? 16 : 0));
      if constexpr (SCALES) w[k] = live ? scale_at<T>(col_scale, src) : 0.f;
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < INFLIGHT; ++k) {
      if (k0 + k < n) {
        float wk;
        if constexpr (SCALES) wk = w[k];
        else wk = lw[k0 + k];
        const uint4 raw = st[k * 32];  // each lane reads back its own copy
        const T* xv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wk, to_f32(xv[e]), acc[e]);
      }
    }
  }
}

// Appends one round of the row to the warp's list after its n entries: this
// lane's columns hold the nonzeros `mask` (bit i is column col0 + i, weight
// weight(i)); lanes in ascending order, each its bits ascending. Gathers the
// list into acc (gather_list's arguments) whenever it fills. The whole warp
// takes part; n is the same in every lane.
template <typename T, bool SCALES, typename M, typename Weight>
__device__ __forceinline__ void list_round(M mask, int col0, Weight weight,
                                           int lane, int& n, int* lcol, float* lw,
                                           float (&acc)[16 / sizeof(T)],
                                           const float* __restrict__ col_scale,
                                           const T* __restrict__ xc, int f, bool on) {
  if (__ballot_sync(FULL, mask != 0) == 0u) return;
  const int cnt = popc(mask);
  int first = cnt;  // inclusive scan over the lanes, then this lane's first
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, first, d);
    if (lane >= d) first += v;
  }
  const int total = __shfl_sync(FULL, first, 31);
  first -= cnt;
  for (int done = 0; done < total;) {
    // This pass lists the round's entries [done, done + LIST - n).
    int i = first;
    for (M m = mask; m; m &= m - 1, ++i) {
      const int slot = n + i - done;
      if (i >= done && slot < LIST) {
        const int e = lowest(m);
        lcol[slot] = col0 + e;
        if constexpr (!SCALES) lw[slot] = weight(e);
      }
    }
    const int took = min(total - done, LIST - n);
    n += took;
    done += took;
    if (n == LIST) {
      __syncwarp();
      gather_list<T, SCALES>(acc, lcol, lw, LIST, col_scale, xc, f, on);
      __syncwarp();
      n = 0;
    }
  }
}

// The row's fix row (fixv, loaded when slot >= 0) into acc, then acc times
// the row scale, rounded once, to out (this row and column slice).
template <typename T, bool HAS_ESC>
__device__ __forceinline__ void finish_row1(float (&acc)[16 / sizeof(T)],
                                            const uint4& fixv, int slot, float rs,
                                            T* __restrict__ out) {
  constexpr int VEC = 16 / sizeof(T);
  if constexpr (HAS_ESC) {
    if (slot >= 0) {
      const T* fv = reinterpret_cast<const T*>(&fixv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(1.f, to_f32(fv[e]), acc[e]);
    }
  }
  __align__(16) T tmp[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) tmp[e] = from_f32<T>(acc[e] * rs);
  *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(tmp);
}

// The fix row of `slot` at this lane's column slice, or zeros.
template <typename T>
__device__ __forceinline__ uint4 fix_row(const Escapes& esc, int slot, int f,
                                         int c0, bool on) {
  return slot >= 0 && on
             ? __ldg(reinterpret_cast<const uint4*>(static_cast<const T*>(esc.fix) +
                                                    (int64_t)slot * f + c0))
             : make_uint4(0u, 0u, 0u, 0u);
}

// r[q] for a runtime q, by selects (no local memory).
template <int K>
__device__ __forceinline__ uint4 pick(const uint4 (&r)[K], int q) {
  uint4 v = r[0];
#pragma unroll
  for (int j = 1; j < K; ++j)
    if (q == j) v = r[j];
  return v;
}

// The graph block of the rows a warp walks, kept as the rows advance (one
// division a warp).
struct BlockOf {
  int b, end, block;
  __device__ explicit BlockOf(int row, int block_)
      : b(row / block_), end((row / block_ + 1) * block_), block(block_) {}
  __device__ int operator()(int row) {
    while (row >= end) ++b, end += block;
    return b;
  }
};

// B1 (and B1 on a runtime S), B3, and B11, B4, B10 with one item: S
// (n_pad, window) and the scales as dense_rows_kernel takes them, x (x_rows,
// f), out (n_pad, f). Lane l takes K consecutive S vectors of a round (32 K
// vectors), so its mask covers K * SVEC consecutive columns.
template <typename T, int MIXED, bool HAS_ESC, bool SCALES, int K>
__global__ void __launch_bounds__(ROW_WARPS * 32)
dense_row1_kernel(const void* __restrict__ s, const float* __restrict__ col_scale,
                  const float* __restrict__ row_scale,
                  const int* __restrict__ window_start,
                  const T* __restrict__ x, T* __restrict__ out, const Escapes esc,
                  int n_pad, int window, int block, int f, int x_rows) {
  using TS = s_type<T, MIXED>;
  static_assert(!SCALES || MIXED == 3, "the rank-1 scales go with an int8 S01");
  constexpr int VEC = 16 / sizeof(T);
  constexpr int SVEC = 16 / sizeof(TS);  // S entries per 16-byte vector
  static_assert(K * SVEC <= 32, "a lane's mask is 32 bits");
  __shared__ int list_col[ROW_WARPS][LIST];
  __shared__ float list_w[ROW_WARPS][LIST];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = (blockIdx.x * ROW_WARPS + warp) * ROWS1;
  if (first >= n_pad) return;  // the whole warp
  const int last = min(first + ROWS1, n_pad);
  int* lcol = list_col[warp];
  float* lw = list_w[warp];
  const int vpr = window / SVEC;  // S vectors per row
  BlockOf block_of(first, block);
  uint4 raw[K];
  auto load = [&](int row, int v0) {
    const uint4* sv = reinterpret_cast<const uint4*>(static_cast<const TS*>(s) +
                                                     (int64_t)row * window) +
                      v0 + K * lane;
#pragma unroll
    for (int q = 0; q < K; ++q)
      raw[q] = v0 + K * lane + q < vpr ? __ldcs(sv + q) : make_uint4(0u, 0u, 0u, 0u);
  };
  load(first, 0);
  for (int row = first; row < last; ++row) {
    const int b = block_of(row);
    const int ws = window_start[b];
    const float rs = SCALES ? scale_at<T>(row_scale, row) : 1.f;
    const int j0 = HAS_ESC ? esc.ptr[b] : 0, j1 = HAS_ESC ? esc.ptr[b + 1] : 0;
    const int64_t cand = HAS_ESC ? escape_candidate(esc, j0, j1, lane) : -1;
    int slot = -1;
    for (int cb = 0; cb < f; cb += 32 * VEC) {
      const int c0 = cb + lane * VEC;
      const bool on = c0 < f;
      const T* xc = x + c0;
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
      int n = 0;
      for (int v0 = 0; v0 < vpr; v0 += 32 * K) {
        if (v0 > 0 || cb > 0) load(row, v0);
        const int col0 = ws + (v0 + K * lane) * SVEC;
        unsigned mask = 0;  // this lane's nonzero entries with a source row
#pragma unroll
        for (int q = 0; q < K; ++q)
#pragma unroll
          for (int e = 0; e < SVEC; ++e)
            mask |= (s_entry<T, MIXED>(raw[q], e) != 0.f ? 1u : 0u) << (q * SVEC + e);
        list_round<T, SCALES>(mask & low_bits<unsigned>(x_rows - col0), col0,
                              [&](int i) {
                                return s_entry<T, MIXED>(pick(raw, i / SVEC), i % SVEC);
                              },
                              lane, n, lcol, lw, acc, col_scale, xc, f, on);
      }
      // This row's S is listed: the next row's goes in flight while this
      // row's sources are gathered.
      if (cb + 32 * VEC >= f && row + 1 < last) load(row + 1, 0);
      if (HAS_ESC && cb == 0) slot = escape_slot_in(esc, row, j0, j1, cand, lane);
      const uint4 fixv = HAS_ESC ? fix_row<T>(esc, slot, f, c0, on) : uint4{};
      __syncwarp();
      gather_list<T, SCALES>(acc, lcol, lw, n, col_scale, xc, f, on);
      if (on) finish_row1<T, HAS_ESC>(acc, fixv, slot, rs, out + (int64_t)row * f + c0);
      __syncwarp();  // the list is refilled by the next pass or row
    }
  }
}

// Packed B1 and B13 with one item: bits (n_pad, words) as packed_rows_kernel
// takes them, x (x_rows, f), out (n_pad, f). Lane l takes KW consecutive
// words of a round (32 KW words), KW = 1 or 2 as its mask M has 32 or 64
// bits.
template <typename T, bool HAS_ESC, typename M>
__global__ void __launch_bounds__(ROW_WARPS * 32)
packed_row1_kernel(const uint32_t* __restrict__ bits,
                   const float* __restrict__ col_scale,
                   const float* __restrict__ row_scale,
                   const int* __restrict__ window_start,
                   const T* __restrict__ x, T* __restrict__ out,
                   const Escapes esc, int n_pad, int words, int block, int f,
                   int x_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int KW = sizeof(M) / 4;
  __shared__ int list_col[ROW_WARPS][LIST];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = (blockIdx.x * ROW_WARPS + warp) * ROWS1;
  if (first >= n_pad) return;  // the whole warp
  const int last = min(first + ROWS1, n_pad);
  int* lcol = list_col[warp];
  BlockOf block_of(first, block);
  auto lane_words = [&](int row, int k0) {  // words k0 + KW lane .. + KW - 1
    const int k = k0 + KW * lane;
    const uint32_t* w = bits + (int64_t)row * words + k;
    M m = 0;
#pragma unroll
    for (int q = 0; q < KW; ++q)
      if (k + q < words) m |= (M)w[q] << (32 * q);
    return m;
  };
  M ahead = lane_words(first, 0);  // a row's first round, loaded a row ahead
  for (int row = first; row < last; ++row) {
    const int b = block_of(row);
    const int ws = window_start[b];
    const float rs = scale_at<T>(row_scale, row);
    const int j0 = HAS_ESC ? esc.ptr[b] : 0, j1 = HAS_ESC ? esc.ptr[b + 1] : 0;
    const int64_t cand = HAS_ESC ? escape_candidate(esc, j0, j1, lane) : -1;
    const M round0 = ahead;
    if (row + 1 < last) ahead = lane_words(row + 1, 0);  // in flight from here
    int slot = -1;
    for (int cb = 0; cb < f; cb += 32 * VEC) {
      const int c0 = cb + lane * VEC;
      const bool on = c0 < f;
      const T* xc = x + c0;
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
      int n = 0;
      for (int k0 = 0; k0 < words; k0 += 32 * KW) {
        const M m = k0 == 0 ? round0 : lane_words(row, k0);
        const int col0 = ws + (k0 + KW * lane) * 32;
        list_round<T, true>(m & low_bits<M>(x_rows - col0), col0,
                            [](int) { return 0.f; }, lane, n, lcol, nullptr, acc,
                            col_scale, xc, f, on);
      }
      if (HAS_ESC && cb == 0) slot = escape_slot_in(esc, row, j0, j1, cand, lane);
      const uint4 fixv = HAS_ESC ? fix_row<T>(esc, slot, f, c0, on) : uint4{};
      __syncwarp();
      gather_list<T, true>(acc, lcol, nullptr, n, col_scale, xc, f, on);
      if (on) finish_row1<T, HAS_ESC>(acc, fixv, slot, rs, out + (int64_t)row * f + c0);
      __syncwarp();  // the list is refilled by the next pass or row
    }
  }
}

// One item takes the batch-1 walk; more ride inside the warp, up to NB = 4
// items a pass (one pass for the train-mesh shape).
template <typename T, int MIXED, bool HAS_ESC, bool SCALES = false>
int launch_dense_rows(const void* s, const float* col_scale,
                      const float* row_scale, const int* ws, const void* x,
                      void* out, const Escapes& esc, int n_pad, int window,
                      int block, int f, int x_rows, int batch, cudaStream_t st) {
  if (f % (16 / (int)sizeof(T))) return -1;
  const dim3 grid((unsigned)((n_pad + ROW_WARPS - 1) / ROW_WARPS));
  const dim3 grid1((unsigned)((n_pad + ROW_WARPS * ROWS1 - 1) / (ROW_WARPS * ROWS1)));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  // One round of vectors for the diag layout and the esc2 graph (two vectors
  // a lane for 48 of bf16 S), few for a wide band (four a lane); int8 S, 16
  // entries a vector, takes two.
  constexpr int SVEC = 16 / sizeof(s_type<T, MIXED>);
  constexpr int K_WIDE = SVEC == 16 ? 2 : 4;
  if (batch == 1 && window / SVEC <= 64)
    dense_row1_kernel<T, MIXED, HAS_ESC, SCALES, 2><<<grid1, ROW_WARPS * 32, 0, st>>>(
        s, col_scale, row_scale, ws, xt, ot, esc, n_pad, window, block, f, x_rows);
  else if (batch == 1)
    dense_row1_kernel<T, MIXED, HAS_ESC, SCALES, K_WIDE><<<grid1, ROW_WARPS * 32, 0, st>>>(
        s, col_scale, row_scale, ws, xt, ot, esc, n_pad, window, block, f, x_rows);
  else
    dense_rows_kernel<T, MIXED, HAS_ESC, SCALES><<<grid, ROW_WARPS * 32, 0, st>>>(
        s, col_scale, row_scale, ws, xt, ot, esc, n_pad, window, block, f, x_rows,
        batch);
  return (int)cudaGetLastError();
}

// Escapes in the modes B1 and B4 take: S in x's type, or bf16 S under a
// float32 x (MIXED 0 and 1); the other modes take none.
template <typename T, int MIXED>
int dense_rows(const void* s, const int* ws, const void* x, void* out,
               const Escapes& esc, int n_pad, int window, int block, int f,
               int x_rows, int batch, cudaStream_t st) {
  if (esc.ptr == nullptr)
    return launch_dense_rows<T, MIXED, false>(s, nullptr, nullptr, ws, x, out, esc,
                                              n_pad, window, block, f, x_rows,
                                              batch, st);
  if constexpr (MIXED <= 1)
    return launch_dense_rows<T, MIXED, true>(s, nullptr, nullptr, ws, x, out, esc,
                                             n_pad, window, block, f, x_rows,
                                             batch, st);
  return -1;
}

template <typename T, bool HAS_ESC>
int launch_packed_rows(const uint32_t* bits, const float* col_scale,
                       const float* row_scale, const int* ws, const void* x,
                       void* out, const Escapes& esc, int n_pad, int words,
                       int block, int f, int x_rows, int batch, cudaStream_t st) {
  const dim3 grid((unsigned)((n_pad + ROW_WARPS - 1) / ROW_WARPS));
  const dim3 grid1((unsigned)((n_pad + ROW_WARPS * ROWS1 - 1) / (ROW_WARPS * ROWS1)));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  // One round of words a lane: 32-bit masks up to 32 words, 64-bit above.
  if (batch == 1 && words <= 32)
    packed_row1_kernel<T, HAS_ESC, unsigned><<<grid1, ROW_WARPS * 32, 0, st>>>(
        bits, col_scale, row_scale, ws, xt, ot, esc, n_pad, words, block, f,
        x_rows);
  else if (batch == 1)
    packed_row1_kernel<T, HAS_ESC, unsigned long long>
        <<<grid1, ROW_WARPS * 32, 0, st>>>(bits, col_scale, row_scale, ws, xt, ot,
                                           esc, n_pad, words, block, f, x_rows);
  else
    packed_rows_kernel<T, HAS_ESC><<<grid, ROW_WARPS * 32, 0, st>>>(
        bits, col_scale, row_scale, ws, xt, ot, esc, n_pad, words, block, f,
        x_rows, batch);
  return (int)cudaGetLastError();
}

template <typename T>
int packed_rows(const uint32_t* bits, const float* col_scale,
                const float* row_scale, const int* ws, const void* x, void* out,
                const Escapes& esc, int n_pad, int words, int block, int f,
                int x_rows, int batch, cudaStream_t st) {
  if (f % (16 / (int)sizeof(T))) return -1;
  return esc.ptr == nullptr
             ? launch_packed_rows<T, false>(bits, col_scale, row_scale, ws, x,
                                            out, esc, n_pad, words, block, f,
                                            x_rows, batch, st)
             : launch_packed_rows<T, true>(bits, col_scale, row_scale, ws, x,
                                           out, esc, n_pad, words, block, f,
                                           x_rows, batch, st);
}

bool rows_args_ok(int n_pad, int window, int block, int f, int x_rows,
                  int batch, const Escapes& esc) {
  return n_pad > 0 && block > 0 && n_pad % block == 0 && window > 0 &&
         window % 32 == 0 && f > 0 && x_rows > 0 && batch > 0 &&
         (esc.ptr == nullptr || (esc.rows != nullptr && esc.fix != nullptr &&
                                 esc.n_fix > 0));
}

Escapes make_escapes(const void* esc_ptr, const void* esc_rows,
                     const void* fix, int n_fix) {
  return Escapes{static_cast<const int*>(esc_ptr),
                 static_cast<const int64_t*>(esc_rows), fix, n_fix};
}

}  // namespace

// B1 (also on a runtime S), B3, B4, B10 and B11: S (n_pad, window)
// window-relative, window_start (n_pad / block,) int32 absolute starts, x
// (batch, x_rows, f) with x_rows up to the layout's source rows, out (batch,
// n_pad, f) (batch 1: (x_rows, f) and (n_pad, f)). B1's and B4's escapes:
// esc_ptr (n_pad / block + 1,) int32, esc_rows (n_fix,) int64, fix (batch,
// n_fix, f) in x's type; esc_ptr == NULL means none. dtype 0 to 5 (see the
// top of this file); escapes with dtype 0, 1 and 2 only. Returns 0 on
// success, a cudaError_t from the launch, or -1 for arguments the kernels do
// not take.
extern "C" int gwen_window_spmm_streamed(const void* s, const void* x,
                                         const void* window_start,
                                         const void* esc_ptr,
                                         const void* esc_rows, const void* fix,
                                         void* out, int n_pad, int window,
                                         int block, int f, int x_rows,
                                         int batch, int n_fix, int dtype,
                                         void* stream) {
  const Escapes esc = make_escapes(esc_ptr, esc_rows, fix, n_fix);
  if (!rows_args_ok(n_pad, window, block, f, x_rows, batch, esc)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ws = static_cast<const int*>(window_start);
  switch (dtype) {
    case 0: return dense_rows<float, 0>(s, ws, x, out, esc, n_pad, window, block, f, x_rows, batch, st);
    case 1: return dense_rows<__nv_bfloat16, 0>(s, ws, x, out, esc, n_pad, window, block, f, x_rows, batch, st);
    case 2: return dense_rows<float, 1>(s, ws, x, out, esc, n_pad, window, block, f, x_rows, batch, st);
    case 3: return dense_rows<__nv_bfloat16, 2>(s, ws, x, out, esc, n_pad, window, block, f, x_rows, batch, st);
    case 4: return dense_rows<float, 3>(s, ws, x, out, esc, n_pad, window, block, f, x_rows, batch, st);
    case 5: return dense_rows<__nv_bfloat16, 3>(s, ws, x, out, esc, n_pad, window, block, f, x_rows, batch, st);
  }
  return -1;
}

// Packed B1, packed B4 and B13: bits (n_pad, words) int32 S01, col_scale
// and row_scale float32, window_start (n_pad / block,) int32, x (batch,
// x_rows, f), out (batch, n_pad, f); escapes as gwen_window_spmm_streamed.
// dtype 0 = float32, 1 = bfloat16. Return codes as
// gwen_window_spmm_streamed.
extern "C" int gwen_sliding_packed_spmm(const void* bits, const void* col_scale,
                                        const void* row_scale, const void* x,
                                        const void* window_start,
                                        const void* esc_ptr, const void* esc_rows,
                                        const void* fix, void* out, int n_pad,
                                        int words, int block, int f, int x_rows,
                                        int batch, int n_fix, int dtype,
                                        void* stream) {
  const Escapes esc = make_escapes(esc_ptr, esc_rows, fix, n_fix);
  if (words <= 0 || !rows_args_ok(n_pad, words * 32, block, f, x_rows, batch, esc))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* b = static_cast<const uint32_t*>(bits);
  const float* cs = static_cast<const float*>(col_scale);
  const float* rs = static_cast<const float*>(row_scale);
  const int* ws = static_cast<const int*>(window_start);
  if (dtype == 0)
    return packed_rows<float>(b, cs, rs, ws, x, out, esc, n_pad, words, block, f, x_rows, batch, st);
  if (dtype == 1)
    return packed_rows<__nv_bfloat16>(b, cs, rs, ws, x, out, esc, n_pad, words, block, f, x_rows, batch, st);
  return -1;
}

// The int8 rank-1 form of B3 (batch 1) and B10: s (n_pad, window) int8 S01
// window-relative, col_scale (x_rows or more,) and row_scale (n_pad,)
// float32, window_start (n_pad / block,) int32, x (batch, x_rows, f), out
// (batch, n_pad, f); out = T(row_scale) . sum over S01's nonzeros of
// T(col_scale) . x, one rounding. dtype 4 = float32, 5 = bfloat16 (x and
// out). Return codes as gwen_window_spmm_streamed.
extern "C" int gwen_rank1_spmm(const void* s, const void* col_scale,
                               const void* row_scale, const void* x,
                               const void* window_start, void* out, int n_pad,
                               int window, int block, int f, int x_rows,
                               int batch, int dtype, void* stream) {
  const Escapes none = make_escapes(nullptr, nullptr, nullptr, 0);
  if (col_scale == nullptr || row_scale == nullptr ||
      !rows_args_ok(n_pad, window, block, f, x_rows, batch, none))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cs = static_cast<const float*>(col_scale);
  const float* rs = static_cast<const float*>(row_scale);
  const int* ws = static_cast<const int*>(window_start);
  if (dtype == 4)
    return launch_dense_rows<float, 3, false, true>(
        s, cs, rs, ws, x, out, none, n_pad, window, block, f, x_rows, batch, st);
  if (dtype == 5)
    return launch_dense_rows<__nv_bfloat16, 3, false, true>(
        s, cs, rs, ws, x, out, none, n_pad, window, block, f, x_rows, batch, st);
  return -1;
}

// ------------------------------------------------------------ blocked ELL
//
// B12, replacing gwen_tpu/ops/spmm_pallas.py:_kernel (through _spmm_impl).
// The TPU kernel builds the (block, window) scatter tile from the ELL
// tables with one-hot compares and multiplies it with the window on the
// MXU, because it cannot gather rows. The math is a gather-scale-sum over
// each row's at most `deg` sources,
//   out[i, :] = sum_d T(w[i, d]) * x[ws[i / block] + nbr[i, d], :],
// and that is what this kernel does: one warp per destination row and
// batch member, the row's indices and weights read once into lanes and
// broadcast with shuffles, each source row read with 16-byte loads, float32
// accumulation in slot order (no atomics, a fixed order of summation), one
// rounding. Weights are rounded to x's type first, as the reference casts
// its tile. Slots of weight 0 (padding) and sources at or past x_rows are
// not read. Slots of one row that name the same source add.

namespace {

constexpr int ELL_WARPS = 8;  // destination rows per CTA

template <typename T>
__global__ void __launch_bounds__(ELL_WARPS * 32)
ell_spmm_kernel(const int* __restrict__ nbr, const float* __restrict__ w,
                const int* __restrict__ window_start, const T* __restrict__ x,
                T* __restrict__ out, int n_pad, int deg, int block, int f,
                int x_rows) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * ELL_WARPS + (threadIdx.x >> 5);
  if (row >= n_pad) return;
  const int bi = blockIdx.y;
  const T* xb = x + (int64_t)bi * x_rows * f;
  T* ob = out + ((int64_t)bi * n_pad + row) * f;
  const int64_t ws = window_start[row / block];
  const int* nbr_row = nbr + row * deg;
  const float* w_row = w + row * deg;

  // The whole warp walks the column passes together (the shuffles below
  // need every lane); a lane past F only skips its loads and its store.
  for (int cb = 0; cb < f; cb += 32 * VEC) {
    const int c0 = cb + lane * VEC;
    const bool on = c0 < f;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int d0 = 0; d0 < deg; d0 += 32) {
      // Lane l holds slot d0 + l; every lane then walks the 32 slots.
      const int d = d0 + lane;
      const float my_w = d < deg ? scale_at<T>(w_row, d) : 0.f;
      const int my_src = d < deg ? nbr_row[d] : 0;
      const int n_slots = min(32, deg - d0);
      for (int j = 0; j < n_slots; ++j) {
        const float wv = __shfl_sync(0xffffffffu, my_w, j);
        const int64_t src = ws + __shfl_sync(0xffffffffu, my_src, j);
        if (!on || wv == 0.f || src < 0 || src >= x_rows) continue;
        const uint4 raw = *reinterpret_cast<const uint4*>(xb + src * f + c0);
        const T* xv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wv, to_f32(xv[e]), acc[e]);
      }
    }
    __align__(16) T tmp[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) tmp[e] = from_f32<T>(acc[e]);
    if (on)
      *reinterpret_cast<uint4*>(ob + c0) = *reinterpret_cast<const uint4*>(tmp);
  }
}

template <typename T>
int launch_ell(const int* nbr, const float* w, const int* window_start,
               const void* x, void* out, int n_pad, int deg, int block, int f,
               int x_rows, int batch, cudaStream_t stream) {
  if (f % (16 / (int)sizeof(T))) return -1;
  const dim3 grid((unsigned)((n_pad + ELL_WARPS - 1) / ELL_WARPS),
                  (unsigned)batch);
  ell_spmm_kernel<T><<<grid, ELL_WARPS * 32, 0, stream>>>(
      nbr, w, window_start, static_cast<const T*>(x), static_cast<T*>(out),
      n_pad, deg, block, f, x_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// B12: nbr (n_pad, deg) int32 window-relative, w (n_pad, deg) float32,
// window_start (n_pad / block,) int32, x (batch, x_rows, f), out (batch,
// n_pad, f). dtype 0 = float32, 1 = bfloat16 (x and out). Returns 0, a
// cudaError_t, or -1 for arguments the kernel does not take.
extern "C" int gwen_ell_spmm(const void* nbr, const void* w,
                             const void* window_start, const void* x,
                             void* out, int n_pad, int deg, int block, int f,
                             int x_rows, int batch, int dtype, void* stream) {
  if (n_pad <= 0 || deg <= 0 || block <= 0 || n_pad % block || f <= 0 ||
      x_rows <= 0 || batch <= 0 || batch > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* nb = static_cast<const int*>(nbr);
  const float* wp = static_cast<const float*>(w);
  const int* ws = static_cast<const int*>(window_start);
  if (dtype == 0)
    return launch_ell<float>(nb, wp, ws, x, out, n_pad, deg, block, f, x_rows,
                             batch, st);
  if (dtype == 1)
    return launch_ell<__nv_bfloat16>(nb, wp, ws, x, out, n_pad, deg, block, f,
                                     x_rows, batch, st);
  return -1;
}

// ------------------------------------------------------------ block tiles
//
// B14, replacing gwen_tpu/ops/spmm_pallas.py:_tile_kernel (through
// _spmm_tiles_impl). The TPU kernel copies each active 128-row source tile
// of a destination block into VMEM, builds a 128 x 128 scatter matrix per
// tile from the (tnbr, tw) slots with one-hot compares and multiplies the
// two on the MXU, because it cannot gather rows. The math is a
// gather-scale-sum with one indirection more than B12,
//   out[i, :] = sum_{t < n_active[b]} sum_{d < D}
//       T(tw[i, t*D + d]) * x[tile_idx[b, t]*block + tnbr[i, t*D + d], :]
// with b = i / block, and that is what the two kernels here do, reading
// the BSR tables as they are: a warp a destination row reads the row's
// slots of its block's ACTIVE tiles only (n_active[b] * D of the
// tiles_max * D stored), 32 a round, one a lane, each lane resolving its
// slot's source row from tile_idx; a ballot keeps the slots with a nonzero
// weight and a source below x_rows (about 7 of a row's 70 slots in RCM
// order), in ascending slot order. Float32 sums in that order (no atomics,
// a fixed order of summation), one rounding. Each slot's weight is rounded
// to x's type first, as the reference casts its tile; the reference's tile
// holds the sum of the slots of one row that name the same source and
// rounds that sum, so for a bf16 x the two differ on a graph with duplicate
// edges (no mesh has any). Sources at or past x_rows read as zero.
//   One item (tile_walk_kernel): each live slot, broadcast by shuffles,
//     adds its source row at once, one 16-byte load a lane.
//   A batch (tile_list_kernel): the warp lists the row's live slots in
//     shared memory once (one entry a lane at most, so a popcount of the
//     ballot places each), then gathers the list for each item in turn,
//     four x rows in flight a lane, through L1: the tables are read once a
//     row for the whole batch (per pass over F), not once per item (a row
//     of more live slots than the list holds, which no mesh has, lists and
//     gathers them in pieces for each item).
//
// What bounds them, measured on an H100 (PERF.md, tools/time_row_gathers.py
// --controls): not the bytes of the gathers (with every gather from one of
// 64 rows, so from L1, the batched kernel is ~7 % faster and the walk ~5 %),
// but each row's instructions and latencies in series: the table rounds,
// the ballot, the list, the gathers. So warps in flight decide: the
// kernels hold 32 (walk) and 40 (list) registers a thread, and a design
// with more gathers in flight a warp but more registers (eight or two
// slots at once, the batch items held in registers, cp.async into shared
// memory) was slower at every batch size.
//
// Why not one CTA per block staging its active tiles in shared memory (the
// reuse the layout was made for on the TPU): on a mesh a block's 128 rows
// make about 900 gathers from about 8 tiles of 128 rows, so a staged row is
// used about once; staging reads as much as gathering and adds a barrier
// per tile. L2 already serves the rows that neighbours share.

namespace {

// The block-tile tables as the walk reads them.
struct Tiles {
  const int* tile_idx;  // (n_pad / block, tiles_max) active source tiles
  const int* n_active;  // (n_pad / block,)
  const uint8_t* tnbr;  // (n_pad, tiles_max * deg) within-tile sources
  const float* tw;      // (n_pad, tiles_max * deg) weights
  int tiles_max, deg, block, x_rows;
  float inv_deg;  // 1 / deg
};

// One destination row's part of the tables.
struct TileRow {
  const int* tiles;    // its block's active tiles
  const uint8_t* nbr;  // its slots' within-tile sources
  const float* w;      // and weights
  int n;               // its slots in the active tiles

  __device__ TileRow(const Tiles& tl, int row) {
    const int b = row / tl.block;
    const int64_t at = (int64_t)row * tl.tiles_max * tl.deg;
    tiles = tl.tile_idx + (int64_t)b * tl.tiles_max;
    nbr = tl.tnbr + at;
    w = tl.tw + at;
    n = min(tl.n_active[b], tl.tiles_max) * tl.deg;
  }
  // Slot k: its source row and weight (rounded to T); true when the weight
  // is nonzero and the source below x_rows. Its tile k / deg comes from a
  // float32 product, off by at most one for k < 2^21 (the entry refuses
  // wider rows) and corrected, instead of an integer division.
  template <typename T>
  __device__ bool slot(const Tiles& tl, int k, int& src, float& wk) const {
    src = 0;
    wk = 0.f;
    if (k >= n) return false;
    wk = scale_at<T>(w, k);
    int t = (int)(((float)k + 0.5f) * tl.inv_deg);
    t -= t * tl.deg > k;
    t += (t + 1) * tl.deg <= k;
    src = tiles[t] * tl.block + (int)nbr[k];
    return wk != 0.f && src < tl.x_rows;
  }
};

constexpr int TILE_WARPS = 8;  // destination rows a CTA, a warp each
constexpr int TILE_FLIGHT = 4;  // listed x rows a lane gathers at once

// Adds list entries [0, n) into acc in list order, TILE_FLIGHT x rows
// loaded into registers at once (through L1, which serves the rows that
// nearby destination rows share).
template <typename T>
__device__ __forceinline__ void gather_regs(float (&acc)[16 / sizeof(T)],
                                            const int* lcol, const float* lw, int n,
                                            const T* __restrict__ xc, int f, bool on) {
  constexpr int VEC = 16 / sizeof(T);
  for (int k0 = 0; k0 < n; k0 += TILE_FLIGHT) {
    uint4 raw[TILE_FLIGHT];
#pragma unroll
    for (int k = 0; k < TILE_FLIGHT; ++k)
      raw[k] = k0 + k < n && on
                   ? __ldg(reinterpret_cast<const uint4*>(xc + (int64_t)lcol[k0 + k] * f))
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < TILE_FLIGHT; ++k) {
      if (k0 + k < n) {
        const float wk = lw[k0 + k];
        const T* xv = reinterpret_cast<const T*>(&raw[k]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wk, to_f32(xv[e]), acc[e]);
      }
    }
  }
}

// One pass of a row's walk for one item: its slots, 32 a round, each live
// slot broadcast by shuffles as the ballot gives it and its source row
// (x's column slice at xc) added at once, one 16-byte load a lane.
template <typename T>
__device__ __forceinline__ void walk_row(const Tiles& tl, const TileRow& tr,
                                         const T* __restrict__ xc, int f, bool on,
                                         int lane, float (&acc)[16 / sizeof(T)]) {
  constexpr int VEC = 16 / sizeof(T);
  for (int k0 = 0; k0 < tr.n; k0 += 32) {
    int src;
    float w;
    const bool live = tr.slot<T>(tl, k0 + lane, src, w);
    for (unsigned m = __ballot_sync(FULL, live); m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const float wj = __shfl_sync(FULL, w, j);
      const int sj = __shfl_sync(FULL, src, j);
      if (!on) continue;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(xc + (int64_t)sj * f));
      const T* xv = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(wj, to_f32(xv[e]), acc[e]);
    }
  }
}

// B14 with one item: a warp a row walks it (walk_row). x (x_rows, f), out
// (n_pad, f). At most 32 registers a thread (8 CTAs an SM): the walk is
// bound by its instructions and latencies in series, so warps in flight
// count for more than gathers in flight (PERF.md).
template <typename T>
__global__ void __launch_bounds__(TILE_WARPS * 32, 8)
tile_walk_kernel(const Tiles tl, const T* __restrict__ x, T* __restrict__ out,
                 int n_pad, int f) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * TILE_WARPS + (threadIdx.x >> 5);
  if (row >= n_pad) return;  // the whole warp
  const TileRow tr(tl, row);
  for (int cb = 0; cb < f; cb += 32 * VEC) {
    const int c0 = cb + lane * VEC;
    const bool on = c0 < f;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    walk_row<T>(tl, tr, x + c0, f, on, lane, acc);
    if (on) finish_row1<T, false>(acc, uint4{}, -1, 1.f, out + (int64_t)row * f + c0);
  }
}

// Appends this lane's live slot (src, w) to the warp's list after its n
// entries, lanes in ascending order (`bal`, the ballot of the live lanes);
// n grows by the round's count in every lane.
__device__ __forceinline__ void list_slot(bool live, unsigned bal, int src, float w,
                                          int lane, int& n, int* lcol, float* lw) {
  if (live) {
    const int at = n + __popc(bal & ((1u << lane) - 1u));
    lcol[at] = src;
    lw[at] = w;
  }
  n += __popc(bal);
}

// B14 on a batch: a warp a row lists the row's live slots once (when they
// fit the list: every mesh row), then gathers the list for each item in
// turn, one item's sums in registers; a row with more live slots than the
// list holds lists and gathers them in pieces for each item. x (batch,
// x_rows, f), out (batch, n_pad, f). At most 40 registers a thread (6 CTAs
// an SM); walking a hub row with walk_row instead of in pieces costs the
// common path registers and was slower.
template <typename T>
__global__ void __launch_bounds__(TILE_WARPS * 32, 6)
tile_list_kernel(const Tiles tl, const T* __restrict__ x, T* __restrict__ out,
                 int n_pad, int f, int batch) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ int list_col[TILE_WARPS][LIST];
  __shared__ float list_w[TILE_WARPS][LIST];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * TILE_WARPS + warp;
  if (row >= n_pad) return;  // the whole warp
  int* lcol = list_col[warp];
  float* lw = list_w[warp];
  const int64_t item = (int64_t)tl.x_rows * f, out_item = (int64_t)n_pad * f;
  const TileRow tr(tl, row);
  for (int cb = 0; cb < f; cb += 32 * VEC) {
    const int c0 = cb + lane * VEC;
    const bool on = c0 < f;
    // The row's live slots, listed once if they fit.
    int n = 0;
    bool whole = true;
    for (int k0 = 0; k0 < tr.n && whole; k0 += 32) {
      int src;
      float w;
      const bool live = tr.slot<T>(tl, k0 + lane, src, w);
      const unsigned bal = __ballot_sync(FULL, live);
      if (n + __popc(bal) > LIST) whole = false;
      else list_slot(live, bal, src, w, lane, n, lcol, lw);
    }
    __syncwarp();
    for (int b = 0; b < batch; ++b) {
      const T* xc = x + b * item + c0;
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
      if (whole) {
        gather_regs<T>(acc, lcol, lw, n, xc, f, on);
      } else {  // a hub row: listed and gathered in pieces
        __syncwarp();
        n = 0;
        for (int k0 = 0; k0 < tr.n; k0 += 32) {
          int src;
          float w;
          const bool live = tr.slot<T>(tl, k0 + lane, src, w);
          const unsigned bal = __ballot_sync(FULL, live);
          if (n + __popc(bal) > LIST) {
            __syncwarp();
            gather_regs<T>(acc, lcol, lw, n, xc, f, on);
            __syncwarp();
            n = 0;
          }
          list_slot(live, bal, src, w, lane, n, lcol, lw);
        }
        __syncwarp();
        gather_regs<T>(acc, lcol, lw, n, xc, f, on);
      }
      if (on)
        finish_row1<T, false>(acc, uint4{}, -1, 1.f,
                              out + b * out_item + (int64_t)row * f + c0);
    }
    __syncwarp();  // the list is refilled next
  }
}

template <typename T>
int launch_tiles(const Tiles& tl, const void* x, void* out, int n_pad, int f,
                 int batch, cudaStream_t stream) {
  if (f % (16 / (int)sizeof(T))) return -1;
  const dim3 grid((unsigned)((n_pad + TILE_WARPS - 1) / TILE_WARPS));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (batch == 1)
    tile_walk_kernel<T><<<grid, TILE_WARPS * 32, 0, stream>>>(tl, xt, ot, n_pad, f);
  else
    tile_list_kernel<T><<<grid, TILE_WARPS * 32, 0, stream>>>(tl, xt, ot, n_pad, f, batch);
  return (int)cudaGetLastError();
}

}  // namespace

// B14: tile_idx (n_pad / block, tiles_max) int32, n_active (n_pad / block,)
// int32, tnbr (n_pad, tiles_max * tile_degree) uint8 within-tile indices, tw
// the same shape float32, x (batch, x_rows, f), out (batch, n_pad, f).
// dtype 0 = float32, 1 = bfloat16 (x and out). Returns 0, a cudaError_t, or
// -1 for arguments the kernel does not take.
extern "C" int gwen_tile_spmm(const void* tile_idx, const void* n_active,
                              const void* tnbr, const void* tw, const void* x,
                              void* out, int n_pad, int tiles_max,
                              int tile_degree, int block, int f, int x_rows,
                              int batch, int dtype, void* stream) {
  if (n_pad <= 0 || tiles_max <= 0 || tile_degree <= 0 || block <= 0 ||
      block > 256 || n_pad % block || f <= 0 || x_rows <= 0 || batch <= 0 ||
      (int64_t)tiles_max * tile_degree >= (1 << 21))
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Tiles tl{static_cast<const int*>(tile_idx), static_cast<const int*>(n_active),
                 static_cast<const uint8_t*>(tnbr), static_cast<const float*>(tw),
                 tiles_max, tile_degree, block, x_rows, 1.f / (float)tile_degree};
  if (dtype == 0) return launch_tiles<float>(tl, x, out, n_pad, f, batch, st);
  if (dtype == 1) return launch_tiles<__nv_bfloat16>(tl, x, out, n_pad, f, batch, st);
  return -1;
}
