// Windowed SpMM for the diag-window (B1, B4), banded (B3, B10), bit-packed
// (packed B1 and B4, B13), windowed-dense (B11), blocked-ELL (B12) and
// block-tile (B14) layouts.
//
// Replaces these Pallas TPU kernels of the reference package:
//   B1  gwen_tpu/ops/spmm_pallas.py:_diag_kernel     (through _diag_impl)
//   B3  gwen_tpu/ops/spmm_pallas.py:_sliding_kernel  (through _sliding_impl)
// with the window kernel below; B4 (_diag_kernel_b through _diag_impl_b),
// B10 (_sliding_kernel_b through _sliding_impl_b), B13
// (_sliding_packed_kernel through _sliding_packed_impl) and B11
// (_sdense_kernel through _sdense_impl) with the row gathers after it; B12
// (_kernel through _spmm_impl) and B14 (_tile_kernel through
// _spmm_tiles_impl) have sections of their own at the end. The window
// kernel computes, for every 128-row destination block b with window start
// ws_b,
//   out[b*128 + r, :] = sum_{c < W} S[b*128 + r, c] * x[ws_b + c, :]
// in float32, then (B1 only) adds the block's escape fix rows
//   out[esc_rows[j], :] += fix[j, :]   for j in [esc_ptr[b], esc_ptr[b+1])
// and casts once to the output type. The TPU kernels stage x in VMEM (a
// superblock union window for B1, a ring buffer for B3) and place escapes
// with a one-hot matmul; here each CTA reads its own window and places the
// (row-unique) escape rows directly in its shared-memory output tile.
//
// Packed form (PACKED = true; packed B1): S is not read. For rank-1 GCN
// weights S = a_r a_s (.) S01, and the kernel rebuilds it: bit j of word k
// of row i (bits: (N_pad, W / 32) uint32) is S01[i, 32k+j]; the S tile
// entry is S01 * T(a_s[ws_b + c]) (the column scale rounded to the input
// type, as the reference's in-kernel S tile), and each output row is
// multiplied by T(a_r[row]) after the escape rows are added (the escape
// tables of packed graphs carry w = a_s), before the single rounding. The
// bits are 1/16 of bf16 S.
//
// What bounds the window kernel on an H100: bytes, not flops. At L7 (S
// 164864 x 384, F = 256, bf16) one B1 call is 32 GFLOP against ~300 MB of
// S, x and output, about 108 flop/byte, a third of the ridge point. So
// bf16 products run on the tensor cores (WMMA -> mma.sync, float32
// accumulators) to stay far below the memory time, the next chunk's loads
// are issued into registers before the current chunk's products, and the
// grid walks the 64-column tiles of one block consecutively so they share
// its S tile in L2. float32 inputs take a CUDA-core FMA path (full float32,
// no TF32). Yet a row holds about 7 nonzeros of its 384 columns, so 98 % of
// those products are on zeros; the batched forms (B4, packed B4, B10) and
// the RCM bands (1,664-1,792 columns) take the row gathers instead, which
// multiply no zero.
//
// Mixed operands (MIXED = 1): a float32 x on a bfloat16 S, as the
// reference's kernels take it (S is cast to x's type per tile; bf16 ->
// float32 is exact). The S tile is read as bf16 (half the bytes of a float32
// copy) and widened as it is staged; products and output are float32.
// MIXED = 2 is the other way round, a bfloat16 x on a float32 S (the
// partitioned path's dense scatter matrices stay float32), taken by the
// row gather alone: S is read as float32 and each nonzero rounded to bf16,
// again as the reference's kernel casts its tile, with no bf16 copy of S.
// MIXED = 3 is the int8 form of B3 and B10: S holds the 0/1 pattern of a
// rank-1 banded layout as int8 (half the bytes of a bf16 S) and is widened
// to x's type as it is read; the rank-1 scales are applied outside the
// kernel, as in the reference (a . K(a . x)).
//
// Plain C interface, loaded with ctypes (gwen_tpu_torch/ops/spmm_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;  // destination rows per graph block
constexpr int BN = 64;   // feature columns per CTA
constexpr int BK = 32;   // window rows staged per chunk (one bit word)
constexpr int NT = 256;  // threads per CTA (8 warps)
constexpr int LDC = BN + 4;  // float32 output tile row (16-byte multiple)
constexpr int HALF = 16;     // window columns one thread expands per word

template <typename T>
struct Cfg {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  static constexpr int LDA = BK + VEC;        // padded S-chunk row
  static constexpr int LDB = BN + VEC;        // padded x-chunk row
  static constexpr int B_VECS = BK * BN / VEC / NT;
  static constexpr int STAGE_BYTES = (BM * LDA + BK * LDB) * sizeof(T);
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int SMEM_BYTES =
    cmax(cmax(Cfg<float>::STAGE_BYTES, Cfg<__nv_bfloat16>::STAGE_BYTES),
         BM * LDC * (int)sizeof(float));

// Everything a launch passes; pointers the form does not use are null.
struct Args {
  const void* s;             // (N_pad, W) S, unpacked form
  const uint32_t* bits;      // (N_pad, W / 32) S01, packed form
  const float* col_scale;    // a on source rows, packed form
  const float* row_scale;    // a on destination rows, packed form
  const void* x;             // (x_rows, f)
  const int* window_start;   // (num_blocks,)
  const int* esc_ptr;        // (num_blocks + 1,) or null
  const int64_t* esc_rows;   // (n_fix,)
  const void* fix;           // (n_fix, f)
  void* out;                 // (num_blocks * 128, f)
  int n_fc, window, f, x_rows;
};

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

// 16 S-tile entries from half `h` of a bit word: bit (16h + j) selects the
// (rounded) column scale sc[j], else 0. Written as 16-byte vectors.
template <typename T>
__device__ __forceinline__ void expand_half(uint32_t word, int h,
                                            const float* sc, T* dst) {
  __align__(16) T tmp[HALF];
#pragma unroll
  for (int j = 0; j < HALF; ++j)
    tmp[j] = from_f32<T>(((word >> (h * HALF + j)) & 1u) ? sc[j] : 0.f);
#pragma unroll
  for (int v = 0; v < HALF * (int)sizeof(T) / 16; ++v)
    reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(tmp)[v];
}

// S as it lies in memory for an x of type T: T itself, bf16 under a float32
// x (MIXED = 1), float32 under a bf16 x (MIXED = 2, row gather only) or
// int8 (MIXED = 3).
template <typename T, int MIXED>
using s_type = typename std::conditional<
    MIXED == 1, __nv_bfloat16,
    typename std::conditional<
        MIXED == 2, float,
        typename std::conditional<MIXED == 3, int8_t, T>::type>::type>::type;

// One 16-byte vector of S into the staged tile: as it is, its 8 bf16 values
// widened to float32 (MIXED = 1), or its 16 int8 values widened to T
// (MIXED = 3).
template <typename T, int MIXED>
__device__ __forceinline__ void store_s(T* dst, const uint4& raw) {
  if constexpr (MIXED == 3) {
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
    __align__(16) T tmp[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) tmp[e] = from_f32<T>((float)v[e]);
#pragma unroll
    for (int q = 0; q < 16 * (int)sizeof(T) / 16; ++q)
      reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(tmp)[q];
  } else if constexpr (MIXED == 1) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
    *reinterpret_cast<float4*>(dst) =
        make_float4(to_f32(h[0]), to_f32(h[1]), to_f32(h[2]), to_f32(h[3]));
    *reinterpret_cast<float4*>(dst + 4) =
        make_float4(to_f32(h[4]), to_f32(h[5]), to_f32(h[6]), to_f32(h[7]));
  } else {
    *reinterpret_cast<uint4*>(dst) = raw;
  }
}

template <typename T, bool HAS_ESC, bool PACKED, int MIXED = 0>
__global__ void __launch_bounds__(NT) window_spmm_kernel(const Args a) {
  using C = Cfg<T>;
  using TS = s_type<T, MIXED>;
  constexpr int SVEC = 16 / sizeof(TS);          // S elements per vector
  constexpr int SA_VECS = BM * BK / SVEC / NT;   // S vectors per thread
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  T* As = reinterpret_cast<T*>(smem);          // [BM][LDA] S chunk
  T* Bs = As + BM * C::LDA;                    // [BK][LDB] x chunk
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][LDC], after the loop

  const int tid = threadIdx.x;
  const int fc = blockIdx.x % a.n_fc;  // column tile: fastest, shares S in L2
  const int b = blockIdx.x / a.n_fc;   // destination block
  const int window = a.window, f = a.f, x_rows = a.x_rows;
  const int c0 = fc * BN;
  const int64_t row0 = (int64_t)b * BM;
  const int64_t ws = a.window_start[b];
  const TS* s_blk =
      PACKED ? nullptr : static_cast<const TS*>(a.s) + row0 * window;
  const T* x = static_cast<const T*>(a.x);
  T* out = static_cast<T*>(a.out);
  // Packed: thread (pr, ph) expands half ph of row pr's word of each chunk.
  const int pr = tid >> 1, ph = tid & 1;
  const int wpr = window / BK;  // bit words per row

  uint4 ra[SA_VECS], rb[C::B_VECS];
  uint32_t rw = 0;
  float rsc[HALF];
  auto load = [&](int k0) {
    if constexpr (PACKED) {
      rw = a.bits[(row0 + pr) * wpr + k0 / BK];
      const float4* sp = reinterpret_cast<const float4*>(
          a.col_scale + ws + k0 + ph * HALF);
#pragma unroll
      for (int i = 0; i < HALF / 4; ++i) {
        const float4 v = sp[i];
        rsc[4 * i] = v.x;
        rsc[4 * i + 1] = v.y;
        rsc[4 * i + 2] = v.z;
        rsc[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < SA_VECS; ++i) {
        const int v = tid + i * NT;
        const int r = v / (BK / SVEC), cv = v % (BK / SVEC);
        ra[i] = *reinterpret_cast<const uint4*>(s_blk + (int64_t)r * window +
                                                k0 + cv * SVEC);
      }
    }
#pragma unroll
    for (int i = 0; i < C::B_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BN / C::VEC), cv = v % (BN / C::VEC);
      const int64_t xr = ws + k0 + r;
      const int col = c0 + cv * C::VEC;
      rb[i] = (xr < x_rows && col < f)
                  ? *reinterpret_cast<const uint4*>(x + xr * f + col)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto stage = [&]() {
    if constexpr (PACKED) {
      float sc[HALF];
#pragma unroll
      for (int j = 0; j < HALF; ++j) sc[j] = to_f32(from_f32<T>(rsc[j]));
      expand_half<T>(rw, ph, sc, As + pr * C::LDA + ph * HALF);
    } else {
#pragma unroll
      for (int i = 0; i < SA_VECS; ++i) {
        const int v = tid + i * NT;
        const int r = v / (BK / SVEC), cv = v % (BK / SVEC);
        store_s<T, MIXED>(As + r * C::LDA + cv * SVEC, ra[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < C::B_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BN / C::VEC), cv = v % (BN / C::VEC);
      *reinterpret_cast<uint4*>(Bs + r * C::LDB + cv * C::VEC) = rb[i];
    }
  };

  if constexpr (std::is_same<T, float>::value) {
    // CUDA-core path: each thread owns 8 rows x 4 columns.
    const int tx = tid & 15, ty = tid >> 4;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    load(0);
    for (int k0 = 0; k0 < window; k0 += BK) {
      stage();
      __syncthreads();
      if (k0 + BK < window) load(k0 + BK);
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float4 bv = *reinterpret_cast<const float4*>(Bs + k * C::LDB +
                                                           tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = As[(ty * 8 + i) * C::LDA + k];
          acc[i][0] = fmaf(av, bv.x, acc[i][0]);
          acc[i][1] = fmaf(av, bv.y, acc[i][1]);
          acc[i][2] = fmaf(av, bv.z, acc[i][2]);
          acc[i][3] = fmaf(av, bv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(ty * 8 + i) * LDC + tx * 4 + j] = acc[i][j];
  } else {
    // Tensor-core path: warp (wm, wn) owns rows wm*32.. and columns wn*32..
    // as 2 x 2 WMMA 16x16x16 tiles.
    using namespace nvcuda;
    const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    load(0);
    for (int k0 = 0; k0 < window; k0 += BK) {
      stage();
      __syncthreads();
      if (k0 + BK < window) load(k0 + BK);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * C::LDA + kk,
                                 C::LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * C::LDB + wn * 32 + j * 16,
                                 C::LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
  }
  __syncthreads();

  if constexpr (HAS_ESC) {
    // Escape receivers are unique, so no two threads add to one element.
    const T* fix = static_cast<const T*>(a.fix);
    const int j0 = a.esc_ptr[b], j1 = a.esc_ptr[b + 1];
    for (int idx = tid; idx < (j1 - j0) * BN; idx += NT) {
      const int j = j0 + idx / BN, c = idx % BN;
      if (c0 + c < f)
        Cs[(int)(a.esc_rows[j] - row0) * LDC + c] +=
            to_f32(fix[(int64_t)j * f + c0 + c]);
    }
    __syncthreads();
  }

  constexpr int OV = BN / C::VEC;  // output vectors per tile row
  for (int v = tid; v < BM * OV; v += NT) {
    const int r = v / OV, cv = v % OV;
    const int col = c0 + cv * C::VEC;
    if (col < f) {
      const float rs = PACKED ? scale_at<T>(a.row_scale, row0 + r) : 1.f;
      __align__(16) T tmp[C::VEC];
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        tmp[e] = from_f32<T>(PACKED ? Cs[r * LDC + cv * C::VEC + e] * rs
                                    : Cs[r * LDC + cv * C::VEC + e]);
      *reinterpret_cast<uint4*>(out + (row0 + r) * f + col) =
          *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

template <typename T, bool HAS_ESC, bool PACKED, int MIXED = 0>
int launch(const Args& a, int num_blocks, cudaStream_t stream) {
  const dim3 grid((unsigned)a.n_fc * (unsigned)num_blocks);
  window_spmm_kernel<T, HAS_ESC, PACKED, MIXED><<<grid, NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// One launch for dtype code 0 (float32), 1 (bfloat16), 2 (float32 x, fix
// and output on a bfloat16 S; unpacked form only), 4 or 5 (float32 or
// bfloat16 x on an int8 S; no escapes), with or without escapes. -1 for
// arguments the kernel does not take.
template <bool PACKED>
int dispatch(Args a, int num_blocks, int dtype, void* stream) {
  if (num_blocks <= 0 || a.window <= 0 || a.window % BK || a.f <= 0) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool esc = a.esc_ptr != nullptr;
  a.n_fc = (a.f + BN - 1) / BN;
  if (dtype == 0) {
    if (a.f % Cfg<float>::VEC) return -1;
    return esc ? launch<float, true, PACKED>(a, num_blocks, st)
               : launch<float, false, PACKED>(a, num_blocks, st);
  }
  if (dtype == 1) {
    if (a.f % Cfg<__nv_bfloat16>::VEC) return -1;
    return esc ? launch<__nv_bfloat16, true, PACKED>(a, num_blocks, st)
               : launch<__nv_bfloat16, false, PACKED>(a, num_blocks, st);
  }
  if constexpr (!PACKED) {
    if (dtype == 2) {
      if (a.f % Cfg<float>::VEC) return -1;
      return esc ? launch<float, true, false, 1>(a, num_blocks, st)
                 : launch<float, false, false, 1>(a, num_blocks, st);
    }
    if (dtype == 4 && !esc) {
      if (a.f % Cfg<float>::VEC) return -1;
      return launch<float, false, false, 3>(a, num_blocks, st);
    }
    if (dtype == 5 && !esc) {
      if (a.f % Cfg<__nv_bfloat16>::VEC) return -1;
      return launch<__nv_bfloat16, false, false, 3>(a, num_blocks, st);
    }
  }
  return -1;
}

Args make_args(const void* x, const void* window_start, const void* esc_ptr,
               const void* esc_rows, const void* fix, void* out, int window,
               int f, int x_rows) {
  Args a{};
  a.x = x;
  a.window_start = static_cast<const int*>(window_start);
  a.esc_ptr = static_cast<const int*>(esc_ptr);
  a.esc_rows = static_cast<const int64_t*>(esc_rows);
  a.fix = fix;
  a.out = out;
  a.window = window;
  a.f = f;
  a.x_rows = x_rows;
  return a;
}

}  // namespace

// B1 and B3 (x (x_rows, f), out (num_blocks * 128, f), fix (n_fix, f)).
// Returns 0 on success, a cudaError_t from the launch, or -1 for arguments
// the kernel does not take. esc_ptr == NULL means no escapes (B3).
// dtype: 0 = float32, 1 = bfloat16, 2 = float32 x on a bfloat16 S, 4 and 5
// = float32 and bfloat16 x on an int8 S (no escapes).
extern "C" int gwen_window_spmm(const void* s, const void* x,
                                const void* window_start, const void* esc_ptr,
                                const void* esc_rows, const void* fix,
                                void* out, int num_blocks, int window, int f,
                                int x_rows, int dtype, void* stream) {
  Args a = make_args(x, window_start, esc_ptr, esc_rows, fix, out, window, f,
                     x_rows);
  a.s = s;
  return dispatch<false>(a, num_blocks, dtype, stream);
}

// Packed B1: bits (num_blocks * 128, window / 32) uint32, col_scale and
// row_scale float32 (a on source and destination rows); dtype 0 or 1. Shapes
// and return codes as gwen_window_spmm.
extern "C" int gwen_window_spmm_packed(
    const void* bits, const void* col_scale, const void* row_scale,
    const void* x, const void* window_start, const void* esc_ptr,
    const void* esc_rows, const void* fix, void* out, int num_blocks,
    int window, int f, int x_rows, int dtype, void* stream) {
  Args a = make_args(x, window_start, esc_ptr, esc_rows, fix, out, window, f,
                     x_rows);
  a.bits = static_cast<const uint32_t*>(bits);
  a.col_scale = static_cast<const float*>(col_scale);
  a.row_scale = static_cast<const float*>(row_scale);
  return dispatch<true>(a, num_blocks, dtype, stream);
}

// ------------------------------------------------------------ row gathers
//
// B4 and packed B4, replacing gwen_tpu/ops/spmm_pallas.py:_diag_kernel_b
// (through _diag_impl_b, both branches of its `packed` flag); B10, replacing
// _sliding_kernel_b (through _sliding_impl_b); B13, replacing
// _sliding_packed_kernel (through _sliding_packed_impl); and B11, replacing
// _sdense_kernel (through _sdense_impl). B3 takes the dense gather too on a
// wide window (the RCM band of a partition, the int8 rank-1 band). The TPU
// kernels multiply the whole window on the MXU because they cannot gather
// rows, and at L7 a row holds about 7 nonzeros of a window of 384 (KD
// order: B4, B10 on the esc2 graph), 1,664 (B11, B10 on an RCM band) or
// 1,792 (B13) columns, so > 98 % of those products are on zeros. The math
// is the gather-scale-sum of B12,
//   dense:  acc[i] = sum_{c < W, S[i, c] != 0} T(S[i, c]) * x[ws + c]
//   packed: acc[i] = sum_{bit c of row i set} T(a_s[ws + c]) * x[ws + c]
//   acc[i] += fix[j]  if esc_rows[j] == i, j in [esc_ptr[b], esc_ptr[b+1])
//   out[i] = round(acc[i] * (packed ? T(a_r[i]) : 1))
// with b = i / block and ws = window_start[b] (the graph's own block size;
// B11's starts are absolute and need not be monotone), float32 sums in
// ascending column order, the fix added before the row scale (the escape
// tables of packed graphs carry w = a_s), one rounding, and sources at or
// past x_rows read as zero. T() rounds to x's type first, as the reference
// casts its tile. A row with no nonzero and no escape writes zeros.
//
// The design: one warp per destination row, which walks the nonzeros
// instead of the window. The packed gather reads the row's W / 32 bit words
// once, one word a lane (12 at L7 on the diag layout, 56 on the band); the
// dense gather streams its S row once with coalesced 16-byte loads,
// evict-first, four vectors a lane issued together (48 vectors of bf16 S on
// the diag layout, 208 on the band), and a lane masks its vectors'
// nonzeros. A ballot picks the lanes (words, vectors) with a nonzero; the
// warp walks them in ascending order, broadcasts each one's word or vector
// with shuffles and walks its nonzeros, so a row with any number of
// nonzeros (a hub) is right and nothing is staged in shared memory. Each
// nonzero's x row is read with one 16-byte load a lane for every batch item
// (up to four held in registers), so the bits, scales and S are decoded
// once per call for a batch of up to four, not once per item, and S leaves
// device memory once (a larger batch, or F over one pass of 32 vectors, 256
// bf16 or 128 float32 values, decodes the row again per group of four and
// per pass, mostly from L2). No product is taken on a zero. The escape
// epilogue (HAS_ESC) finds the row's slot once: a block's receivers are
// unique and sorted (about 8 a block at L7), and the warp compares 32 of
// them a round with one ballot; the row's fix row is then added for each
// item like one more nonzero of weight 1. The escape instantiations take
// more registers a thread than the others, so fewer CTAs fit an SM; capping
// them with launch bounds trades that for spills and was not faster at
// every batch size.
//
// What bounds it: bytes. The packed gather reads the bits (7.9 MB on the L7
// diag layout, 35 MB on the band), the scales and x (mostly from L2: a row
// is gathered by its ~7 neighbours, once per batch item) and writes the
// output; the dense gather must read S as stored (126.6 MB bf16 on the L7
// diag layout, 545.7 MB bf16, 1.09 GB float32 and 273 MB int8 on the band),
// a floor no kernel on such a layout can pass, plus x, the fix rows and the
// output. On the diag layout S is the smaller part: the gathered x rows
// (about 2.3 GB a batch-4 call, from L2) and the warps in flight set the
// time.

namespace {

// Destination rows per CTA: small CTAs fit more warps on an SM at the
// ~90 registers a thread of the batch-4 kernels takes.
constexpr int ROW_WARPS = 4;
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

// The slot j of destination `row` (esc.rows[j] == row) in its block's range,
// or -1. The whole warp takes part: 32 receivers a round, one ballot each.
__device__ __forceinline__ int escape_slot(const Escapes& esc, int64_t row,
                                           int64_t b, int lane) {
  const int j0 = esc.ptr[b], j1 = esc.ptr[b + 1];
  for (int k = j0; k < j1; k += 32) {
    const int j = k + lane;
    const unsigned hit = __ballot_sync(FULL, j < j1 && esc.rows[j] == row);
    if (hit) return k + __ffs(hit) - 1;
  }
  return -1;
}

// Adds one nonzero, weight w on the source row whose 16-byte column vector
// (item 0) is at xr, for the nb (<= NB) batch items, item stride `item`.
// The items' loads are issued together.
template <typename T, int NB>
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
template <typename T, int NB, bool HAS_ESC>
__device__ __forceinline__ void finish_row(float (&acc)[NB][16 / sizeof(T)],
                                           const Escapes& esc, int slot,
                                           int b0, int c0, int f, float rs,
                                           T* __restrict__ out,
                                           int64_t out_item, int nb) {
  constexpr int VEC = 16 / sizeof(T);
  if constexpr (HAS_ESC) {
    if (slot >= 0) {
      const int64_t fix_item = (int64_t)esc.n_fix * f;
      add_row<T, NB>(acc, 1.f,
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

// B13 and packed B4: bits (n_pad, words) S01, window-relative, as the
// packed window kernel reads them; col_scale and row_scale a on source and
// destination rows.
template <typename T, int NB, bool HAS_ESC>
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
              add_row<T, NB>(acc, scale_at<T>(col_scale, src),
                             xb + (int64_t)src * f, item, nb);
          }
        }
      }
      if (on)
        finish_row<T, NB, HAS_ESC>(acc, esc, slot, b0, c0, f, rs,
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

// B4, B10, B11 (and B3 on a wide window): S (n_pad, window) window-relative
// in the type the operand mode names (s_type).
template <typename T, int MIXED, int NB, bool HAS_ESC>
__global__ void __launch_bounds__(ROW_WARPS * 32)
dense_rows_kernel(const void* __restrict__ s, const int* __restrict__ window_start,
                  const T* __restrict__ x, T* __restrict__ out, const Escapes esc,
                  int n_pad, int window, int block, int f, int x_rows, int batch) {
  using TS = s_type<T, MIXED>;
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
                add_row<T, NB>(acc, s_entry<T, MIXED>(v, e),
                               xb + (int64_t)(col0 + e) * f, item, nb);
            }
          }
        }
      }
      if (on)
        finish_row<T, NB, HAS_ESC>(acc, esc, slot, b0, c0, f, 1.f,
                                   out + b0 * out_item + row * f + c0, out_item, nb);
    }
  }
}

// The batch rides inside the warp: up to NB = 4 items a pass (one pass
// for the train-mesh shape), 1 for an unbatched call.
template <typename T, int MIXED, bool HAS_ESC>
int launch_dense_rows(const void* s, const int* ws, const void* x, void* out,
                      const Escapes& esc, int n_pad, int window, int block,
                      int f, int x_rows, int batch, cudaStream_t st) {
  const dim3 grid((unsigned)((n_pad + ROW_WARPS - 1) / ROW_WARPS));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (batch == 1)
    dense_rows_kernel<T, MIXED, 1, HAS_ESC><<<grid, ROW_WARPS * 32, 0, st>>>(
        s, ws, xt, ot, esc, n_pad, window, block, f, x_rows, batch);
  else
    dense_rows_kernel<T, MIXED, 4, HAS_ESC><<<grid, ROW_WARPS * 32, 0, st>>>(
        s, ws, xt, ot, esc, n_pad, window, block, f, x_rows, batch);
  return (int)cudaGetLastError();
}

// Escapes in the modes B4 takes: S in x's type, or bf16 S under a float32
// x (MIXED 0 and 1); the other modes take none.
template <typename T, int MIXED>
int dense_rows(const void* s, const int* ws, const void* x, void* out,
               const Escapes& esc, int n_pad, int window, int block, int f,
               int x_rows, int batch, cudaStream_t st) {
  if (f % (16 / (int)sizeof(T))) return -1;
  if (esc.ptr == nullptr)
    return launch_dense_rows<T, MIXED, false>(s, ws, x, out, esc, n_pad, window,
                                              block, f, x_rows, batch, st);
  if constexpr (MIXED <= 1)
    return launch_dense_rows<T, MIXED, true>(s, ws, x, out, esc, n_pad, window,
                                             block, f, x_rows, batch, st);
  return -1;
}

template <typename T, bool HAS_ESC>
int launch_packed_rows(const uint32_t* bits, const float* col_scale,
                       const float* row_scale, const int* ws, const void* x,
                       void* out, const Escapes& esc, int n_pad, int words,
                       int block, int f, int x_rows, int batch, cudaStream_t st) {
  const dim3 grid((unsigned)((n_pad + ROW_WARPS - 1) / ROW_WARPS));
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (batch == 1)
    packed_rows_kernel<T, 1, HAS_ESC><<<grid, ROW_WARPS * 32, 0, st>>>(
        bits, col_scale, row_scale, ws, xt, ot, esc, n_pad, words, block, f,
        x_rows, batch);
  else
    packed_rows_kernel<T, 4, HAS_ESC><<<grid, ROW_WARPS * 32, 0, st>>>(
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

// B4, B10, B11, and B3 on a wide window: S (n_pad, window) window-relative,
// window_start (n_pad / block,) int32 absolute starts, x (batch, x_rows, f)
// with x_rows up to the layout's source rows, out (batch, n_pad, f). B4's
// escapes: esc_ptr (n_pad / block + 1,) int32, esc_rows (n_fix,) int64,
// fix (batch, n_fix, f) in x's type; esc_ptr == NULL means none. dtype as
// gwen_window_spmm, and 3 = bfloat16 x on a float32 S; escapes with dtype 0,
// 1 and 2 only. Return codes as gwen_window_spmm.
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

// B13 and packed B4: bits (n_pad, words) int32 S01, col_scale and row_scale
// float32, window_start (n_pad / block,) int32, x (batch, x_rows, f), out
// (batch, n_pad, f); escapes as gwen_window_spmm_streamed. dtype 0 =
// float32, 1 = bfloat16. Return codes as gwen_window_spmm.
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
// with b = i / block, and that is what this kernel does, reading the BSR
// tables as they are: one warp per destination row and batch member; the
// warp reads the row's slots of the block's ACTIVE tiles only (n_active[b]
// * D of the tiles_max * D stored), 32 at a time, one per lane, each lane
// resolving its slot's tile base from tile_idx; a ballot picks the slots
// with a nonzero weight (about 7 of 56 on an icosphere) and only those are
// broadcast and gathered, each source row with 16-byte loads, float32
// accumulation in slot order (no atomics, a fixed order of summation), one
// rounding. Each slot's weight is rounded to x's type first, as the
// reference casts its tile; the reference's tile holds the sum of the slots
// of one row that name the same source and rounds that sum, so for a bf16 x
// the two differ on a graph with duplicate edges (no mesh has any). Sources
// at or past x_rows read as zero.
//
// Why not one CTA per block staging its active tiles in shared memory (the
// reuse the layout was made for on the TPU): on a mesh a block's 128 rows
// make about 900 gathers from about 8 tiles of 128 rows, so a staged row is
// used about once; staging reads as much as gathering and adds a barrier
// per tile. L2 already serves the rows that neighbours share.
//
// What bounds it: bytes. Per row it reads n_active * D slots of 5 bytes
// (uint8 index, float32 weight), gathers about 7 rows of x (mostly from L2)
// and writes one row.

namespace {

constexpr int TILE_WARPS = 8;  // destination rows per CTA

template <typename T>
__global__ void __launch_bounds__(TILE_WARPS * 32)
tile_spmm_kernel(const int* __restrict__ tile_idx,
                 const int* __restrict__ n_active,
                 const uint8_t* __restrict__ tnbr, const float* __restrict__ tw,
                 const T* __restrict__ x, T* __restrict__ out, int n_pad,
                 int tiles_max, int tile_degree, int block, int f, int x_rows) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * TILE_WARPS + (threadIdx.x >> 5);
  if (row >= n_pad) return;
  const int bi = blockIdx.y;
  const T* xb = x + (int64_t)bi * x_rows * f;
  T* ob = out + ((int64_t)bi * n_pad + row) * f;
  const int b = (int)(row / block);
  const int flat = tiles_max * tile_degree;
  const int n_slots = min(n_active[b], tiles_max) * tile_degree;
  const int* tiles = tile_idx + (int64_t)b * tiles_max;
  const uint8_t* nbr_row = tnbr + row * flat;
  const float* w_row = tw + row * flat;

  // The whole warp walks the column passes together (the ballot and the
  // shuffles below need every lane); a lane past F only skips its loads
  // and its store.
  for (int cb = 0; cb < f; cb += 32 * VEC) {
    const int c0 = cb + lane * VEC;
    const bool on = c0 < f;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int k0 = 0; k0 < n_slots; k0 += 32) {
      // Lane l holds slot k0 + l of the row.
      const int k = k0 + lane;
      float my_w = 0.f;
      int my_src = 0;
      if (k < n_slots) {
        my_w = scale_at<T>(w_row, k);
        my_src = tiles[k / tile_degree] * block + (int)nbr_row[k];
      }
      unsigned live =
          __ballot_sync(0xffffffffu, my_w != 0.f && my_src < x_rows);
      while (live) {  // ascending slots: a fixed order of summation
        const int j = __ffs(live) - 1;
        live &= live - 1;
        const float wv = __shfl_sync(0xffffffffu, my_w, j);
        const int64_t src = __shfl_sync(0xffffffffu, my_src, j);
        if (!on) continue;
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
int launch_tiles(const int* tile_idx, const int* n_active, const uint8_t* tnbr,
                 const float* tw, const void* x, void* out, int n_pad,
                 int tiles_max, int tile_degree, int block, int f, int x_rows,
                 int batch, cudaStream_t stream) {
  if (f % (16 / (int)sizeof(T))) return -1;
  const dim3 grid((unsigned)((n_pad + TILE_WARPS - 1) / TILE_WARPS),
                  (unsigned)batch);
  tile_spmm_kernel<T><<<grid, TILE_WARPS * 32, 0, stream>>>(
      tile_idx, n_active, tnbr, tw, static_cast<const T*>(x),
      static_cast<T*>(out), n_pad, tiles_max, tile_degree, block, f, x_rows);
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
      batch > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ti = static_cast<const int*>(tile_idx);
  const int* na = static_cast<const int*>(n_active);
  const uint8_t* nb = static_cast<const uint8_t*>(tnbr);
  const float* wp = static_cast<const float*>(tw);
  if (dtype == 0)
    return launch_tiles<float>(ti, na, nb, wp, x, out, n_pad, tiles_max,
                               tile_degree, block, f, x_rows, batch, st);
  if (dtype == 1)
    return launch_tiles<__nv_bfloat16>(ti, na, nb, wp, x, out, n_pad, tiles_max,
                                       tile_degree, block, f, x_rows, batch, st);
  return -1;
}
