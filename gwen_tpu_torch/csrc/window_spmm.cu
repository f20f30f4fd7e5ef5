// Windowed SpMM for the diag-window (B1) and banded (B3) layouts.
//
// Replaces two Pallas TPU kernels of the reference package:
//   B1  gwen_tpu/ops/spmm_pallas.py:_diag_kernel     (through _diag_impl)
//   B3  gwen_tpu/ops/spmm_pallas.py:_sliding_kernel  (through _sliding_impl)
// Both compute, for every 128-row destination block b with window start ws_b,
//   out[b*128 + r, :] = sum_{c < W} S[b*128 + r, c] * x[ws_b + c, :]
// in float32, then (B1 only) add the block's escape fix rows
//   out[esc_rows[j], :] += fix[j, :]   for j in [esc_ptr[b], esc_ptr[b+1])
// and cast once to the output type. The TPU kernels stage x in VMEM (a
// superblock union window for B1, a ring buffer for B3) and place escapes
// with a one-hot matmul; here each CTA reads its own window and places the
// (row-unique) escape rows directly in its shared-memory output tile.
//
// What bounds it on an H100: bytes, not flops. At L7 (S 164864 x 384,
// F = 256, bf16) one call is 32 GFLOP against ~300 MB of S, x and output,
// about 108 flop/byte, a third of the ridge point. So bf16 products run on
// the tensor cores (WMMA -> mma.sync, float32 accumulators) to stay far
// below the memory time, the next chunk's loads are issued into registers
// before the current chunk's products, and the grid walks the 64-column
// tiles of one block consecutively so they share its S tile in L2.
// float32 inputs take a CUDA-core FMA path (full float32, no TF32).
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
constexpr int BK = 32;   // window rows staged per chunk
constexpr int NT = 256;  // threads per CTA (8 warps)
constexpr int LDC = BN + 4;  // float32 output tile row (16-byte multiple)

template <typename T>
struct Cfg {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  static constexpr int LDA = BK + VEC;        // padded S-chunk row
  static constexpr int LDB = BN + VEC;        // padded x-chunk row
  static constexpr int A_VECS = BM * BK / VEC / NT;
  static constexpr int B_VECS = BK * BN / VEC / NT;
  static constexpr int STAGE_BYTES = (BM * LDA + BK * LDB) * sizeof(T);
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int SMEM_BYTES =
    cmax(cmax(Cfg<float>::STAGE_BYTES, Cfg<__nv_bfloat16>::STAGE_BYTES),
         BM * LDC * (int)sizeof(float));

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

template <typename T, bool HAS_ESC>
__global__ void __launch_bounds__(NT)
window_spmm_kernel(const T* __restrict__ s, const T* __restrict__ x,
                   const int* __restrict__ window_start,
                   const int* __restrict__ esc_ptr,
                   const int64_t* __restrict__ esc_rows,
                   const T* __restrict__ fix, T* __restrict__ out, int n_fc,
                   int window, int f, int x_rows) {
  using C = Cfg<T>;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  T* As = reinterpret_cast<T*>(smem);          // [BM][LDA] S chunk
  T* Bs = As + BM * C::LDA;                    // [BK][LDB] x chunk
  float* Cs = reinterpret_cast<float*>(smem);  // [BM][LDC], after the loop

  const int tid = threadIdx.x;
  const int fc = blockIdx.x % n_fc;  // column tile: fastest, shares S in L2
  const int b = blockIdx.x / n_fc;   // destination block
  const int c0 = fc * BN;
  const int64_t row0 = (int64_t)b * BM;
  const int64_t ws = window_start[b];
  const T* s_blk = s + row0 * window;

  uint4 ra[C::A_VECS], rb[C::B_VECS];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < C::A_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BK / C::VEC), cv = v % (BK / C::VEC);
      ra[i] = *reinterpret_cast<const uint4*>(s_blk + (int64_t)r * window +
                                              k0 + cv * C::VEC);
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
#pragma unroll
    for (int i = 0; i < C::A_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BK / C::VEC), cv = v % (BK / C::VEC);
      *reinterpret_cast<uint4*>(As + r * C::LDA + cv * C::VEC) = ra[i];
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
          const float a = As[(ty * 8 + i) * C::LDA + k];
          acc[i][0] = fmaf(a, bv.x, acc[i][0]);
          acc[i][1] = fmaf(a, bv.y, acc[i][1]);
          acc[i][2] = fmaf(a, bv.z, acc[i][2]);
          acc[i][3] = fmaf(a, bv.w, acc[i][3]);
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
    const int j0 = esc_ptr[b], j1 = esc_ptr[b + 1];
    for (int idx = tid; idx < (j1 - j0) * BN; idx += NT) {
      const int j = j0 + idx / BN, c = idx % BN;
      if (c0 + c < f)
        Cs[(int)(esc_rows[j] - row0) * LDC + c] +=
            to_f32(fix[(int64_t)j * f + c0 + c]);
    }
    __syncthreads();
  }

  constexpr int OV = BN / C::VEC;  // output vectors per tile row
  for (int v = tid; v < BM * OV; v += NT) {
    const int r = v / OV, cv = v % OV;
    const int col = c0 + cv * C::VEC;
    if (col < f) {
      __align__(16) T tmp[C::VEC];
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        tmp[e] = from_f32<T>(Cs[r * LDC + cv * C::VEC + e]);
      *reinterpret_cast<uint4*>(out + (row0 + r) * f + col) =
          *reinterpret_cast<const uint4*>(tmp);
    }
  }
}

template <typename T, bool HAS_ESC>
int launch(const void* s, const void* x, const int* window_start,
           const int* esc_ptr, const int64_t* esc_rows, const void* fix,
           void* out, int num_blocks, int window, int f, int x_rows,
           cudaStream_t stream) {
  const int n_fc = (f + BN - 1) / BN;
  const dim3 grid((unsigned)n_fc * (unsigned)num_blocks);
  window_spmm_kernel<T, HAS_ESC><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(x), window_start,
      esc_ptr, esc_rows, static_cast<const T*>(fix), static_cast<T*>(out),
      n_fc, window, f, x_rows);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- batched
//
// B4 and B10: the same product on x (B, x_rows, F) -> out (B, N_pad, F),
// replacing gwen_tpu/ops/spmm_pallas.py:_diag_kernel_b (through
// _diag_impl_b) and _sliding_kernel_b (through _sliding_impl_b). What the
// batched TPU kernels buy is that S is streamed once per destination block
// and reused for every batch member. Here each CTA copies its whole S tile
// (128 x W) into shared memory once, then loops over the batch, streaming
// only x chunks. The escape rows of a block are the same fix-array range
// for every member; fix is (B, U, F).
//
// Shared memory: the S tile (row padded by one 16-byte vector), one x chunk
// and, for bf16, the float32 output tile the escape rows are added into
// before the single rounding. float32 outputs need no rounding, so they are
// stored straight from registers and the escape rows added in place after a
// barrier (the CTA owns those rows and columns); that keeps the float32 tile
// at W = 384 inside the 227 KB a block may use.

template <typename T>
constexpr int batched_smem_bytes(int window) {
  using C = Cfg<T>;
  return BM * (window + C::VEC) * (int)sizeof(T) + BK * C::LDB * (int)sizeof(T) +
         (std::is_same<T, float>::value ? 0 : BM * LDC * (int)sizeof(float));
}

template <typename T, bool HAS_ESC>
__global__ void __launch_bounds__(NT)
window_spmm_batched_kernel(const T* __restrict__ s, const T* __restrict__ x,
                           const int* __restrict__ window_start,
                           const int* __restrict__ esc_ptr,
                           const int64_t* __restrict__ esc_rows,
                           const T* __restrict__ fix, T* __restrict__ out,
                           int n_fc, int window, int f, int x_rows, int batch,
                           int n_fix, int64_t n_pad) {
  using C = Cfg<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lds = window + C::VEC;             // padded S-tile row
  T* Ss = reinterpret_cast<T*>(smem);          // [BM][lds] whole S tile
  T* Bs = Ss + BM * lds;                       // [BK][LDB] x chunk
  float* Cs = reinterpret_cast<float*>(Bs + BK * C::LDB);  // [BM][LDC], bf16

  const int tid = threadIdx.x;
  const int fc = blockIdx.x % n_fc;
  const int b = blockIdx.x / n_fc;
  const int c0 = fc * BN;
  const int64_t row0 = (int64_t)b * BM;
  const int64_t ws = window_start[b];

  // Stage the S tile once.
  {
    const T* s_blk = s + row0 * window;
    const int vpr = window / C::VEC;
    for (int v = tid; v < BM * vpr; v += NT) {
      const int r = v / vpr, cv = v % vpr;
      *reinterpret_cast<uint4*>(Ss + r * lds + cv * C::VEC) =
          *reinterpret_cast<const uint4*>(s_blk + (int64_t)r * window +
                                          cv * C::VEC);
    }
  }

  int j0 = 0, j1 = 0;
  if constexpr (HAS_ESC) {
    j0 = esc_ptr[b];
    j1 = esc_ptr[b + 1];
  }

  for (int bi = 0; bi < batch; ++bi) {
    const T* xb = x + (int64_t)bi * x_rows * f;
    T* ob = out + (int64_t)bi * n_pad * f;
    uint4 rb[C::B_VECS];
    auto load = [&](int k0) {
#pragma unroll
      for (int i = 0; i < C::B_VECS; ++i) {
        const int v = tid + i * NT;
        const int r = v / (BN / C::VEC), cv = v % (BN / C::VEC);
        const int64_t xr = ws + k0 + r;
        const int col = c0 + cv * C::VEC;
        rb[i] = (xr < x_rows && col < f)
                    ? *reinterpret_cast<const uint4*>(xb + xr * f + col)
                    : make_uint4(0u, 0u, 0u, 0u);
      }
    };
    auto stage = [&]() {
#pragma unroll
      for (int i = 0; i < C::B_VECS; ++i) {
        const int v = tid + i * NT;
        const int r = v / (BN / C::VEC), cv = v % (BN / C::VEC);
        *reinterpret_cast<uint4*>(Bs + r * C::LDB + cv * C::VEC) = rb[i];
      }
    };

    if constexpr (std::is_same<T, float>::value) {
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
          const float4 bv =
              *reinterpret_cast<const float4*>(Bs + k * C::LDB + tx * 4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float a = Ss[(ty * 8 + i) * lds + k0 + k];
            acc[i][0] = fmaf(a, bv.x, acc[i][0]);
            acc[i][1] = fmaf(a, bv.y, acc[i][1]);
            acc[i][2] = fmaf(a, bv.z, acc[i][2]);
            acc[i][3] = fmaf(a, bv.w, acc[i][3]);
          }
        }
        __syncthreads();
      }
      const int col = c0 + tx * 4;
      if (col < f) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<float4*>(ob + (row0 + ty * 8 + i) * f + col) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      if constexpr (HAS_ESC) {
        __syncthreads();  // the tile's stores are visible to the block
        const T* fb = fix + (int64_t)bi * n_fix * f;
        for (int idx = tid; idx < (j1 - j0) * BN; idx += NT) {
          const int j = j0 + idx / BN, c = idx % BN;
          if (c0 + c < f) ob[esc_rows[j] * f + c0 + c] += fb[(int64_t)j * f + c0 + c];
        }
      }
    } else {
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
            wmma::load_matrix_sync(fa[i], Ss + (wm * 32 + i * 16) * lds + k0 + kk,
                                   lds);
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
          wmma::store_matrix_sync(
              Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
              wmma::mem_row_major);
      __syncthreads();
      if constexpr (HAS_ESC) {
        const T* fb = fix + (int64_t)bi * n_fix * f;
        for (int idx = tid; idx < (j1 - j0) * BN; idx += NT) {
          const int j = j0 + idx / BN, c = idx % BN;
          if (c0 + c < f)
            Cs[(int)(esc_rows[j] - row0) * LDC + c] +=
                to_f32(fb[(int64_t)j * f + c0 + c]);
        }
        __syncthreads();
      }
      constexpr int OV = BN / C::VEC;
      for (int v = tid; v < BM * OV; v += NT) {
        const int r = v / OV, cv = v % OV;
        const int col = c0 + cv * C::VEC;
        if (col < f) {
          __align__(16) T tmp[C::VEC];
#pragma unroll
          for (int e = 0; e < C::VEC; ++e)
            tmp[e] = from_f32<T>(Cs[r * LDC + cv * C::VEC + e]);
          *reinterpret_cast<uint4*>(ob + (row0 + r) * f + col) =
              *reinterpret_cast<const uint4*>(tmp);
        }
      }
      // The next member's first stores into Cs come after its k-loop,
      // whose barriers order them after these reads.
    }
  }
}

template <typename T, bool HAS_ESC>
int launch_batched(const void* s, const void* x, const int* window_start,
                   const int* esc_ptr, const int64_t* esc_rows,
                   const void* fix, void* out, int num_blocks, int window,
                   int f, int x_rows, int batch, int n_fix,
                   cudaStream_t stream) {
  const int smem = batched_smem_bytes<T>(window);
  auto kernel = window_spmm_batched_kernel<T, HAS_ESC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_fc = (f + BN - 1) / BN;
  const dim3 grid((unsigned)n_fc * (unsigned)num_blocks);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(x), window_start,
      esc_ptr, esc_rows, static_cast<const T*>(fix), static_cast<T*>(out),
      n_fc, window, f, x_rows, batch, n_fix, (int64_t)num_blocks * BM);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t from the launch, or -1 for arguments
// the kernel does not take. esc_ptr == NULL means no escapes (B3).
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int gwen_window_spmm(const void* s, const void* x,
                                const void* window_start, const void* esc_ptr,
                                const void* esc_rows, const void* fix,
                                void* out, int num_blocks, int window, int f,
                                int x_rows, int dtype, void* stream) {
  if (num_blocks <= 0 || window <= 0 || window % BK || f <= 0) return -1;
  const int* ws = static_cast<const int*>(window_start);
  const int* ep = static_cast<const int*>(esc_ptr);
  const int64_t* er = static_cast<const int64_t*>(esc_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool esc = esc_ptr != nullptr;
  if (dtype == 0) {
    if (f % Cfg<float>::VEC) return -1;
    return esc ? launch<float, true>(s, x, ws, ep, er, fix, out, num_blocks,
                                     window, f, x_rows, st)
               : launch<float, false>(s, x, ws, ep, er, fix, out, num_blocks,
                                      window, f, x_rows, st);
  }
  if (dtype == 1) {
    if (f % Cfg<__nv_bfloat16>::VEC) return -1;
    return esc ? launch<__nv_bfloat16, true>(s, x, ws, ep, er, fix, out,
                                             num_blocks, window, f, x_rows, st)
               : launch<__nv_bfloat16, false>(s, x, ws, ep, er, fix, out,
                                              num_blocks, window, f, x_rows,
                                              st);
  }
  return -1;
}

// Shared memory one CTA of the batched kernel needs for a window of
// `window` rows (dtype as below); the wrapper refuses windows over the
// 232,448 bytes a block may use.
extern "C" int gwen_window_spmm_batched_smem(int window, int dtype) {
  if (dtype == 0) return batched_smem_bytes<float>(window);
  if (dtype == 1) return batched_smem_bytes<__nv_bfloat16>(window);
  return -1;
}

// Batched form (B4 with escapes, B10 without): x is (batch, x_rows, f),
// out (batch, num_blocks * 128, f), fix (batch, n_fix, f). Return codes as
// gwen_window_spmm.
extern "C" int gwen_window_spmm_batched(
    const void* s, const void* x, const void* window_start,
    const void* esc_ptr, const void* esc_rows, const void* fix, void* out,
    int num_blocks, int window, int f, int x_rows, int batch, int n_fix,
    int dtype, void* stream) {
  if (num_blocks <= 0 || window <= 0 || window % BK || f <= 0 || batch <= 0)
    return -1;
  const int* ws = static_cast<const int*>(window_start);
  const int* ep = static_cast<const int*>(esc_ptr);
  const int64_t* er = static_cast<const int64_t*>(esc_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool esc = esc_ptr != nullptr;
  if (dtype == 0) {
    if (f % Cfg<float>::VEC) return -1;
    return esc ? launch_batched<float, true>(s, x, ws, ep, er, fix, out,
                                             num_blocks, window, f, x_rows,
                                             batch, n_fix, st)
               : launch_batched<float, false>(s, x, ws, ep, er, fix, out,
                                              num_blocks, window, f, x_rows,
                                              batch, n_fix, st);
  }
  if (dtype == 1) {
    if (f % Cfg<__nv_bfloat16>::VEC) return -1;
    return esc ? launch_batched<__nv_bfloat16, true>(
                     s, x, ws, ep, er, fix, out, num_blocks, window, f,
                     x_rows, batch, n_fix, st)
               : launch_batched<__nv_bfloat16, false>(
                     s, x, ws, ep, er, fix, out, num_blocks, window, f,
                     x_rows, batch, n_fix, st);
  }
  return -1;
}
