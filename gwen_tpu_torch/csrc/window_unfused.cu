// The unfused attention operators on the diag-window layout: SDDMM (B8) and
// the transpose SpMM (B9, B9b).
//
// Replaces these Pallas TPU kernels of the reference package:
//   B8  gwen_tpu/ops/attention_pallas.py:_sddmm_kernel    (through _sddmm_impl)
//   B9  gwen_tpu/ops/attention_pallas.py:_spmm_t_kernel   (through _spmm_t_impl)
//   B9b gwen_tpu/ops/attention_pallas.py:_spmm_t_kernel_b (through
//       _spmm_t_impl_b)
//
// B8, for every 128-row destination block blk with window start ws:
//   out[blk*128 + r, j] = sum_f a[blk*128 + r, f] * b[ws + j, f],  j < W
// in float32 (bf16 operands on the tensor cores with float32 accumulators,
// float32 operands on the CUDA cores at full precision, no TF32). The TPU
// kernel stages a superblock's union window of b in VMEM and chunks the
// feature axis at 512 outside the kernel; here one CTA owns a (128 x 64)
// tile of the score matrix and loops over f in slices of 32 inside the
// kernel, so its shared memory is fixed (under 28 KB) whatever f is.
//
// B9 and B9b, for every 128-row source block c:
//   out[c*128 + jj, :] = sum over the destination blocks j in
//       [t_lo[c], t_lo[c] + t_cnt[c]) and their rows i of
//       s[j*128 + i, c*128 - ws_j + jj] * g[j*128 + i, :]
// for a runtime, asymmetric tile s (N_pad, W). Window starts are multiples
// of 128 and W is a multiple of 128, so each covering block contributes one
// full (128 x 128) tile of s at column offset c*128 - ws_j. One CTA owns a
// (128 source rows x 64 features) output tile and walks its covering blocks
// itself: no atomics and a fixed order of summation. The TPU kernel keeps
// the running sum in VMEM scratch across the tiles of one grid step; here it
// stays in registers. The items (B9b: s and g both per item) are the grid's
// second axis, so one kernel serves both.
//
// What bounds them on an H100: bytes. B8 at L7 (W 384, f 128, bf16) does
// 16 GFLOP against 253 MB of float32 scores written; B9 reads 127 MB of s
// for 16 GFLOP. Both are an order under the ~295 flop/byte ridge, so the
// products only have to stay out of the way: WMMA (mma.sync) for bf16, with
// the next chunk's loads issued into registers before the current chunk's
// products. The grid walks the tiles that share an operand (the a tile for
// B8's six window tiles, the s tile for B9's feature tiles) next to each
// other so the second reader finds it in L2.
//
// Plain C interface, loaded with ctypes (gwen_tpu_torch/ops/unfused_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;  // rows per graph block (destination or source)
constexpr int BN = 64;   // output columns per CTA
constexpr int BK = 32;   // contraction rows staged per chunk
constexpr int NT = 256;  // threads per CTA (8 warps)
constexpr int LDC = BN + 4;  // float32 output tile row (B9, bf16)

template <typename T>
struct Cfg {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  // B8: a chunk [BM][BK], b chunk [BN][BK] (bf16) or transposed [BK][BN]
  // (float32), rows padded by one vector.
  static constexpr int LDK = BK + VEC;
  static constexpr int LDT = BN + VEC;
  static constexpr int A8_VECS = BM * BK / VEC / NT;
  static constexpr int B8_VECS = BN * BK / VEC / NT;
  // B9: s chunk [BK][BM], g chunk [BK][BN].
  static constexpr int LDS = BM + VEC;
  static constexpr int LDG = BN + VEC;
  static constexpr int S9_VECS = BK * BM / VEC / NT;
  static constexpr int G9_VECS = BK * BN / VEC / NT;
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

// ------------------------------------------------------------------ B8

struct SddmmArgs {
  const void* a;            // (nb, a_rows, f)
  const void* b;            // (nb, b_rows, f)
  const int* window_start;  // (num_blocks,)
  float* out;               // (nb, num_blocks * 128, window)
  int n_jt, window, f, a_rows, b_rows;
  int64_t n_pad;
};

template <typename T>
__global__ void __launch_bounds__(NT) sddmm_kernel(const SddmmArgs p) {
  using C = Cfg<T>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int A_ELEMS = BM * C::LDK;
  constexpr int B_ELEMS = F32 ? BK * C::LDT : BN * C::LDK;
  __shared__ __align__(128) unsigned char smem[(A_ELEMS + B_ELEMS) * sizeof(T)];
  T* As = reinterpret_cast<T*>(smem);  // [BM][LDK] a chunk
  T* Bs = As + A_ELEMS;  // b chunk: [BN][LDK], or [BK][LDT] transposed

  const int tid = threadIdx.x;
  const int jt = blockIdx.x % p.n_jt;   // window-column tile: fastest
  const int blk = blockIdx.x / p.n_jt;  // destination block
  const int item = blockIdx.y;
  const int f = p.f, window = p.window;
  const int j0 = jt * BN;
  const int64_t row0 = (int64_t)blk * BM;
  const int64_t ws = p.window_start[blk];
  const T* a = static_cast<const T*>(p.a) + (int64_t)item * p.a_rows * f;
  const T* b = static_cast<const T*>(p.b) + (int64_t)item * p.b_rows * f;
  float* out = p.out + ((int64_t)item * p.n_pad + row0) * window + j0;

  uint4 ra[C::A8_VECS], rb[C::B8_VECS];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < C::A8_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BK / C::VEC), cv = v % (BK / C::VEC);
      const int64_t row = row0 + r;
      const int col = k0 + cv * C::VEC;
      ra[i] = (row < p.a_rows && col < f)
                  ? *reinterpret_cast<const uint4*>(a + row * f + col)
                  : zero;
    }
#pragma unroll
    for (int i = 0; i < C::B8_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BK / C::VEC), cv = v % (BK / C::VEC);
      const int64_t row = ws + j0 + r;
      const int col = k0 + cv * C::VEC;
      rb[i] = (row < p.b_rows && col < f)
                  ? *reinterpret_cast<const uint4*>(b + row * f + col)
                  : zero;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < C::A8_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BK / C::VEC), cv = v % (BK / C::VEC);
      *reinterpret_cast<uint4*>(As + r * C::LDK + cv * C::VEC) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < C::B8_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BK / C::VEC), cv = v % (BK / C::VEC);
      if constexpr (F32) {
        // Transposed, so the product loop reads four window columns of one
        // feature as one vector.
        const float* e = reinterpret_cast<const float*>(&rb[i]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          reinterpret_cast<float*>(Bs)[(cv * 4 + q) * C::LDT + r] = e[q];
      } else {
        *reinterpret_cast<uint4*>(Bs + r * C::LDK + cv * C::VEC) = rb[i];
      }
    }
  };

  if constexpr (F32) {
    // CUDA-core path: each thread owns 8 rows x 4 window columns.
    const int tx = tid & 15, ty = tid >> 4;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    load(0);
    for (int k0 = 0; k0 < f; k0 += BK) {
      stage();
      __syncthreads();
      if (k0 + BK < f) load(k0 + BK);
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float4 bv =
            *reinterpret_cast<const float4*>(Bs + k * C::LDT + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = As[(ty * 8 + i) * C::LDK + k];
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
      *reinterpret_cast<float4*>(out + (int64_t)(ty * 8 + i) * window + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  } else {
    // Tensor-core path: warp (wm, wn) owns rows wm*32.. and window columns
    // wn*32.. as 2 x 2 WMMA tiles; the b chunk is read as a column-major
    // matrix_b, which is the transpose the product needs.
    using namespace nvcuda;
    const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    load(0);
    for (int k0 = 0; k0 < f; k0 += BK) {
      stage();
      __syncthreads();
      if (k0 + BK < f) load(k0 + BK);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * C::LDK + kk,
                                 C::LDK);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + (wn * 32 + j * 16) * C::LDK + kk,
                                 C::LDK);
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
            out + (int64_t)(wm * 32 + i * 16) * window + wn * 32 + j * 16,
            acc[i][j], window, wmma::mem_row_major);
  }
}

// ------------------------------------------------------------ B9 and B9b

struct SpmmTArgs {
  const void* s;            // (nb, n_pad, window), in g's type
  const void* g;            // (nb, g_rows, f)
  const int* window_start;  // (num_blocks,)
  const int* t_lo;          // (ns_blocks,)
  const int* t_cnt;         // (ns_blocks,)
  void* out;                // (nb, ns_blocks * 128, f)
  int n_fc, window, f, g_rows;
  int64_t n_pad, src_rows;
};

template <typename T>
__global__ void __launch_bounds__(NT) spmm_t_kernel(const SpmmTArgs p) {
  using C = Cfg<T>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int STAGE_BYTES = (BK * C::LDS + BK * C::LDG) * (int)sizeof(T);
  constexpr int TILE_BYTES = F32 ? 0 : BM * LDC * (int)sizeof(float);
  __shared__ __align__(128) unsigned char
      smem[STAGE_BYTES > TILE_BYTES ? STAGE_BYTES : TILE_BYTES];
  T* As = reinterpret_cast<T*>(smem);  // [BK][LDS] s chunk (dest rows x cols)
  T* Bs = As + BK * C::LDS;            // [BK][LDG] g chunk

  const int tid = threadIdx.x;
  const int fc = blockIdx.x % p.n_fc;  // feature tile: fastest, shares s in L2
  const int c = blockIdx.x / p.n_fc;   // source block
  const int item = blockIdx.y;
  const int f = p.f, window = p.window;
  const int c0 = fc * BN;
  const T* s = static_cast<const T*>(p.s) + (int64_t)item * p.n_pad * window;
  const T* g = static_cast<const T*>(p.g) + (int64_t)item * p.g_rows * f;
  T* out = static_cast<T*>(p.out) + (int64_t)item * p.src_rows * f;
  const int lo = p.t_lo[c];
  const int steps = p.t_cnt[c] * (BM / BK);  // chunks over all covering blocks

  uint4 ra[C::S9_VECS], rb[C::G9_VECS];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto load = [&](int t) {
    const int j = lo + t / (BM / BK);      // destination block
    const int k0 = (t % (BM / BK)) * BK;   // its rows k0 .. k0 + 32
    const int64_t col0 = (int64_t)c * BM - p.window_start[j];
    const int64_t r0 = (int64_t)j * BM + k0;
#pragma unroll
    for (int i = 0; i < C::S9_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BM / C::VEC), cv = v % (BM / C::VEC);
      ra[i] = *reinterpret_cast<const uint4*>(s + (r0 + r) * window + col0 +
                                              cv * C::VEC);
    }
#pragma unroll
    for (int i = 0; i < C::G9_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BN / C::VEC), cv = v % (BN / C::VEC);
      const int col = c0 + cv * C::VEC;
      rb[i] = (r0 + r < p.g_rows && col < f)
                  ? *reinterpret_cast<const uint4*>(g + (r0 + r) * f + col)
                  : zero;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < C::S9_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BM / C::VEC), cv = v % (BM / C::VEC);
      *reinterpret_cast<uint4*>(As + r * C::LDS + cv * C::VEC) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < C::G9_VECS; ++i) {
      const int v = tid + i * NT;
      const int r = v / (BN / C::VEC), cv = v % (BN / C::VEC);
      *reinterpret_cast<uint4*>(Bs + r * C::LDG + cv * C::VEC) = rb[i];
    }
  };

  if constexpr (F32) {
    // CUDA-core path: each thread owns 8 source rows x 4 features.
    const int tx = tid & 15, ty = tid >> 4;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    if (steps > 0) load(0);
    for (int t = 0; t < steps; ++t) {
      stage();
      __syncthreads();
      if (t + 1 < steps) load(t + 1);
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float4 bv =
            *reinterpret_cast<const float4*>(Bs + k * C::LDG + tx * 4);
        const float4 a0 =
            *reinterpret_cast<const float4*>(As + k * C::LDS + ty * 8);
        const float4 a1 =
            *reinterpret_cast<const float4*>(As + k * C::LDS + ty * 8 + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][0] = fmaf(av[i], bv.x, acc[i][0]);
          acc[i][1] = fmaf(av[i], bv.y, acc[i][1]);
          acc[i][2] = fmaf(av[i], bv.z, acc[i][2]);
          acc[i][3] = fmaf(av[i], bv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
    const int col = c0 + tx * 4;
    if (col < f) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int64_t row = (int64_t)c * BM + ty * 8 + i;
        if (row < p.src_rows)
          *reinterpret_cast<float4*>(out + row * f + col) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  } else {
    // Tensor-core path: warp (wm, wn) owns source rows wm*32.. and features
    // wn*32..; the s chunk is read as a column-major matrix_a, which is the
    // transpose the product needs.
    using namespace nvcuda;
    const int warp = tid >> 5, wm = warp >> 1, wn = warp & 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    if (steps > 0) load(0);
    for (int t = 0; t < steps; ++t) {
      stage();
      __syncthreads();
      if (t + 1 < steps) load(t + 1);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + kk * C::LDS + wm * 32 + i * 16,
                                 C::LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * C::LDG + wn * 32 + j * 16,
                                 C::LDG);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
    // The last barrier of the loop (or none, with no covering block) leaves
    // the staging area free for the output tile.
    float* Cs = reinterpret_cast<float*>(smem);  // [BM][LDC]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();
    constexpr int OV = BN / C::VEC;  // output vectors per tile row
    for (int v = tid; v < BM * OV; v += NT) {
      const int r = v / OV, cv = v % OV;
      const int col = c0 + cv * C::VEC;
      const int64_t row = (int64_t)c * BM + r;
      if (col < f && row < p.src_rows) {
        __align__(16) T tmp[C::VEC];
#pragma unroll
        for (int e = 0; e < C::VEC; ++e)
          tmp[e] = from_f32<T>(Cs[r * LDC + cv * C::VEC + e]);
        *reinterpret_cast<uint4*>(out + row * f + col) =
            *reinterpret_cast<const uint4*>(tmp);
      }
    }
  }
}

}  // namespace

// B8. a (nb, a_rows, f) and b (nb, b_rows, f) in float32 (dtype 0) or
// bfloat16 (1); out (nb, num_blocks * 128, window) float32. Rows of a and b
// past a_rows and b_rows read as zero. Returns 0, a cudaError_t from the
// launch, or -1 for arguments the kernel does not take.
extern "C" int gwen_sddmm(const void* a, const void* b,
                          const void* window_start, void* out, int nb,
                          int num_blocks, int window, int f, int a_rows,
                          int b_rows, int dtype, void* stream) {
  if (nb <= 0 || nb > 65535 || num_blocks <= 0 || window <= 0 || window % BN ||
      f <= 0 || a_rows < 0 || b_rows < 0)
    return -1;
  SddmmArgs p{};
  p.a = a;
  p.b = b;
  p.window_start = static_cast<const int*>(window_start);
  p.out = static_cast<float*>(out);
  p.n_jt = window / BN;
  p.window = window;
  p.f = f;
  p.a_rows = a_rows;
  p.b_rows = b_rows;
  p.n_pad = (int64_t)num_blocks * BM;
  const dim3 grid((unsigned)p.n_jt * (unsigned)num_blocks, (unsigned)nb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (f % Cfg<float>::VEC) return -1;
    sddmm_kernel<float><<<grid, NT, 0, st>>>(p);
  } else if (dtype == 1) {
    if (f % Cfg<__nv_bfloat16>::VEC) return -1;
    sddmm_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(p);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// B9 (nb = 1) and B9b. s (nb, num_blocks * 128, window) and g (nb, g_rows,
// f) in one type (dtype as above); out (nb, ns_blocks * 128, f) in that
// type. Rows of g past g_rows read as zero. window and every window start
// must be multiples of 128, and t_lo/t_cnt the covering ranges of the
// ns_blocks source blocks. Return codes as gwen_sddmm.
extern "C" int gwen_spmm_t(const void* s, const void* g,
                           const void* window_start, const void* t_lo,
                           const void* t_cnt, void* out, int nb, int num_blocks,
                           int ns_blocks, int window, int f, int g_rows,
                           int dtype, void* stream) {
  if (nb <= 0 || nb > 65535 || num_blocks <= 0 || ns_blocks <= 0 ||
      window <= 0 || window % BM || f <= 0 || g_rows < 0)
    return -1;
  SpmmTArgs p{};
  p.s = s;
  p.g = g;
  p.window_start = static_cast<const int*>(window_start);
  p.t_lo = static_cast<const int*>(t_lo);
  p.t_cnt = static_cast<const int*>(t_cnt);
  p.out = out;
  p.n_fc = (f + BN - 1) / BN;
  p.window = window;
  p.f = f;
  p.g_rows = g_rows;
  p.n_pad = (int64_t)num_blocks * BM;
  p.src_rows = (int64_t)ns_blocks * BM;
  const dim3 grid((unsigned)p.n_fc * (unsigned)ns_blocks, (unsigned)nb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (f % Cfg<float>::VEC) return -1;
    spmm_t_kernel<float><<<grid, NT, 0, st>>>(p);
  } else if (dtype == 1) {
    if (f % Cfg<__nv_bfloat16>::VEC) return -1;
    spmm_t_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(p);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}
