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
// float32 operands on the CUDA cores at full precision, no TF32).
//
// B9 and B9b, for every 128-row source block c:
//   out[c*128 + jj, :] = sum over the destination blocks j in
//       [t_lo[c], t_lo[c] + t_cnt[c]) and their rows i of
//       s[j*128 + i, c*128 - ws_j + jj] * g[j*128 + i, :]
// for a runtime, asymmetric tile s (N_pad, W). Window starts are multiples
// of 128 and W is a multiple of 128, so each covering block contributes one
// full (128 x 128) tile of s at column offset c*128 - ws_j. Each output tile
// is owned by one CTA, which walks its covering blocks itself: no atomics, a
// fixed order of summation, float32 sums and one rounding to g's type. The
// items of B9b (s and g both per item) are walked by the same kernel.
//
// What bounds them on an H100: bytes, in principle. B8 at L7 (W 384, f 128,
// bf16) does 16 GFLOP against 253 MB of float32 scores written and 84 MB
// read; B9 reads 127 MB of s and 84 MB of g and writes 42 MB for 16 GFLOP.
// Both are an order under the ~295 flop/byte ridge, so the products only
// have to stay out of the way of the copies, and every byte should cross
// from L2 to the SMs as few times as the shared memory allows.
//
// The bf16 forms (dtype 1, the unfused backend's) are tile products on the
// tensor cores (mma.sync m16n8k16, operands by ldmatrix from shared memory)
// fed by a ring of tiles that asynchronous copies fill while earlier tiles
// are multiplied; rows past a_rows, b_rows or g_rows and features past f
// arrive as zeros.
//
// * B8 (sddmm_tc_kernel): one CTA a destination block and item. Up to 256
//   features, the block's 128 a rows are copied into shared memory once
//   (RES) and its window of b streams through a ring of two (64 rows x 128
//   features) stages, one in flight while one is multiplied, by cp.async
//   (16-byte copies; a source size of 0 writes the zeros). Each finished
//   (128 x 64) float32 score tile is staged in shared memory and written as
//   whole 256-byte row segments, 16 bytes a thread; those stores drain while
//   the next tile's products run. Above 256 features the a rows no longer
//   fit beside the ring: each stage then carries a's 128-feature slice too
//   (STREAM, three stages), and a crosses from L2 once per score tile. The
//   score stream is what bounds it (tools/time_unfused.py --controls times
//   it with the stores kept in L2 and with none).
// * B9 (spmm_t_tc_kernel): one CTA a (128 source rows x 128 features)
//   output tile of one item. Its ring stages are its covering blocks'
//   (64 rows x 128 columns) halves of the s tile with the matching 64 g
//   rows, three stages, two in flight while one is multiplied. One thread
//   has TMA copy each stage as four (64 x 64) boxes in the 128-byte swizzle
//   (tensor maps encoded per call; zeros outside g) and the stage's
//   mbarrier tells the others when they landed: the copies no longer share
//   the load pipe with ldmatrix, which cp.async did. The window starts are
//   read a block ahead. S^T comes from ldmatrix.trans on the s tile as it
//   lies. The epilogue rounds the float32 sums once and stores them from
//   the accumulators.
//
// The float32 forms (dtype 0) keep the CUDA-core kernels of the first port:
// one CTA a (128 x 64) output tile, the contraction staged through
// registers in slices of 32, full-precision fmaf.
//
// Plain C interface, loaded with ctypes (gwen_tpu_torch/ops/unfused_cuda.py).

#include <cuda.h>  // CUtensorMap and its enums (libcuda is reached at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // rows per graph block (destination or source)
constexpr int NT = 256;  // threads per CTA (8 warps)

// ------------------------------------------------- copies and products

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, in flight without registers; with
// on false, none read and zeros written.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(on ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory, lane l giving the row address of
// matrix l / 8; .trans hands each thread a column pair instead of a row pair.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, float32) += a (16 x 16, row) * b (16 x 8, col), bf16 operands.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mbarriers and TMA (the tensor memory accelerator): one thread asks for a
// box of a tensor to be copied into shared memory, and the copy's bytes
// complete the transaction count the barrier expects.
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned phase) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
}
__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map,
                                            unsigned bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------------ B8

struct SddmmArgs {
  const void* a;            // (nb, a_rows, f)
  const void* b;            // (nb, b_rows, f)
  const int* window_start;  // (num_blocks,)
  float* out;               // (nb, num_blocks * 128, window)
  int n_jt, window, f, a_rows, b_rows;
  int n_kc, lda;  // bf16: 128-feature slices, resident a row (elements)
  int64_t n_pad;
};

constexpr int T8 = 64;       // window rows (score columns) a tile
constexpr int KC = 128;      // features a ring stage
constexpr int LDK = KC + 8;  // stage row, bf16: 272 bytes, so the 8 rows of
                             // an ldmatrix fall on distinct banks
constexpr int LDO = T8 + 8;  // staging row, float: 288 bytes
constexpr int FA_MAX = 256;  // a's features kept resident (RES)

template <bool RES>
struct B8Smem {
  static constexpr int STAGES = RES ? 2 : 3;
  static constexpr int A_STAGE = RES ? 0 : BM * LDK;  // bf16, STREAM only
  static constexpr int STAGE = A_STAGE + T8 * LDK;    // bf16
  static constexpr int OUT_BYTES = BM * LDO * 4;
  // [staging (float)][ring][resident a rows (RES)]
  static constexpr int bytes(int lda) {
    return OUT_BYTES + STAGES * STAGE * 2 + (RES ? BM * lda * 2 : 0);
  }
};

template <bool RES>
__global__ void __launch_bounds__(NT, RES ? 2 : 1)
    sddmm_tc_kernel(const SddmmArgs p) {
  using L = B8Smem<RES>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Os = reinterpret_cast<float*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + L::OUT_BYTES);
  bf16* As = ring + L::STAGES * L::STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // tile rows wm*32, columns wn*32
  const int blk = blockIdx.x, item = blockIdx.y;
  const int f = p.f, n_kc = p.n_kc;
  const int64_t row0 = (int64_t)blk * BM;
  const int64_t ws = p.window_start[blk];
  const bf16* a = static_cast<const bf16*>(p.a) + (int64_t)item * p.a_rows * f;
  const bf16* b = static_cast<const bf16*>(p.b) + (int64_t)item * p.b_rows * f;
  float* out = p.out + ((int64_t)item * p.n_pad + row0) * p.window;
  const int n_stages = p.n_jt * n_kc;

  // Rows [first, first + rows) of x, features [k0, k0 + 8 * vecs), into dst
  // (row stride ld); zeros past x_rows and f.
  auto copy_rows = [&](bf16* dst, int ld, const bf16* x, int64_t first,
                       int x_rows, int rows, int k0, int vecs) {
    for (int v = tid; v < rows * vecs; v += NT) {
      const int r = v / vecs, cv = v - r * vecs;
      const int64_t row = first + r;
      const int col = k0 + cv * 8;
      const bool on = row < x_rows && col < f;
      cp_async16(smem_u32(dst + r * ld + cv * 8), on ? x + row * f + col : x,
                 on);
    }
  };
  // Stage s: window rows t*64.. of score tile t, features kc*128..
  // (STREAM: a's slice too, in front).
  auto load_stage = [&](int s) {
    const int t = s / n_kc, kc = s - t * n_kc;
    bf16* st = ring + (s % L::STAGES) * L::STAGE;
    if constexpr (!RES) copy_rows(st, LDK, a, row0, p.a_rows, BM, kc * KC, KC / 8);
    copy_rows(st + L::A_STAGE, LDK, b, ws + t * T8, p.b_rows, T8, kc * KC,
              KC / 8);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  if constexpr (RES) copy_rows(As, p.lda, a, row0, p.a_rows, BM, 0, n_kc * (KC / 8));
#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < n_stages) load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();  // stage s landed for all; stage s - 1 is free
    if (s + L::STAGES - 1 < n_stages) load_stage(s + L::STAGES - 1);
    cp_async_commit();

    const int t = s / n_kc, kc = s - t * n_kc;
    const bf16* st = ring + (s % L::STAGES) * L::STAGE;
    const bf16* Ab = RES ? As + kc * KC : st;
    const int lda = RES ? p.lda : LDK;
    const bf16* Bb = st + L::A_STAGE;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      unsigned af[2][4], bq[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], smem_u32(Ab + (wm * 32 + mi * 16 + (lane & 15)) * lda +
                                 kk + (lane >> 4) * 8));
      // b rows are the product's columns, features its depth: as stored,
      // they are the col-major operand.
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4(bq[nj],
                smem_u32(Bb + (wn * 32 + nj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                  LDK +
                         kk + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          mma_bf16(acc[mi][nj], af[mi], bq[nj >> 1][(nj & 1) * 2],
                   bq[nj >> 1][(nj & 1) * 2 + 1]);
    }
    if (kc == n_kc - 1) {
      // Score tile t is done: staged, then written as whole 256-byte row
      // segments, 16 bytes a thread. (The barrier at the top of every stage
      // keeps these writes behind the previous tile's reads of the staging.)
      const int g = lane >> 2, q = lane & 3;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int r = wm * 32 + mi * 16 + g, c = wn * 32 + nj * 8 + q * 2;
          *reinterpret_cast<float2*>(Os + r * LDO + c) =
              make_float2(acc[mi][nj][0], acc[mi][nj][1]);
          *reinterpret_cast<float2*>(Os + (r + 8) * LDO + c) =
              make_float2(acc[mi][nj][2], acc[mi][nj][3]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
        }
      __syncthreads();
      for (int v = tid; v < BM * T8 / 4; v += NT) {
        const int r = v >> 4, c4 = (v & 15) * 4;
        float* dst = out + (int64_t)r * p.window + t * T8 + c4;
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(Os + r * LDO + c4);
      }
    }
  }
}

// float32: one CTA a (128 x 64) score tile, CUDA cores, slices of 32
// features staged through registers; each thread owns 8 rows x 4 columns.
__global__ void __launch_bounds__(NT) sddmm_f32_kernel(const SddmmArgs p) {
  constexpr int BN = 64, BK = 32, LDK32 = BK + 4, LDT = BN + 4;
  constexpr int A_VECS = BM * BK / 4 / NT, B_VECS = BN * BK / 4 / NT;
  __shared__ __align__(16) float As[BM * LDK32];
  __shared__ __align__(16) float Bs[BK * LDT];  // transposed b slice

  const int tid = threadIdx.x;
  const int jt = blockIdx.x % p.n_jt;   // window-column tile: fastest
  const int blk = blockIdx.x / p.n_jt;  // destination block
  const int item = blockIdx.y;
  const int f = p.f, window = p.window;
  const int j0 = jt * BN;
  const int64_t row0 = (int64_t)blk * BM;
  const int64_t ws = p.window_start[blk];
  const float* a = static_cast<const float*>(p.a) + (int64_t)item * p.a_rows * f;
  const float* b = static_cast<const float*>(p.b) + (int64_t)item * p.b_rows * f;
  float* out = p.out + ((int64_t)item * p.n_pad + row0) * window + j0;

  float4 ra[A_VECS], rb[B_VECS];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = tid + i * NT, r = v / (BK / 4), cv = v % (BK / 4);
      const int64_t row = row0 + r;
      const int col = k0 + cv * 4;
      ra[i] = (row < p.a_rows && col < f)
                  ? *reinterpret_cast<const float4*>(a + row * f + col)
                  : zero;
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int v = tid + i * NT, r = v / (BK / 4), cv = v % (BK / 4);
      const int64_t row = ws + j0 + r;
      const int col = k0 + cv * 4;
      rb[i] = (row < p.b_rows && col < f)
                  ? *reinterpret_cast<const float4*>(b + row * f + col)
                  : zero;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      const int v = tid + i * NT, r = v / (BK / 4), cv = v % (BK / 4);
      *reinterpret_cast<float4*>(As + r * LDK32 + cv * 4) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      // Transposed, so the product loop reads four window columns of one
      // feature as one vector.
      const int v = tid + i * NT, r = v / (BK / 4), cv = v % (BK / 4);
      const float e[4] = {rb[i].x, rb[i].y, rb[i].z, rb[i].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) Bs[(cv * 4 + q) * LDT + r] = e[q];
    }
  };

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
      const float4 bv = *reinterpret_cast<const float4*>(Bs + k * LDT + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av = As[(ty * 8 + i) * LDK32 + k];
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

constexpr int KI = 64;   // destination rows (the contraction) a stage
constexpr int FN = 128;  // features a CTA (bf16)
constexpr int BOX = 64 * 64;             // bf16 of one (64 x 64) TMA box
constexpr int STAGE9_BYTES = 4 * BOX * 2;  // two s boxes, then two g boxes
constexpr int S9 = 3;                    // ring stages
constexpr int SMEM9 = S9 * STAGE9_BYTES + 1024;  // + room to align to 1 KB

// Byte offset of the 16 bytes at (row, col) of a (64 x 64) bf16 box as TMA
// writes it with the 128-byte swizzle: rows of 128 bytes, the 16-byte chunk
// index XORed with the row's low three bits (so the 8 rows an ldmatrix
// reads fall on distinct banks). The box must start at a multiple of 1 KB.
__device__ __forceinline__ unsigned swz(int row, int col) {
  return (unsigned)(row * 128 + ((((col >> 3) ^ row) & 7) << 4));
}

// One CTA a (128 source rows x 128 features) output tile of one item: its
// stages are the covering blocks' KI-row halves of the (128 x 128) s tile,
// with the matching g rows, in order; one thread has TMA copy each stage
// as four (64 x 64) boxes, and the stage's mbarrier says when they landed.
__global__ void __launch_bounds__(NT, 2)
    spmm_t_tc_kernel(const __grid_constant__ CUtensorMap tm_s,
                     const __grid_constant__ CUtensorMap tm_g, const SpmmTArgs p) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[S9];
  const unsigned ring = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // source rows wm*32, features wn*64
  const int fc = blockIdx.x % p.n_fc;       // feature slice
  const int c = blockIdx.x / p.n_fc;        // source block
  const int item = blockIdx.y;
  const int lo = p.t_lo[c], cnt = p.t_cnt[c];
  const int n = (BM / KI) * cnt;  // stages

  if (tid == 0) {
    for (int k = 0; k < S9; ++k) mbar_init(smem_u32(&full[k]), 1);
    fence_mbar_init();
  }
  __syncthreads();

  // Thread 0's: the window starts of the block being loaded and of the
  // next one, read a block ahead so that no stage waits on one.
  int ws_cur = 0, ws_next = 0, cov_cur = 0;
  if (tid == 0) {
    ws_cur = cnt > 0 ? p.window_start[lo] : 0;
    ws_next = cnt > 1 ? p.window_start[lo + 1] : 0;
  }
  auto load_stage = [&](int q) {  // thread 0 only
    const int cov = q / (BM / KI);
    if (cov != cov_cur) {
      cov_cur = cov;
      ws_cur = ws_next;
      ws_next = cov + 1 < cnt ? p.window_start[lo + cov + 1] : 0;
    }
    const int r0 = (lo + cov) * BM + (q % (BM / KI)) * KI;
    const int col0 = c * BM - ws_cur;
    const unsigned st = ring + (q % S9) * STAGE9_BYTES;
    const unsigned bar = smem_u32(&full[q % S9]);
    mbar_expect_tx(bar, STAGE9_BYTES);
    tma_load_3d(st, &tm_s, bar, col0, r0, item);
    tma_load_3d(st + BOX * 2, &tm_s, bar, col0 + 64, r0, item);
    tma_load_3d(st + 2 * BOX * 2, &tm_g, bar, fc * FN, r0, item);
    tma_load_3d(st + 3 * BOX * 2, &tm_g, bar, fc * FN + 64, r0, item);
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
  if (tid == 0)
    for (int q = 0; q < S9 - 1 && q < n; ++q) load_stage(q);
  for (int q = 0; q < n; ++q) {
    __syncthreads();  // every warp is done with stage q - 1: its slot is free
    if (tid == 0 && q + S9 - 1 < n) load_stage(q + S9 - 1);
    mbar_wait(smem_u32(&full[q % S9]), (q / S9) & 1);
    const unsigned st = ring + (q % S9) * STAGE9_BYTES;
    // s as it lies, [i][jj] in two boxes of 64 columns; g [i][feature] in
    // two boxes of 64 features.
#pragma unroll
    for (int kk = 0; kk < KI; kk += 16) {
      // S^T: the source rows jj are the product's rows, the destination
      // rows i its depth; ldmatrix.trans hands each thread its pairs along i.
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int i = kk + (lane & 7) + ((lane >> 4) << 3);
        const int jj = wm * 32 + mi * 16 + (((lane >> 3) & 1) << 3);
        ldsm_x4_t(af[mi], st + (jj >> 6) * BOX * 2 + swz(i, jj & 63));
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        unsigned bq[4];
        const int i = kk + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldsm_x4_t(bq, st + (2 + wn) * BOX * 2 + swz(i, nj * 16 + ((lane >> 4) << 3)));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nj], af[mi], bq[0], bq[1]);
          mma_bf16(acc[mi][2 * nj + 1], af[mi], bq[2], bq[3]);
        }
      }
    }
  }

  // One rounding to bf16, stored from the accumulators (a quad of lanes
  // writes 16 contiguous bytes of a row).
  bf16* out = static_cast<bf16*>(p.out) + ((int64_t)item * p.src_rows + (int64_t)c * BM) * p.f;
  const int gr = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const int col = fc * FN + wn * 64 + nj * 8 + qd * 2;
    if (col < p.f) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + gr;
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)r * p.f + col) =
            __floats2bfloat162_rn(acc[mi][nj][0], acc[mi][nj][1]);
        *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)(r + 8) * p.f + col) =
            __floats2bfloat162_rn(acc[mi][nj][2], acc[mi][nj][3]);
      }
    }
  }
}

// float32: one CTA a (128 source rows x 64 features) tile, CUDA cores, the
// covering blocks' rows staged through registers in slices of 32; each
// thread owns 8 source rows x 4 features.
__global__ void __launch_bounds__(NT) spmm_t_f32_kernel(const SpmmTArgs p) {
  constexpr int BN = 64, BK = 32, LDS = BM + 4, LDG = BN + 4;
  constexpr int S_VECS = BK * BM / 4 / NT, G_VECS = BK * BN / 4 / NT;
  __shared__ __align__(16) float As[BK * LDS];  // s slice (dest rows x cols)
  __shared__ __align__(16) float Bs[BK * LDG];  // g slice

  const int tid = threadIdx.x;
  const int fc = blockIdx.x % p.n_fc;  // feature tile: fastest, shares s in L2
  const int c = blockIdx.x / p.n_fc;   // source block
  const int item = blockIdx.y;
  const int f = p.f, window = p.window;
  const int c0 = fc * BN;
  const float* s = static_cast<const float*>(p.s) + (int64_t)item * p.n_pad * window;
  const float* g = static_cast<const float*>(p.g) + (int64_t)item * p.g_rows * f;
  float* out = static_cast<float*>(p.out) + (int64_t)item * p.src_rows * f;
  const int lo = p.t_lo[c];
  const int steps = p.t_cnt[c] * (BM / BK);  // slices over all covering blocks

  float4 ra[S_VECS], rb[G_VECS];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load = [&](int t) {
    const int j = lo + t / (BM / BK);     // destination block
    const int k0 = (t % (BM / BK)) * BK;  // its rows k0 .. k0 + 32
    const int64_t col0 = (int64_t)c * BM - p.window_start[j];
    const int64_t r0 = (int64_t)j * BM + k0;
#pragma unroll
    for (int i = 0; i < S_VECS; ++i) {
      const int v = tid + i * NT, r = v / (BM / 4), cv = v % (BM / 4);
      ra[i] = *reinterpret_cast<const float4*>(s + (r0 + r) * window + col0 +
                                               cv * 4);
    }
#pragma unroll
    for (int i = 0; i < G_VECS; ++i) {
      const int v = tid + i * NT, r = v / (BN / 4), cv = v % (BN / 4);
      const int col = c0 + cv * 4;
      rb[i] = (r0 + r < p.g_rows && col < f)
                  ? *reinterpret_cast<const float4*>(g + (r0 + r) * f + col)
                  : zero;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < S_VECS; ++i) {
      const int v = tid + i * NT, r = v / (BM / 4), cv = v % (BM / 4);
      *reinterpret_cast<float4*>(As + r * LDS + cv * 4) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < G_VECS; ++i) {
      const int v = tid + i * NT, r = v / (BN / 4), cv = v % (BN / 4);
      *reinterpret_cast<float4*>(Bs + r * LDG + cv * 4) = rb[i];
    }
  };

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
      const float4 bv = *reinterpret_cast<const float4*>(Bs + k * LDG + tx * 4);
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * LDS + ty * 8);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + k * LDS + ty * 8 + 4);
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
}

// ------------------------------------------------------------- launches

// Raises a kernel's dynamic shared-memory limit to bytes, once per device
// and kernel (above 48 KB it must be asked for).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int which) {
  static int allowed[3][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[which][dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) allowed[which][dev] = bytes;
  return err;
}

// cuTensorMapEncodeTiled, from the libcuda the runtime has loaded (so this
// library links to nothing but the runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (nb, rows, cols) bf16 tensor as B9 reads it: (64 x 64) boxes of one item,
// 128-byte swizzle, zeros outside the tensor.
bool box_map(CUtensorMap* map, const void* base, int64_t cols, int64_t rows,
             int64_t nb) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)nb};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)(rows * cols * 2)};
  const cuuint32_t box[3] = {64, 64, 1}, unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// B8's bf16 form for f features: the kernel, its dynamic shared memory.
struct B8Launch {
  bool res;
  int n_kc, lda, bytes;
};
B8Launch b8_launch(int f) {
  B8Launch l{};
  l.n_kc = (f + KC - 1) / KC;
  l.lda = l.n_kc * KC + 8;
  l.res = l.n_kc * KC <= FA_MAX;
  l.bytes = l.res ? B8Smem<true>::bytes(l.lda) : B8Smem<false>::bytes(0);
  return l;
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
  if (nb <= 0 || nb > 65535 || num_blocks <= 0 || window <= 0 || window % T8 ||
      f <= 0 || a_rows < 0 || b_rows < 0)
    return -1;
  SddmmArgs p{};
  p.a = a;
  p.b = b;
  p.window_start = static_cast<const int*>(window_start);
  p.out = static_cast<float*>(out);
  p.n_jt = window / T8;
  p.window = window;
  p.f = f;
  p.a_rows = a_rows;
  p.b_rows = b_rows;
  p.n_pad = (int64_t)num_blocks * BM;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (f % 4) return -1;
    const dim3 grid((unsigned)p.n_jt * (unsigned)num_blocks, (unsigned)nb);
    sddmm_f32_kernel<<<grid, NT, 0, st>>>(p);
  } else if (dtype == 1) {
    if (f % 8) return -1;
    const B8Launch l = b8_launch(f);
    p.n_kc = l.n_kc;
    p.lda = l.lda;
    const dim3 grid((unsigned)num_blocks, (unsigned)nb);
    cudaError_t err;
    if (l.res) {
      err = allow_smem(sddmm_tc_kernel<true>, l.bytes, 0);
      if (err != cudaSuccess) return (int)err;
      sddmm_tc_kernel<true><<<grid, NT, l.bytes, st>>>(p);
    } else {
      err = allow_smem(sddmm_tc_kernel<false>, l.bytes, 1);
      if (err != cudaSuccess) return (int)err;
      sddmm_tc_kernel<false><<<grid, NT, l.bytes, st>>>(p);
    }
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
  p.window = window;
  p.f = f;
  p.g_rows = g_rows;
  p.n_pad = (int64_t)num_blocks * BM;
  p.src_rows = (int64_t)ns_blocks * BM;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (f % 4) return -1;
    p.n_fc = (f + 63) / 64;
    const dim3 grid((unsigned)p.n_fc * (unsigned)ns_blocks, (unsigned)nb);
    spmm_t_f32_kernel<<<grid, NT, 0, st>>>(p);
  } else if (dtype == 1) {
    if (f % 8) return -1;
    p.n_fc = (f + FN - 1) / FN;
    if (g_rows == 0)  // no g row: every sum is empty
      return (int)cudaMemsetAsync(out, 0, (size_t)nb * p.src_rows * f * 2, st);
    CUtensorMap tm_s, tm_g;
    if (!box_map(&tm_s, s, window, p.n_pad, nb) || !box_map(&tm_g, g, f, g_rows, nb))
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(spmm_t_tc_kernel, SMEM9, 2);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)p.n_fc * (unsigned)ns_blocks, (unsigned)nb);
    spmm_t_tc_kernel<<<grid, NT, SMEM9, st>>>(tm_s, tm_g, p);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// The bf16 forms' resources at f features: kernel 0 B8, 1 B9. Writes the
// dynamic shared memory a CTA takes and the CTAs an SM holds; returns 0, a
// cudaError_t, or -1 for an unknown kernel.
extern "C" int gwen_unfused_occupancy(int kernel, int f, int* smem_bytes,
                                      int* ctas_per_sm) {
  if (f <= 0 || (kernel != 0 && kernel != 1)) return -1;
  cudaError_t err;
  if (kernel == 0) {
    const B8Launch l = b8_launch(f);
    *smem_bytes = l.bytes;
    err = l.res ? allow_smem(sddmm_tc_kernel<true>, l.bytes, 0)
                : allow_smem(sddmm_tc_kernel<false>, l.bytes, 1);
    if (err == cudaSuccess)
      err = l.res ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        ctas_per_sm, sddmm_tc_kernel<true>, NT, l.bytes)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        ctas_per_sm, sddmm_tc_kernel<false>, NT, l.bytes);
  } else {
    *smem_bytes = SMEM9;
    err = allow_smem(spmm_t_tc_kernel, SMEM9, 2);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas_per_sm, spmm_t_tc_kernel, NT, SMEM9);
  }
  return (int)err;
}
