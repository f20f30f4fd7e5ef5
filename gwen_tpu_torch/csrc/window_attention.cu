// Windowed graph attention: the fused forward (B5/B5b), the destination-side
// backward dQ (B6/B6b) and the source-side backward dK/dV (B7/B7b).
//
// Replaces six Pallas TPU kernels of the reference package
// (gwen_tpu/ops/attention_pallas.py):
//   B5   _attn_fwd_kernel     (through _attn_fwd_impl)
//   B5b  _attn_fwd_kernel_b   (through _attn_fwd_impl_b)
//   B6   _attn_dq_kernel      (through _attn_dq_impl)
//   B6b  _attn_dq_kernel_b    (through _attn_dq_impl_b)
//   B7   _attn_dkdv_kernel    (through _attn_dkdv_impl)
//   B7b  _attn_dkdv_kernel_b  (through _attn_dkdv_impl_b)
// Each kernel here takes the folded batch (heads x batch items) as grid
// dimension y, so one kernel serves the unbatched form (nb = 1) and the
// batched one alike.
//
// What they compute, per destination row i of item b, over the source rows
// j that the mask S != 0 holds in i's window (the reference's math):
//   s_j = (q_i . k_j) * scale in float32, mx = max_j s_j,
//   den = sum_j exp(s_j - mx), p_j = exp(s_j - mx) / den
//   (a row with no source gives p = 0: output 0, no NaN);
//   forward  out_i = sum_j round(p_j) v_j;
//   dQ       dp_j = g_i . v_j, delta = sum_j dp_j p_j,
//            dl_j = p_j (dp_j - delta) scale, dq_i = sum_j round(dl_j) k_j,
//            and the row's stats (mx, den, delta) for the source side;
//   dK/dV    per source row c, over the destination rows i that hold it:
//            p = exp(s - mx_i) / den_i from the stored stats (not from a
//            log-sum-exp, whose round trip the reference measured at 5e-5
//            relative error on dK/dV), dl = p (g_i . v_c - delta_i) scale,
//            dk_c = sum_i round(dl) q_i, dv_c = sum_i round(p) g_i.
// round() is the cast to the input type, as the reference casts P and dL
// before its products. Sums run in float32 and each output is cast once.
//
// What bounds them on an H100: bytes and latency, not flops. The TPU
// kernels multiply dense (128, W) tiles on the MXU, but a mesh row holds at
// most ~7 of the W = 384 window columns, so 98 % of that work is masked out.
// Here the mask is read as neighbour lists (DiagWindowGraph.attn_nbr and its
// transpose attn_nbr_t): one warp owns one row and each lane holds dh/32
// feature values. A dot product is a warp butterfly, after which every lane
// holds the same bits, so all lanes take the same softmax; the source side
// recomputes each score with the same operations, so its p is the forward's
// to the bit. At L7, nb = 2, dh = 128, bf16, a forward reads q, k, v and
// writes out, ~0.34 GB (0.1 ms at the card's bandwidth); neighbours are near
// in KD order, so the repeated k_j and v_j reads mostly hit L2. dK/dV walk
// the transpose lists instead of scattering, with no atomics, so gradients
// repeat from run to run.
//
// Plain C interface, loaded with ctypes (gwen_tpu_torch/ops/attention_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // rows per CTA, one warp each
constexpr int NT = WARPS * 32;
constexpr float NEG_BIG = -1e30f;  // the reference's masked logit
constexpr int MAX_SMEM = 48 * 1024;

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
// v rounded to T and back: the reference's cast of P or dL.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <int BYTES>
struct Chunk;
template <>
struct Chunk<2> { using type = unsigned short; };
template <>
struct Chunk<4> { using type = unsigned int; };
template <>
struct Chunk<8> { using type = uint2; };
template <>
struct Chunk<16> { using type = uint4; };

// A lane's VPT consecutive values of one row, moved as float32 in the
// widest loads their alignment allows (rows are 32 * VPT values).
template <typename T, int VPT>
struct Lane {
  static constexpr int BYTES = VPT * (int)sizeof(T);
  static constexpr int CB = BYTES < 16 ? BYTES : 16;
  using C = typename Chunk<CB>::type;

  static __device__ __forceinline__ void load(const T* p, float (&out)[VPT]) {
    __align__(16) T t[VPT];
#pragma unroll
    for (int i = 0; i < BYTES / CB; ++i)
      reinterpret_cast<C*>(t)[i] = reinterpret_cast<const C*>(p)[i];
#pragma unroll
    for (int e = 0; e < VPT; ++e) out[e] = to_f32(t[e]);
  }
  // Row j of a (rows, 32 * VPT) matrix, seen from this lane; rows at or
  // past `rows` read as zero (the reference zero-pads k and v).
  static __device__ __forceinline__ void row(const T* base, int j, int rows,
                                             float (&out)[VPT]) {
    if (j < rows) {
      load(base + (int64_t)j * (32 * VPT), out);
    } else {
#pragma unroll
      for (int e = 0; e < VPT; ++e) out[e] = 0.f;
    }
  }
  static __device__ __forceinline__ void store(T* p, const float (&in)[VPT]) {
    __align__(16) T t[VPT];
#pragma unroll
    for (int e = 0; e < VPT; ++e) t[e] = from_f32<T>(in[e]);
#pragma unroll
    for (int i = 0; i < BYTES / CB; ++i)
      reinterpret_cast<C*>(p)[i] = reinterpret_cast<const C*>(t)[i];
  }
};

// Dot product of two rows spread over the warp. The xor butterfly leaves
// the same bits in every lane (each step adds the same two values in the
// two lanes of a pair), and a . b and b . a round alike.
template <int VPT>
__device__ __forceinline__ float warp_dot(const float (&a)[VPT],
                                          const float (&b)[VPT]) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < VPT; ++e) s = fmaf(a[e], b[e], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Scores of destination row i against its listed sources, kept in the
// warp's shared scratch `sc`; returns the count and sets the row max.
template <typename T, int VPT>
__device__ __forceinline__ int row_scores(const float (&qi)[VPT],
                                          const T* kb, const int* row,
                                          int deg, int n_kv, float scale,
                                          int lane, float* sc, float& mx) {
  int cnt = 0;
  mx = NEG_BIG;
  for (; cnt < deg; ++cnt) {
    const int j = row[cnt];
    if (j < 0) break;
    float kj[VPT];
    Lane<T, VPT>::row(kb, j, n_kv, kj);
    // __fmul_rn is never fused into a later add: the source side rounds
    // the same product the same way.
    const float s = __fmul_rn(warp_dot<VPT>(qi, kj), scale);
    if (lane == 0) sc[cnt] = s;
    mx = fmaxf(mx, s);
  }
  __syncwarp();
  return cnt;
}

// ----------------------------------------------------------- B5 / B5b

template <typename T, int VPT>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ nbr,
                T* __restrict__ out, int n_q, int n_kv, int deg,
                float scale) {
  constexpr int DH = 32 * VPT;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + warp;
  if (i >= n_q) return;  // the whole warp leaves; no CTA barrier follows
  const int64_t b = blockIdx.y;
  float* sc = smem + warp * deg;
  const int* row = nbr + (int64_t)i * deg;
  const T* kb = k + b * n_kv * DH + lane * VPT;
  const T* vb = v + b * n_kv * DH + lane * VPT;

  float qi[VPT];
  Lane<T, VPT>::load(q + (b * n_q + i) * DH + lane * VPT, qi);
  float mx;
  const int cnt = row_scores<T, VPT>(qi, kb, row, deg, n_kv, scale, lane,
                                     sc, mx);
  float den = 0.f;
  for (int d = 0; d < cnt; ++d) den += expf(sc[d] - mx);
  const float div = den == 0.f ? 1.f : den;

  float acc[VPT];
#pragma unroll
  for (int e = 0; e < VPT; ++e) acc[e] = 0.f;
  for (int d = 0; d < cnt; ++d) {
    const float p = round_to<T>(expf(sc[d] - mx) / div);
    float vj[VPT];
    Lane<T, VPT>::row(vb, row[d], n_kv, vj);
#pragma unroll
    for (int e = 0; e < VPT; ++e) acc[e] = fmaf(p, vj[e], acc[e]);
  }
  Lane<T, VPT>::store(out + (b * n_q + i) * DH + lane * VPT, acc);
}

// ----------------------------------------------------------- B6 / B6b

template <typename T, int VPT>
__global__ void __launch_bounds__(NT)
attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ g,
               const int* __restrict__ nbr, T* __restrict__ dq,
               float* __restrict__ stats, int n_q, int n_kv, int deg,
               float scale) {
  constexpr int DH = 32 * VPT;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * WARPS + warp;
  if (i >= n_q) return;
  const int64_t b = blockIdx.y;
  float* sc = smem + warp * 2 * deg;  // scores
  float* dps = sc + deg;              // g_i . v_j
  const int* row = nbr + (int64_t)i * deg;
  const T* kb = k + b * n_kv * DH + lane * VPT;
  const T* vb = v + b * n_kv * DH + lane * VPT;
  const int64_t at = (b * n_q + i) * DH + lane * VPT;

  float qi[VPT], gi[VPT];
  Lane<T, VPT>::load(q + at, qi);
  Lane<T, VPT>::load(g + at, gi);
  float mx;
  const int cnt = row_scores<T, VPT>(qi, kb, row, deg, n_kv, scale, lane,
                                     sc, mx);
  float den = 0.f;
  for (int d = 0; d < cnt; ++d) den += expf(sc[d] - mx);
  const float div = den == 0.f ? 1.f : den;

  float delta = 0.f;
  for (int d = 0; d < cnt; ++d) {
    float vj[VPT];
    Lane<T, VPT>::row(vb, row[d], n_kv, vj);
    const float dp = warp_dot<VPT>(gi, vj);
    if (lane == 0) dps[d] = dp;
    delta += dp * (expf(sc[d] - mx) / div);
  }
  __syncwarp();

  float acc[VPT];
#pragma unroll
  for (int e = 0; e < VPT; ++e) acc[e] = 0.f;
  for (int d = 0; d < cnt; ++d) {
    const float p = expf(sc[d] - mx) / div;
    const float dl = round_to<T>(p * (dps[d] - delta) * scale);
    float kj[VPT];
    Lane<T, VPT>::row(kb, row[d], n_kv, kj);
#pragma unroll
    for (int e = 0; e < VPT; ++e) acc[e] = fmaf(dl, kj[e], acc[e]);
  }
  Lane<T, VPT>::store(dq + at, acc);
  if (lane == 0) {
    float* st = stats + (b * n_q + i) * 3;
    st[0] = mx;
    st[1] = den;
    st[2] = delta;
  }
}

// ----------------------------------------------------------- B7 / B7b

template <typename T, int VPT>
__global__ void __launch_bounds__(NT)
attn_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ stats,
                 const int* __restrict__ nbr_t, T* __restrict__ dk,
                 T* __restrict__ dv, int n_q, int n_kv, int deg_t,
                 float scale) {
  constexpr int DH = 32 * VPT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + warp;
  if (c >= n_kv) return;
  const int64_t b = blockIdx.y;
  const int* col = nbr_t + (int64_t)c * deg_t;
  const T* qb = q + b * n_q * DH + lane * VPT;
  const T* gb = g + b * n_q * DH + lane * VPT;
  const float* sb = stats + b * n_q * 3;
  const int64_t at = (b * n_kv + c) * DH + lane * VPT;

  float kc[VPT], vc[VPT], ak[VPT], av[VPT];
  Lane<T, VPT>::load(k + at, kc);
  Lane<T, VPT>::load(v + at, vc);
#pragma unroll
  for (int e = 0; e < VPT; ++e) ak[e] = av[e] = 0.f;
  for (int t = 0; t < deg_t; ++t) {
    const int i = col[t];
    if (i < 0) break;
    if (i >= n_q) continue;  // a zero q and g row adds nothing
    float qi[VPT], gi[VPT];
    Lane<T, VPT>::load(qb + (int64_t)i * DH, qi);
    Lane<T, VPT>::load(gb + (int64_t)i * DH, gi);
    const float mx = sb[(int64_t)i * 3], den = sb[(int64_t)i * 3 + 1];
    const float delta = sb[(int64_t)i * 3 + 2];
    const float p = expf(__fmul_rn(warp_dot<VPT>(kc, qi), scale) - mx) /
                    (den == 0.f ? 1.f : den);
    const float dl = p * (warp_dot<VPT>(vc, gi) - delta) * scale;
    const float rdl = round_to<T>(dl), rp = round_to<T>(p);
#pragma unroll
    for (int e = 0; e < VPT; ++e) {
      ak[e] = fmaf(rdl, qi[e], ak[e]);
      av[e] = fmaf(rp, gi[e], av[e]);
    }
  }
  Lane<T, VPT>::store(dk + at, ak);
  Lane<T, VPT>::store(dv + at, av);
}

// ----------------------------------------------------------- launches

dim3 grid_of(int rows, int nb) {
  return dim3((unsigned)((rows + WARPS - 1) / WARPS), (unsigned)nb);
}

template <typename T, int VPT>
int launch_fwd(const void* q, const void* k, const void* v, const int* nbr,
               void* out, int nb, int n_q, int n_kv, int deg, float scale,
               cudaStream_t st) {
  const int smem = WARPS * deg * (int)sizeof(float);
  if (smem > MAX_SMEM) return -1;
  attn_fwd_kernel<T, VPT><<<grid_of(n_q, nb), NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), nbr, static_cast<T*>(out), n_q, n_kv, deg,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int VPT>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const int* nbr, void* dq, float* stats, int nb, int n_q,
              int n_kv, int deg, float scale, cudaStream_t st) {
  const int smem = WARPS * 2 * deg * (int)sizeof(float);
  if (smem > MAX_SMEM) return -1;
  attn_dq_kernel<T, VPT><<<grid_of(n_q, nb), NT, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), nbr,
      static_cast<T*>(dq), stats, n_q, n_kv, deg, scale);
  return (int)cudaGetLastError();
}

template <typename T, int VPT>
int launch_dkdv(const void* q, const void* k, const void* v, const void* g,
                const float* stats, const int* nbr_t, void* dk, void* dv,
                int nb, int n_q, int n_kv, int deg_t, float scale,
                cudaStream_t st) {
  attn_dkdv_kernel<T, VPT><<<grid_of(n_kv, nb), NT, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), stats, nbr_t,
      static_cast<T*>(dk), static_cast<T*>(dv), n_q, n_kv, deg_t, scale);
  return (int)cudaGetLastError();
}

bool args_ok(int nb, int n_q, int n_kv, int deg, int vpt, int dtype) {
  return nb >= 1 && nb <= 65535 && n_q >= 1 && n_kv >= 1 && deg >= 1 &&
         vpt >= 1 && vpt <= 16 && (dtype == 0 || dtype == 1);
}

}  // namespace

// One launcher per kernel for each element type and lane width: dtype 0 =
// float32, 1 = bfloat16; vpt = values per lane (head width dh = 32 * vpt:
// 1, 2, 4, 8 or 16). Returns 0 on success, a cudaError_t from the launch,
// or -1 for arguments the kernels do not take.
#define GWEN_ATTN_DISPATCH(FN, ...)                                         \
  do {                                                                      \
    switch (dtype * 32 + vpt) {                                             \
      case 1: return FN<float, 1>(__VA_ARGS__);                             \
      case 2: return FN<float, 2>(__VA_ARGS__);                             \
      case 4: return FN<float, 4>(__VA_ARGS__);                             \
      case 8: return FN<float, 8>(__VA_ARGS__);                             \
      case 16: return FN<float, 16>(__VA_ARGS__);                           \
      case 33: return FN<__nv_bfloat16, 1>(__VA_ARGS__);                    \
      case 34: return FN<__nv_bfloat16, 2>(__VA_ARGS__);                    \
      case 36: return FN<__nv_bfloat16, 4>(__VA_ARGS__);                    \
      case 40: return FN<__nv_bfloat16, 8>(__VA_ARGS__);                    \
      case 48: return FN<__nv_bfloat16, 16>(__VA_ARGS__);                   \
      default: return -1;                                                   \
    }                                                                       \
  } while (0)

// Forward: q (nb, n_q, dh), k and v (nb, n_kv, dh), nbr (N_pad, deg) int32
// with n_q <= N_pad, out (nb, n_q, dh).
extern "C" int gwen_attn_fwd(const void* q, const void* k, const void* v,
                             const void* nbr, void* out, int nb, int n_q,
                             int n_kv, int deg, int vpt, float scale,
                             int dtype, void* stream) {
  if (!args_ok(nb, n_q, n_kv, deg, vpt, dtype)) return -1;
  const int* nb_ = static_cast<const int*>(nbr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GWEN_ATTN_DISPATCH(launch_fwd, q, k, v, nb_, out, nb, n_q, n_kv, deg,
                     scale, st);
}

// dQ and the stats: g and dq like q, stats (nb, n_q, 3) float32 holding
// (mx, den, delta) per row.
extern "C" int gwen_attn_dq(const void* q, const void* k, const void* v,
                            const void* g, const void* nbr, void* dq,
                            void* stats, int nb, int n_q, int n_kv, int deg,
                            int vpt, float scale, int dtype, void* stream) {
  if (!args_ok(nb, n_q, n_kv, deg, vpt, dtype)) return -1;
  const int* nb_ = static_cast<const int*>(nbr);
  float* sp = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GWEN_ATTN_DISPATCH(launch_dq, q, k, v, g, nb_, dq, sp, nb, n_q, n_kv, deg,
                     scale, st);
}

// dK and dV: nbr_t (num_src_rows, deg_t) int32 with n_kv <= num_src_rows;
// dk and dv like k.
extern "C" int gwen_attn_dkdv(const void* q, const void* k, const void* v,
                              const void* g, const void* stats,
                              const void* nbr_t, void* dk, void* dv, int nb,
                              int n_q, int n_kv, int deg_t, int vpt,
                              float scale, int dtype, void* stream) {
  if (!args_ok(nb, n_q, n_kv, deg_t, vpt, dtype)) return -1;
  const float* sp = static_cast<const float*>(stats);
  const int* nt = static_cast<const int*>(nbr_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GWEN_ATTN_DISPATCH(launch_dkdv, q, k, v, g, sp, nt, dk, dv, nb, n_q, n_kv,
                     deg_t, scale, st);
}
