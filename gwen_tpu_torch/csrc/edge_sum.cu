// The segment sum of GraphCast's edge operators (gwen_tpu_torch/ops/edges.py):
//   out[b, r, :] = sum of src[b, order[j], :] over j in offsets[r] .. offsets[r + 1]
// (order absent: the identity), accumulated in float32 and written once in
// src's type. It is edge_sum's forward (the edges into their receivers,
// whose span of the receiver-sorted edge list is contiguous) and
// gather_join's backward (the cotangent's receiver part the same way, its
// sender part through the stable sender-sorted permutation of the edges).
//
// Replaces no TPU kernel: the JAX package has no GraphCast. It was added
// because the library path, a float32 copy of each chunk of edges and
// index_add_ into a zeroed float32 buffer, then a cast, moves about 9 KB for
// each 1 KB bf16 edge row at latent 512, with atomics.
//
// What bounds it on an H100: bytes. Each edge row is read once (1 KB at
// L = 512 in bf16) with its index, and each output row written once; there
// is one add an element. A group of threads owns an output row, 16 bytes a
// thread (64 threads a 512-wide bf16 row), walks the row's span of edges and
// keeps the loads of U edges in flight before it adds them in edge order to
// float32 registers; the row is then rounded and stored once. No atomics,
// no zero fill, no float32 buffer, and the same bits from run to run. Rows
// are contiguous in the edge list on the receiver side (a stream); on the
// sender side each edge is one 1 KB row read through the permutation.
//
// One algorithm for every shape; what adapts is set from the mean segment
// length m = edges / rows, which the launch can see without reading the
// device: a row of a long-segment set (GraphCast: ~40 and ~76 edges a mesh
// node, up to 6,184 at a pole) is split among `split` groups of the CTA,
// each summing a contiguous piece, and the pieces are added in order
// through shared memory; short segments (3 a grid node, ~8 a mesh node,
// ~1.6) take one group a row and more rows a CTA. U is 8 where a group's
// piece averages 6 edges or more, else 4. A row with no edges is written
// as zeros.
//
// src is (batch, edges, f) with any row and batch strides (the last axis
// contiguous), so a slice of a wider tensor is read in place; out is
// (batch, rows, f) contiguous. Operands whose rows are 16-byte aligned take
// 16-byte vectors, others one element a thread.
//
// Plain C interface, loaded with ctypes (gwen_tpu_torch/ops/edges.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;  // a CTA
constexpr int MAX_GROUP = 128;  // threads a row group at most

// V values a thread: 16-byte vectors of bf16 or float32, or one element.
template <typename T, int V>
struct Vec;

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void add(float* acc, const Raw& v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      acc[2 * i] += f.x;
      acc[2 * i + 1] += f.y;
    }
  }
  static __device__ __forceinline__ Raw pack(const float* acc) {
    Raw v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    return v;
  }
};

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ void add(float* acc, const Raw& v) {
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
  static __device__ __forceinline__ Raw pack(const float* acc) {
    return make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ void add(float* acc, const Raw& v) {
    acc[0] += __bfloat162float(v);
  }
  static __device__ __forceinline__ Raw pack(const float* acc) {
    return __float2bfloat16_rn(acc[0]);
  }
};

template <>
struct Vec<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void add(float* acc, const Raw& v) { acc[0] += v; }
  static __device__ __forceinline__ Raw pack(const float* acc) { return acc[0]; }
};

// A CTA holds THREADS / group groups of `group` threads; `split` groups
// share a row, so a CTA covers THREADS / group / split rows of one batch
// item (grid y). Thread `lane` of a group owns the vectors lane, lane +
// group, ... of the row's nvec. Every thread runs the same number of vector
// passes, so the CTA's barriers (split > 1) are reached by all.
template <typename T, int V, int U>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const T* __restrict__ src, const int* __restrict__ offsets,
                   const int* __restrict__ order, T* __restrict__ out,
                   long long row_stride, long long batch_stride, int num_rows,
                   int nvec, int group, int split) {
  using W = Vec<T, V>;
  using Raw = typename W::Raw;
  __shared__ float part[V * THREADS];  // pieces, value-major: no bank conflicts

  const int g = threadIdx.x / group, lane = threadIdx.x % group;
  const int row = blockIdx.x * (THREADS / group / split) + g / split;
  const int k = g % split;  // the piece this group sums
  const bool live = row < num_rows;
  int lo = 0, hi = 0;
  if (live) {
    const int start = offsets[row];
    const long long n = offsets[row + 1] - start;
    lo = start + static_cast<int>(n * k / split);
    hi = start + static_cast<int>(n * (k + 1) / split);
  }
  const T* base = src + blockIdx.y * batch_stride;
  T* orow = out + (static_cast<long long>(blockIdx.y) * num_rows + row) * nvec * V;

  for (int c0 = 0; c0 < nvec; c0 += group) {
    const int c = c0 + lane;
    const bool on = c < nvec;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    if (on) {
      for (int j = lo; j < hi; j += U) {
        Raw r[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j + u < hi) {
            const long long e = order ? order[j + u] : j + u;
            r[u] = *reinterpret_cast<const Raw*>(base + e * row_stride + c * V);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j + u < hi) W::add(acc, r[u]);
        }
      }
    }
    if (split == 1) {
      if (live && on) *reinterpret_cast<Raw*>(orow + c * V) = W::pack(acc);
      continue;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) part[v * THREADS + threadIdx.x] = acc[v];
    __syncthreads();
    if (k == 0 && live && on) {
      for (int p = 1; p < split; ++p) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += part[v * THREADS + threadIdx.x + p * group];
      }
      *reinterpret_cast<Raw*>(orow + c * V) = W::pack(acc);
    }
    __syncthreads();
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

template <typename T, int V>
cudaError_t launch_v(const T* src, const int* offsets, const int* order, T* out,
                     long long row_stride, long long batch_stride, int num_rows,
                     long long num_edges, int f, int batch, cudaStream_t st) {
  const int nvec = f / V;
  const int group = pow2_at_least(nvec < MAX_GROUP ? nvec : MAX_GROUP);
  const int groups = THREADS / group;
  const double mean = static_cast<double>(num_edges) / num_rows;
  int split = 1;
  while (split < groups && 2 * split * 8 <= mean) split *= 2;
  const int rows_cta = groups / split;
  const dim3 grid((num_rows + rows_cta - 1) / rows_cta, batch);
  if (mean / split >= 6)
    segment_sum_kernel<T, V, 8><<<grid, THREADS, 0, st>>>(
        src, offsets, order, out, row_stride, batch_stride, num_rows, nvec, group, split);
  else
    segment_sum_kernel<T, V, 4><<<grid, THREADS, 0, st>>>(
        src, offsets, order, out, row_stride, batch_stride, num_rows, nvec, group, split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* src, const int* offsets, const int* order, void* out,
                   long long row_stride, long long batch_stride, int num_rows,
                   long long num_edges, int f, int batch, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  const bool wide = f % V == 0 && row_stride % V == 0 && batch_stride % V == 0 &&
                    reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (wide)
    return launch_v<T, V>(s, offsets, order, o, row_stride, batch_stride, num_rows,
                          num_edges, f, batch, st);
  return launch_v<T, 1>(s, offsets, order, o, row_stride, batch_stride, num_rows,
                        num_edges, f, batch, st);
}

}  // namespace

// src (batch, num_edges, f) at the given row and batch strides (elements),
// offsets (num_rows + 1,) int32, order (num_edges,) int32 or null, out
// (batch, num_rows, f) contiguous; dtype 0 float32, 1 bf16. Returns 0, -1
// for arguments refused, or the CUDA error of the launch.
extern "C" int gwen_segment_sum(const void* src, const void* offsets, const void* order,
                                void* out, long long row_stride, long long batch_stride,
                                int num_rows, long long num_edges, int f, int batch,
                                int dtype, void* stream) {
  if (num_rows < 1 || num_edges < 0 || f < 1 || batch < 1 || batch > 65535 ||
      row_stride < f || batch_stride < 0 || (dtype != 0 && dtype != 1))
    return -1;
  const int* off = static_cast<const int*>(offsets);
  const int* ord = static_cast<const int*>(order);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(src, off, ord, out, row_stride, batch_stride, num_rows,
                                 num_edges, f, batch, st)
                 : launch<__nv_bfloat16>(src, off, ord, out, row_stride, batch_stride,
                                         num_rows, num_edges, f, batch, st);
  return static_cast<int>(err);
}
