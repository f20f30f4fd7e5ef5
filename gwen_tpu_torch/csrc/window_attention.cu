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
// batched one alike. The operands are addressed through strides (Rows
// below): an item of the grid is (b / inner, b % inner) of the wrapper's
// fold, a row a row stride further on; q, g, out and dq share one layout,
// k, v, dk and dv another. So q, k, v and the output cotangent are read,
// and the outputs written, where the q/k/v and output projections keep
// them: (..., N, H dh) rows, a head's dh values at a head offset; the
// contiguous (nb, N, dh) form is one case of the same strides. A row's
// offset is computed once for the operands that share it, and k's and v's
// gathers share each neighbour's, as with the contiguous form.
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
// transpose attn_nbr_t). At L7, nb = 2, dh = 128, bf16, a forward reads q,
// k, v and writes out, ~0.34 GB (0.1 ms at the card's bandwidth);
// neighbours are near in KD order, so the repeated k_j and v_j reads mostly
// hit L2.
//
// All three are bound by latencies in series when a row's neighbours are
// visited one after another: a row holds ~7 sources, and a gather that
// waits for the previous neighbour's dot product leaves ~14 dependent round
// trips to L2 a row in B5 and ~21 in B6. So each reads a row's list once,
// issues all of its gathers before the first dot product (B5 and B6 keep
// the gathered v or k rows for the output sum: one pass, one expf a
// neighbour), and completes the row's dot products together. A group of 16
// lanes owns a row at dh 128 in bf16 (16 bytes a lane, 4-step
// butterflies), two rows a warp; a CTA covers 64 consecutive rows of one
// item (see the shared parts below). What bounds the backward then,
// measured on an H100: the instructions and shuffles in series of each row
// at 16-24 resident warps an SM (80-128 registers a thread hold the 14
// gathered rows), not the bytes: a control run whose gathers all hit L1 is
// only 10-13 % faster (tools/time_attention.py --controls). The source
// side forms each score with the same device functions, in the same lane
// layout, so its p is B6's to the bit. dK/dV walk the transpose lists
// instead of scattering, with no atomics, so gradients repeat from run to
// run.
//
// Plain C interface, loaded with ctypes (gwen_tpu_torch/ops/attention_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // warps a CTA
constexpr int NT = WARPS * 32;
constexpr float NEG_BIG = -1e30f;  // the reference's masked logit

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

// A lane's VPT consecutive values of one row (whole 16-byte chunks: the
// lane layout below), stored from float32.
template <typename T, int VPT>
struct Lane {
  static constexpr int BYTES = VPT * (int)sizeof(T);
  static_assert(BYTES % 16 == 0, "a lane holds whole 16-byte chunks");

  static __device__ __forceinline__ void store(T* p, const float (&in)[VPT]) {
    __align__(16) T t[VPT];
#pragma unroll
    for (int e = 0; e < VPT; ++e) t[e] = from_f32<T>(in[e]);
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(t)[i];
  }
};

// ------------------------------------------------ B5, B6, B7: shared parts
//
// A group of G lanes owns one (row, item): each lane holds V consecutive
// values of the head, 16 bytes (G = dh * sizeof(T) / 16, at most 32), so a
// gathered row is one 16-byte load a lane. A warp holds 32 / G groups, a
// CTA CTA_ROWS consecutive rows of one item, which its groups take in turn
// (the sources of nearby rows overlap, so L1 and L2 serve the repeats). The
// first CAP entries of a row's list and their rows are all loaded before
// the first dot product: an invalid entry loads row 0 and is masked after,
// so no register is cleared. In B6 and B7 the chunk's CAP scores and CAP
// g . v products are completed together: a first butterfly step that leaves
// the scores to the group's lower half and the g . v products to its upper
// half, then a plain butterfly on CAP values; B5 completes its CAP scores
// alone, in a plain butterfly. Each lane then takes the softmax arithmetic
// of its own slots (an expf and a division a neighbour, not CAP of each on
// every lane), and the group reads each neighbour's p (or dl) from the lane
// that holds it.

constexpr int CTA_ROWS = 64;  // consecutive rows of one item a CTA

// Where an operand's rows lie, in elements: the items of the wrapper's fold
// `outer` and `inner` apart, a row `row` further on (a 32-bit stride, so a
// row's offset is one wide multiply; offsets are 64-bit). Row starts are
// 16-byte aligned (the wrappers copy an operand that is not, and count it).
struct Rows {
  int64_t outer, inner;
  int row;
};

// Item b of the grid as (b / inner, b % inner) of the fold: divided once a
// thread, in 32 bits, and shared by every operand.
struct Item {
  int o, i;
  __device__ __forceinline__ Item(int b, int inner) : o(b / inner), i(b % inner) {}
  __device__ __forceinline__ int64_t at(const Rows& r) const {
    return o * r.outer + i * r.inner;
  }
};

constexpr int pow2_at_least(int x) { return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2); }

template <typename T, int VPT>
struct Geo {
  static constexpr int DH = 32 * VPT;
  static constexpr int BYTES = DH * (int)sizeof(T);
  static constexpr int G = BYTES / 16 < 32 ? BYTES / 16 : 32;  // lanes a row
  static constexpr int V = DH / G;                             // values a lane
  static constexpr int NC = V * (int)sizeof(T) / 16;  // 16-byte loads a lane
  // Neighbours held in registers at once: 7 at 16 bytes a lane (the
  // icosphere's widest row, degree 6 and the self-loop), fewer for wider
  // lanes.
  static constexpr int CAP = NC == 1 ? 7 : 8 / NC;
  static constexpr int GPW = 32 / G;  // groups a warp
  // Slots: the lanes of a half-group that own a neighbour's softmax each
  // (W), and the slots of each lane (SL).
  static constexpr int W = G / 2 < pow2_at_least(CAP) ? G / 2 : pow2_at_least(CAP);
  static constexpr int SL = pow2_at_least(CAP) / W;
};

__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// A lane's V values of one row, as loaded: NC 16-byte chunks, read as
// float32 one value at a time (bf16 widens exactly).
template <typename T, int NC>
struct Piece {
  static constexpr int PER = 16 / (int)sizeof(T);  // values a chunk
  uint4 c[NC];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < NC; ++i) c[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  __device__ __forceinline__ float at(int e) const {
    const uint4& u = c[e / PER];
    if (sizeof(T) == 4) return __uint_as_float(word(u, e % PER));
    const unsigned w = word(u, (e % PER) >> 1);
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

// The group's lanes and this lane's place in them.
template <int G>
struct Group {
  unsigned mask;  // the group's lanes in the warp
  int first;      // the group's first lane
  int lane;       // this lane in the group
  __device__ __forceinline__ explicit Group(int sub)
      : mask(G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (sub * G)),
        first(sub * G), lane((threadIdx.x & 31) % G) {}
};

// One lane's part of a . b (fmaf in value order). B6 and B7 form every score
// and every g . v with this and pair_sums, with q (or g) first, so B7's p is
// B6's to the bit: B7 subtracts B6's mx and divides by B6's den.
template <typename T, int NC>
__device__ __forceinline__ float lane_dot(const Piece<T, NC>& a,
                                          const Piece<T, NC>& b) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < NC * Piece<T, NC>::PER; ++e) s = fmaf(a.at(e), b.at(e), s);
  return s;
}

// The lane parts of a chunk, s[0..CAP) scores and s[CAP..2 CAP) g . v
// products, completed over the group into h[0..CAP): the first xor step
// (offset G / 2) keeps the scores in the lower half and the products in
// the upper one, sending each lane's other half to its partner; the rest is
// a plain butterfly. Each sum gets the additions of a plain butterfly on
// all 2 CAP values (each step adds the same two values), so its bits do not
// depend on the split.
template <int G, int CAP>
__device__ __forceinline__ void pair_sums(const float (&s)[2 * CAP],
                                          float (&h)[CAP], int lane,
                                          unsigned mask) {
  const bool up = lane & (G / 2);
#pragma unroll
  for (int d = 0; d < CAP; ++d) {
    const float send = up ? s[d] : s[CAP + d];
    h[d] = (up ? s[CAP + d] : s[d]) + __shfl_xor_sync(mask, send, G / 2);
  }
#pragma unroll
  for (int o = G / 4; o > 0; o >>= 1) {
#pragma unroll
    for (int d = 0; d < CAP; ++d) h[d] += __shfl_xor_sync(mask, h[d], o);
  }
}

// This lane's slots d = slot + W x (x < SL) of the completed sums h: the
// score sc and the product dp of each (a slot past CAP holds 0). A lower
// lane holds the scores and takes each product from its partner in the
// upper half, and the other way round.
template <int G, int CAP, int W, int SL>
__device__ __forceinline__ void own_slots(const float (&h)[CAP], int slot,
                                          int lane, unsigned mask,
                                          float (&sc)[SL], float (&dp)[SL]) {
  const bool up = lane & (G / 2);
#pragma unroll
  for (int x = 0; x < SL; ++x) {
    float mine = 0.f;
#pragma unroll
    for (int d = W * x; d < W * x + W && d < CAP; ++d) {
      if (d == slot + W * x) mine = h[d];
    }
    const float other = __shfl_xor_sync(mask, mine, G / 2);
    sc[x] = up ? other : mine;
    dp[x] = up ? mine : other;
  }
}

// Sum over the slots of a half-group, in a fixed order.
template <int W>
__device__ __forceinline__ float slots_sum(float x, unsigned mask) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x += __shfl_xor_sync(mask, x, o);
  return x;
}

// Entries base .. base + CAP - 1 of a list of width `deg` into j (-1 past
// the list's end: its first -1 or the width). Returns their count; `more`
// says the list goes on past them. All CAP + 1 loads are issued at once.
template <int CAP>
__device__ __forceinline__ int list_chunk(const int* list, int base, int deg,
                                          int (&j)[CAP], bool& more) {
  int x[CAP + 1];
#pragma unroll
  for (int d = 0; d <= CAP; ++d) x[d] = base + d < deg ? __ldg(list + base + d) : -1;
  int cnt = 0;
#pragma unroll
  for (int d = 0; d < CAP; ++d) {
    j[d] = cnt == d && x[d] >= 0 ? x[d] : -1;
    cnt += j[d] >= 0;
  }
  more = cnt == CAP && x[CAP] >= 0;
  return cnt;
}

// The rows j[d] of a (rows, dh) matrix `rs` elements apart, seen from this
// lane (`base` holds the item's and the lane's offset). A row at or past
// `rows`, or -1, loads row 0 instead and is masked by the caller (its bit
// in the returned mask is clear).
template <typename T, int NC, int CAP>
__device__ __forceinline__ unsigned gather(const T* base, const int (&j)[CAP],
                                           int rows, int rs,
                                           Piece<T, NC> (&out)[CAP]) {
  unsigned real = 0;
#pragma unroll
  for (int d = 0; d < CAP; ++d) {
    const bool in = j[d] >= 0 && j[d] < rows;
    real |= (in ? 1u : 0u) << d;
    out[d].load(base + (int64_t)(in ? j[d] : 0) * rs);
  }
  return real;
}

// ----------------------------------------------------------- B5 / B5b

// The lane parts s[0..CAP) summed over the group in place: a plain
// butterfly, after which every lane holds the same bits of each sum.
template <int G, int CAP>
__device__ __forceinline__ void group_sums(float (&s)[CAP], unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int d = 0; d < CAP; ++d) s[d] += __shfl_xor_sync(mask, s[d], o);
  }
}

template <typename T, int VPT>
struct Fwd {
  using Gm = Geo<T, VPT>;
  static constexpr int G = Gm::G, CAP = Gm::CAP, V = Gm::V, W = Gm::W,
                       SL = Gm::SL, NC = Gm::NC;
  using P = Piece<T, NC>;

  // The chunk's scores (q . k_d) * scale, in every lane of the group; a row
  // at or past n_kv (its bit in `real` clear) is a zero k row: score 0.
  static __device__ __forceinline__ void scores(const P& qi, const P (&kr)[CAP],
                                                unsigned real, float scale,
                                                unsigned mask, float (&sc)[CAP]) {
#pragma unroll
    for (int d = 0; d < CAP; ++d) sc[d] = lane_dot(qi, kr[d]);
    group_sums<G, CAP>(sc, mask);
#pragma unroll
    for (int d = 0; d < CAP; ++d) sc[d] = real >> d & 1u ? __fmul_rn(sc[d], scale) : 0.f;
  }

  // exp(sc[d] - mx) of this lane's slots d = slot + W x that are below cnt
  // (0 for the others).
  static __device__ __forceinline__ void slot_exps(const float (&sc)[CAP], int cnt,
                                                   float mx, int slot,
                                                   float (&e)[SL]) {
#pragma unroll
    for (int x = 0; x < SL; ++x) {
      float mine = 0.f;
#pragma unroll
      for (int d = W * x; d < W * x + W && d < CAP; ++d) {
        if (d == slot + W * x) mine = sc[d];
      }
      e[x] = slot + W * x < cnt ? expf(mine - mx) : 0.f;
    }
  }

  // The sum of the chunk's exps over the group's slots.
  static __device__ __forceinline__ float exps_sum(const float (&e)[SL], unsigned mask) {
    float t = 0.f;
#pragma unroll
    for (int x = 0; x < SL; ++x) t += e[x];
    return slots_sum<W>(t, mask);
  }

  // acc += round(e_d / div) v_d over the chunk's rows below n_kv, each p
  // formed on the lane that owns its slot and read from there.
  static __device__ __forceinline__ void add_rows(const float (&e)[SL], float div,
                                                  const P (&vr)[CAP], int cnt,
                                                  unsigned real, const Group<G>& grp,
                                                  float (&acc)[V]) {
    float p[SL];
#pragma unroll
    for (int x = 0; x < SL; ++x) p[x] = round_to<T>(e[x] / div);
#pragma unroll
    for (int d = 0; d < CAP; ++d) {
      const float w = __shfl_sync(grp.mask, p[d / W], grp.first + d % W);
      if (d < cnt && (real >> d & 1u)) {
#pragma unroll
        for (int x = 0; x < V; ++x) acc[x] = fmaf(w, vr[d].at(x), acc[x]);
      }
    }
  }

  // A row of at most CAP sources, its k and v rows gathered: acc = out.
  static __device__ __forceinline__ void row(const P& qi, const P (&kr)[CAP],
                                             const P (&vr)[CAP], int cnt,
                                             unsigned real, float scale,
                                             const Group<G>& grp, float (&acc)[V]) {
    float sc[CAP], e[SL];
    scores(qi, kr, real, scale, grp.mask, sc);
    float mx = NEG_BIG;
#pragma unroll
    for (int d = 0; d < CAP; ++d) {
      if (d < cnt) mx = fmaxf(mx, sc[d]);
    }
    slot_exps(sc, cnt, mx, grp.lane % W, e);
    const float den = exps_sum(e, grp.mask);
    add_rows(e, den == 0.f ? 1.f : den, vr, cnt, real, grp, acc);
  }

  // A list over CAP entries: its chunks walked twice, gathered again each
  // time, with no shared scratch (no width is refused): the max and den
  // first (den rescaled whenever the max grows), then round(p) v.
  static __device__ void wide(const P& qi, const int* row, int deg, const T* kb,
                              const T* vb, int rs, int n_kv,
                              float scale, const Group<G>& grp, float (&acc)[V]) {
    const int slot = grp.lane % W;
    float mx = NEG_BIG, den = 0.f;
    for (int base = 0; base < deg; base += CAP) {
      int j[CAP];
      bool more;
      const int cnt = list_chunk<CAP>(row, base, deg, j, more);
      P kr[CAP];
      const unsigned real = gather<T, NC, CAP>(kb, j, n_kv, rs, kr);
      float sc[CAP], e[SL];
      scores(qi, kr, real, scale, grp.mask, sc);
      float m = mx;
#pragma unroll
      for (int d = 0; d < CAP; ++d) {
        if (d < cnt) m = fmaxf(m, sc[d]);
      }
      slot_exps(sc, cnt, m, slot, e);
      den = den * expf(mx - m) + exps_sum(e, grp.mask);
      mx = m;
      if (!more) break;
    }
    const float div = den == 0.f ? 1.f : den;
    for (int base = 0; base < deg; base += CAP) {
      int j[CAP];
      bool more;
      const int cnt = list_chunk<CAP>(row, base, deg, j, more);
      P kr[CAP], vr[CAP];
      const unsigned real = gather<T, NC, CAP>(kb, j, n_kv, rs, kr);
      gather<T, NC, CAP>(vb, j, n_kv, rs, vr);
      float sc[CAP], e[SL];
      scores(qi, kr, real, scale, grp.mask, sc);
      slot_exps(sc, cnt, mx, slot, e);
      add_rows(e, div, vr, cnt, real, grp, acc);
      if (!more) break;
    }
  }
};

// The output of CTA_ROWS consecutive destination rows of one item a CTA. A
// row's list of at most CAP entries (every mesh row at L7) takes one pass:
// its k and v rows gathered at once, CAP scores completed together, one
// expf a neighbour on the lane that owns its slot, out summed from the
// kept v rows.
template <typename T, int VPT>
__global__ void __launch_bounds__(NT, 3)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ nbr,
                T* __restrict__ out, Rows lq, Rows lk, int inner, int n_q,
                int n_kv, int deg, float scale) {
  using F = Fwd<T, VPT>;
  constexpr int G = F::G, CAP = F::CAP, V = F::V;
  constexpr int NG = WARPS * F::Gm::GPW;  // groups a CTA
  const int sub = (threadIdx.x & 31) / G;
  const Group<G> grp(sub);
  const Item it((int)blockIdx.y, inner);
  const int end = min(n_q, ((int)blockIdx.x + 1) * CTA_ROWS);
  const int64_t qo = it.at(lq) + grp.lane * V;
  const T* kb = k + it.at(lk) + grp.lane * V;
  const T* vb = v + it.at(lk) + grp.lane * V;
  for (int i = (int)blockIdx.x * CTA_ROWS + (int)(threadIdx.x >> 5) * F::Gm::GPW + sub;
       i < end; i += NG) {
    const int64_t at = qo + (int64_t)i * lq.row;
    const int* row = nbr + (int64_t)i * deg;
    typename F::P qi;
    qi.load(q + at);
    int j[CAP];
    bool more;
    const int cnt = list_chunk<CAP>(row, 0, deg, j, more);
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    if (!more) {
      typename F::P kr[CAP], vr[CAP];
      const unsigned real = gather<T, F::NC, CAP>(kb, j, n_kv, lk.row, kr);
      gather<T, F::NC, CAP>(vb, j, n_kv, lk.row, vr);
      F::row(qi, kr, vr, cnt, real, scale, grp, acc);
    } else {
      F::wide(qi, row, deg, kb, vb, lk.row, n_kv, scale, grp, acc);
    }
    Lane<T, V>::store(out + at, acc);
  }
}

// ----------------------------------------------------------- B6 / B6b

template <typename T, int VPT>
struct Dq {
  using Gm = Geo<T, VPT>;
  static constexpr int G = Gm::G, CAP = Gm::CAP, V = Gm::V, W = Gm::W,
                       SL = Gm::SL, NC = Gm::NC;
  using P = Piece<T, NC>;

  // A row of at most CAP sources, gathered (kr, vr; `real` marks the rows
  // below n_kv, the others read as zero): mx, den, delta and acc = dq.
  static __device__ __forceinline__ void row(const P& qi, const P& gi,
                                             const P (&kr)[CAP],
                                             const P (&vr)[CAP], int cnt,
                                             unsigned real, float scale,
                                             const Group<G>& grp, float& mx,
                                             float& den, float& delta,
                                             float (&acc)[V]) {
    float s[2 * CAP], h[CAP];
#pragma unroll
    for (int d = 0; d < CAP; ++d) {
      s[d] = lane_dot(qi, kr[d]);
      s[CAP + d] = lane_dot(gi, vr[d]);
    }
    pair_sums<G, CAP>(s, h, grp.lane, grp.mask);
#pragma unroll
    for (int d = 0; d < CAP; ++d) {
      if (!(real >> d & 1u)) h[d] = 0.f;  // a zero k and v row
    }
    // The row max, on the lower half (which holds the scores), then given
    // to the upper half. __fmul_rn is never fused into a later add: B7
    // rounds the same product the same way.
    float m = NEG_BIG;
#pragma unroll
    for (int d = 0; d < CAP; ++d) {
      if (d < cnt) m = fmaxf(m, __fmul_rn(h[d], scale));
    }
    const float mo = __shfl_xor_sync(grp.mask, m, G / 2);
    mx = grp.lane & (G / 2) ? mo : m;
    const int slot = grp.lane % W;
    float sc[SL], dp[SL], e[SL], dl[SL], t = 0.f;
    own_slots<G, CAP, W, SL>(h, slot, grp.lane, grp.mask, sc, dp);
#pragma unroll
    for (int x = 0; x < SL; ++x) {
      e[x] = slot + W * x < cnt ? expf(__fmul_rn(sc[x], scale) - mx) : 0.f;
      t += e[x];
    }
    den = slots_sum<W>(t, grp.mask);
    const float div = den == 0.f ? 1.f : den;
    t = 0.f;
#pragma unroll
    for (int x = 0; x < SL; ++x) {
      if (slot + W * x < cnt) t += dp[x] * (e[x] / div);
    }
    delta = slots_sum<W>(t, grp.mask);
#pragma unroll
    for (int x = 0; x < SL; ++x) {
      dl[x] = round_to<T>(e[x] / div * (dp[x] - delta) * scale);
    }
#pragma unroll
    for (int d = 0; d < CAP; ++d) {
      const float w = __shfl_sync(grp.mask, dl[d / W], grp.first + d % W);
      if (d < cnt && (real >> d & 1u)) {
#pragma unroll
        for (int x = 0; x < V; ++x) acc[x] = fmaf(w, kr[d].at(x), acc[x]);
      }
    }
  }

  // A list over CAP entries: its chunks walked four times (row max, den,
  // delta, dq), gathered again each time, with every lane taking every
  // slot; no shared scratch, so no width is refused.
  static __device__ void wide(const P& qi, const P& gi, const int* row,
                              int deg, const T* kb, const T* vb, int rs,
                              int n_kv, float scale,
                              const Group<G>& grp, float& mx,
                              float& den, float& delta, float (&acc)[V]) {
    float div = 1.f;
    mx = NEG_BIG;
    den = delta = 0.f;
    for (int pass = 0; pass < 4; ++pass) {
      for (int base = 0; base < deg; base += CAP) {
        int j[CAP];
        bool more;
        const int cnt = list_chunk<CAP>(row, base, deg, j, more);
        P kr[CAP], vr[CAP];
        const unsigned real = gather<T, NC, CAP>(kb, j, n_kv, rs, kr);
        gather<T, NC, CAP>(vb, j, n_kv, rs, vr);
        float s[2 * CAP], h[CAP], hs[CAP];
#pragma unroll
        for (int d = 0; d < CAP; ++d) {
          s[d] = lane_dot(qi, kr[d]);
          s[CAP + d] = lane_dot(gi, vr[d]);
        }
        pair_sums<G, CAP>(s, h, grp.lane, grp.mask);
#pragma unroll
        for (int d = 0; d < CAP; ++d) {
          if (!(real >> d & 1u)) h[d] = 0.f;
          // every lane: the score (lower half) and product (upper half)
          hs[d] = __shfl_xor_sync(grp.mask, h[d], G / 2);
        }
        const bool up = grp.lane & (G / 2);
#pragma unroll
        for (int d = 0; d < CAP; ++d) {
          if (d >= cnt) continue;
          const float sc = __fmul_rn(up ? hs[d] : h[d], scale);
          const float dp = up ? h[d] : hs[d];
          if (pass == 0) {
            mx = fmaxf(mx, sc);
          } else if (pass == 1) {
            den += expf(sc - mx);
          } else if (pass == 2) {
            delta += dp * (expf(sc - mx) / div);
          } else if (real >> d & 1u) {
            const float dl = round_to<T>(expf(sc - mx) / div * (dp - delta) * scale);
#pragma unroll
            for (int x = 0; x < V; ++x) acc[x] = fmaf(dl, kr[d].at(x), acc[x]);
          }
        }
        if (!more) break;
      }
      if (pass == 1) div = den == 0.f ? 1.f : den;
    }
  }
};

// dQ and the stats of CTA_ROWS consecutive destination rows of one item a
// CTA. A row's list of at most CAP entries (every mesh row at L7: degree
// <= 6 plus the self-loop) takes one pass: its k and v rows gathered at
// once and kept, one expf a neighbour, dq summed from the kept k rows. At
// most 80 registers a thread, so 3 CTAs (24 warps) an SM: at dh 128 bf16
// that spills ~100 bytes a thread, and is still faster on an H100 than 2
// CTAs without a spill, because the extra warps hide more of each row's
// chain (B7, with two accumulators, is 2.4x slower at 80 and keeps 2).
template <typename T, int VPT>
__global__ void __launch_bounds__(NT, 3)
attn_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ g,
               const int* __restrict__ nbr, T* __restrict__ dq,
               float* __restrict__ stats, Rows lq, Rows lk, int inner,
               int n_q, int n_kv, int deg, float scale) {
  using W = Dq<T, VPT>;
  constexpr int G = W::G, CAP = W::CAP, V = W::V;
  constexpr int NG = WARPS * W::Gm::GPW;  // groups a CTA
  const int sub = (threadIdx.x & 31) / G;
  const Group<G> grp(sub);
  const Item it((int)blockIdx.y, inner);
  const int end = min(n_q, ((int)blockIdx.x + 1) * CTA_ROWS);
  const int64_t qo = it.at(lq) + grp.lane * V;
  const T* kb = k + it.at(lk) + grp.lane * V;
  const T* vb = v + it.at(lk) + grp.lane * V;
  for (int i = (int)blockIdx.x * CTA_ROWS + (int)(threadIdx.x >> 5) * W::Gm::GPW + sub;
       i < end; i += NG) {
    const int64_t at = qo + (int64_t)i * lq.row;
    const int* row = nbr + (int64_t)i * deg;
    typename W::P qi, gi;
    qi.load(q + at);
    gi.load(g + at);
    int j[CAP];
    bool more;
    const int cnt = list_chunk<CAP>(row, 0, deg, j, more);
    float mx, den, delta, acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    if (!more) {
      typename W::P kr[CAP], vr[CAP];
      const unsigned real = gather<T, W::NC, CAP>(kb, j, n_kv, lk.row, kr);
      gather<T, W::NC, CAP>(vb, j, n_kv, lk.row, vr);
      W::row(qi, gi, kr, vr, cnt, real, scale, grp, mx, den, delta, acc);
    } else {
      W::wide(qi, gi, row, deg, kb, vb, lk.row, n_kv, scale, grp, mx, den,
              delta, acc);
    }
    Lane<T, V>::store(dq + at, acc);
    if (grp.lane == 0) {
      float* st = stats + ((int64_t)blockIdx.y * n_q + i) * 3;
      st[0] = mx;
      st[1] = den;
      st[2] = delta;
    }
  }
}

// ----------------------------------------------------------- B7 / B7b

// dK and dV of CTA_ROWS consecutive source rows of one item a CTA, each
// over the destination rows of its transpose list, CAP at a time: their q
// and g rows and the stats of this lane's slots loaded at once, the chunk's
// 2 CAP dot products completed together, p and dl as B6 forms them, each on
// the lane that owns its slot. The list is read once at any width; sums run
// in list order.
template <typename T, int VPT>
__global__ void __launch_bounds__(NT, 2)
attn_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ g,
                 const float* __restrict__ stats,
                 const int* __restrict__ nbr_t, T* __restrict__ dk,
                 T* __restrict__ dv, Rows lq, Rows lk, int inner, int n_q,
                 int n_kv, int deg_t, float scale) {
  using Gm = Geo<T, VPT>;
  constexpr int G = Gm::G, CAP = Gm::CAP, V = Gm::V;
  constexpr int W = Gm::W, SL = Gm::SL, NG = WARPS * Gm::GPW;
  using P = Piece<T, Gm::NC>;
  const int sub = (threadIdx.x & 31) / G;
  const Group<G> grp(sub);
  const Item it((int)blockIdx.y, inner);
  const int64_t b = blockIdx.y;
  const int end = min(n_kv, ((int)blockIdx.x + 1) * CTA_ROWS);
  const int slot = grp.lane % W;
  const T* qb = q + it.at(lq) + grp.lane * V;
  const T* gb = g + it.at(lq) + grp.lane * V;
  const int64_t ko = it.at(lk) + grp.lane * V;
  const float* sb = stats + b * n_q * 3;
  for (int c = (int)blockIdx.x * CTA_ROWS + (threadIdx.x >> 5) * Gm::GPW + sub;
       c < end; c += NG) {
    const int* col = nbr_t + (int64_t)c * deg_t;
    const int64_t at = ko + (int64_t)c * lk.row;
    P kc, vc;
    kc.load(k + at);
    vc.load(v + at);
    float ak[V], av[V];
#pragma unroll
    for (int e = 0; e < V; ++e) ak[e] = av[e] = 0.f;
    for (int base = 0; base < deg_t; base += CAP) {
      int ii[CAP];
      bool more;
      list_chunk<CAP>(col, base, deg_t, ii, more);
      P qr[CAP], gr[CAP];
      // A row at or past n_q is a zero q and g row: it adds nothing.
      const unsigned live = gather<T, Gm::NC, CAP>(qb, ii, n_q, lq.row, qr);
      gather<T, Gm::NC, CAP>(gb, ii, n_q, lq.row, gr);
      int mine[SL];  // this lane's slots' rows
      float mx[SL], den[SL], dlt[SL];
#pragma unroll
      for (int x = 0; x < SL; ++x) {
        mine[x] = -1;
#pragma unroll
        for (int d = W * x; d < W * x + W && d < CAP; ++d) {
          if (d == slot + W * x && (live >> d & 1u)) mine[x] = ii[d];
        }
        const float* st = sb + (int64_t)(mine[x] < 0 ? 0 : mine[x]) * 3;
        mx[x] = __ldg(st);
        den[x] = __ldg(st + 1);
        dlt[x] = __ldg(st + 2);
      }
      float s[2 * CAP], h[CAP], sc[SL], dp[SL], rdl[SL], rp[SL];
#pragma unroll
      for (int d = 0; d < CAP; ++d) {
        s[d] = lane_dot(qr[d], kc);
        s[CAP + d] = lane_dot(gr[d], vc);
      }
      pair_sums<G, CAP>(s, h, grp.lane, grp.mask);
      own_slots<G, CAP, W, SL>(h, slot, grp.lane, grp.mask, sc, dp);
#pragma unroll
      for (int x = 0; x < SL; ++x) {
        const float p = expf(__fmul_rn(sc[x], scale) - mx[x]) /
                        (den[x] == 0.f ? 1.f : den[x]);
        rdl[x] = round_to<T>(p * (dp[x] - dlt[x]) * scale);
        rp[x] = round_to<T>(p);
      }
#pragma unroll
      for (int d = 0; d < CAP; ++d) {
        const int from = grp.first + d % W;
        const float wk = __shfl_sync(grp.mask, rdl[d / W], from);
        const float wv = __shfl_sync(grp.mask, rp[d / W], from);
        if (live >> d & 1u) {
#pragma unroll
          for (int x = 0; x < V; ++x) {
            ak[x] = fmaf(wk, qr[d].at(x), ak[x]);
            av[x] = fmaf(wv, gr[d].at(x), av[x]);
          }
        }
      }
      if (!more) break;
    }
    Lane<T, V>::store(dk + at, ak);
    Lane<T, V>::store(dv + at, av);
  }
}

// ----------------------------------------------------------- launches

// The kernels' grid: CTA_ROWS rows of one item a CTA.
dim3 rows_grid(int rows, int nb) {
  return dim3((unsigned)((rows + CTA_ROWS - 1) / CTA_ROWS), (unsigned)nb);
}

// The layout of operand `at` from the entry's table: (outer, inner, row).
Rows rows_of(const long long* lay, int at) {
  return Rows{(int64_t)lay[3 * at], (int64_t)lay[3 * at + 1],
              (int)lay[3 * at + 2]};
}

template <typename T, int VPT>
int launch_fwd(const void* q, const void* k, const void* v, const int* nbr,
               void* out, const long long* lay, int nb, int inner, int n_q,
               int n_kv, int deg, float scale, cudaStream_t st) {
  attn_fwd_kernel<T, VPT><<<rows_grid(n_q, nb), NT, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), nbr, static_cast<T*>(out), rows_of(lay, 0),
      rows_of(lay, 1), inner, n_q, n_kv, deg, scale);
  return (int)cudaGetLastError();
}

template <typename T, int VPT>
int launch_dq(const void* q, const void* k, const void* v, const void* g,
              const int* nbr, void* dq, float* stats, const long long* lay,
              int nb, int inner, int n_q, int n_kv, int deg, float scale,
              cudaStream_t st) {
  attn_dq_kernel<T, VPT><<<rows_grid(n_q, nb), NT, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), nbr,
      static_cast<T*>(dq), stats, rows_of(lay, 0), rows_of(lay, 1), inner,
      n_q, n_kv, deg, scale);
  return (int)cudaGetLastError();
}

template <typename T, int VPT>
int launch_dkdv(const void* q, const void* k, const void* v, const void* g,
                const float* stats, const int* nbr_t, void* dk, void* dv,
                const long long* lay, int nb, int inner, int n_q, int n_kv,
                int deg_t, float scale, cudaStream_t st) {
  attn_dkdv_kernel<T, VPT><<<rows_grid(n_kv, nb), NT, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), stats, nbr_t,
      static_cast<T*>(dk), static_cast<T*>(dv), rows_of(lay, 0),
      rows_of(lay, 1), inner, n_q, n_kv, deg_t, scale);
  return (int)cudaGetLastError();
}

// The launch's sizes, and the two layouts in `lay`: row strides that fit
// the kernels' 32 bits.
bool args_ok(const long long* lay, int nb, int inner, int n_q, int n_kv,
             int deg, int vpt, int dtype) {
  if (lay == nullptr) return false;
  for (int at = 0; at < 2; ++at) {
    if (lay[3 * at + 2] < 0 || lay[3 * at + 2] > 0x7fffffffLL) return false;
  }
  return nb >= 1 && nb <= 65535 && inner >= 1 && nb % inner == 0 &&
         n_q >= 1 && n_kv >= 1 && deg >= 1 && vpt >= 1 && vpt <= 16 &&
         (dtype == 0 || dtype == 1);
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

// Every operand is nb = n0 x inner items of rows of dh values; `lay` holds
// two layouts of three int64 strides, in elements, (outer, inner, row):
// q's, which g, out and dq share, then k's, which v, dk and dv share. Item
// b, row i starts at (b / inner) outer + (b % inner) inner + i row. Row
// starts are 16-byte aligned, a row's values consecutive, and a row
// stride below 2^31.

// Forward: q (nb, n_q, dh), k and v (nb, n_kv, dh), nbr (N_pad, deg) int32
// with n_q <= N_pad, out (nb, n_q, dh).
extern "C" int gwen_attn_fwd(const void* q, const void* k, const void* v,
                             const void* nbr, void* out, const long long* lay,
                             int nb, int inner, int n_q, int n_kv, int deg,
                             int vpt, float scale, int dtype, void* stream) {
  if (!args_ok(lay, nb, inner, n_q, n_kv, deg, vpt, dtype)) return -1;
  const int* nb_ = static_cast<const int*>(nbr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GWEN_ATTN_DISPATCH(launch_fwd, q, k, v, nb_, out, lay, nb, inner, n_q,
                     n_kv, deg, scale, st);
}

// dQ and the stats: g and dq like q, stats (nb, n_q, 3) float32, contiguous,
// holding (mx, den, delta) per row.
extern "C" int gwen_attn_dq(const void* q, const void* k, const void* v,
                            const void* g, const void* nbr, void* dq,
                            void* stats, const long long* lay, int nb,
                            int inner, int n_q, int n_kv, int deg, int vpt,
                            float scale, int dtype, void* stream) {
  if (!args_ok(lay, nb, inner, n_q, n_kv, deg, vpt, dtype)) return -1;
  const int* nb_ = static_cast<const int*>(nbr);
  float* sp = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GWEN_ATTN_DISPATCH(launch_dq, q, k, v, g, nb_, dq, sp, lay, nb, inner, n_q,
                     n_kv, deg, scale, st);
}

// dK and dV: nbr_t (num_src_rows, deg_t) int32 with n_kv <= num_src_rows;
// dk and dv like k.
extern "C" int gwen_attn_dkdv(const void* q, const void* k, const void* v,
                              const void* g, const void* stats,
                              const void* nbr_t, void* dk, void* dv,
                              const long long* lay, int nb, int inner,
                              int n_q, int n_kv, int deg_t, int vpt,
                              float scale, int dtype, void* stream) {
  if (!args_ok(lay, nb, inner, n_q, n_kv, deg_t, vpt, dtype)) return -1;
  const float* sp = static_cast<const float*>(stats);
  const int* nt = static_cast<const int*>(nbr_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GWEN_ATTN_DISPATCH(launch_dkdv, q, k, v, g, sp, nt, dk, dv, lay, nb, inner,
                     n_q, n_kv, deg_t, scale, st);
}
