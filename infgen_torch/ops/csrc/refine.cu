// The per-insert heading/offset refine on Hopper: L layers x (map attention,
// agent attention) over the inserted agent's R-row neighbourhood, then the
// heading-bin and offset heads, in one launch of one thread-block cluster.
//
// Replaces the TPU kernel infgen_tpu/ops/refine_kernel.py::refine_kernel.
// Row 0 is the inserted agent and the only row that attends; rows 1.. are
// its agent neighbours (zero rows past the real ones), whose features
// evolve by the zero-aggregate closed form and serve as row 0's agent keys.
// As on the TPU, row 0's aggregate is scattered into an otherwise zero
// [R, D] aggregate and one gated-update / FFN epilogue runs over all rows
// (agg == 0 is the closed form). Map key k and its relation sit in row k of
// pl_keys / r_pl. The TPU's head selector and 128-lane output padding are
// gone: the outputs are the angle_size heading logits and the two offset
// values before tanh.
//
// Bound. At the flagship shapes (D=128, 8x16 heads, L=3, R=32, 120 heading
// bins) in bf16 one pass must read its weights, 16 D^2 per sublayer (to_q,
// to_k, to_v, w_kr, w_vr, to_g 2, to_s, to_out, ff 8) times 6 plus the heads:
// about 3.3 MB, and 50 KB of inputs: about 1 us at 3.35 TB/s. Its
// arithmetic with every row live is about 50 M multiply-adds (0.1 us at the
// bf16 tensor-core peak): bytes bound it.
//
// Design. One cluster of H CTAs (8 at the flagship shapes), 256 threads
// each; CTA c owns head c, that is the 16 columns [16c, 16c + 16) of every
// D-wide product (64 columns of ff_0), over all R <= 32 rows:
//   - every CTA keeps the whole [32, D] features and the products' operand
//     rows (the LayerNorms, rounded to the compute type T) in its shared
//     memory; the LayerNorms and elementwise steps run on whole rows in
//     every CTA, so only the products are split;
//   - bf16: the products run on tensor cores (mma.sync m16n8k16, two m16
//     row tiles, fp32 accumulators), whose bf16 operands with fp32 sums are
//     the plain version's arithmetic: only the summation order differs;
//     fp32: the same tiles on CUDA-core FMAs (TF32 would not keep fp32);
//   - each CTA's weight slices are packed on the host into per-CTA stages
//     in the chain's order (refine_kernel.py::refine_tiles): per sublayer
//     the products of the LayerNorms (to_q, to_k, w_kr, to_v, w_vr, to_g's
//     two halves, to_s), then the epilogue's (to_out, ff_0, ff_1), then
//     the heads; bf16 streams each stage by one bulk copy (TMA) on an
//     mbarrier into a two-slot ring, so the next stage lands while this
//     one multiplies; fp32 reads them from L2;
//   - a head's attention needs only its own K, V and q columns, so it
//     stays in its CTA; each product's slice goes to every CTA's copy by
//     distributed shared memory, then one cluster barrier. Four per
//     sublayer: (1) row 0's aggregate, the row-0 partial of to_g's
//     aggregate half and the other rows' gated update; (2) to_out; (3)
//     ff_0; (4) ff_1;
//   - the LayerNorms are latency: a warp normalises four rows at once,
//     with its parameters loaded while a barrier waits. LN_q(x) (and
//     LN_s(x), the agent sublayers' keys) run with ff_postnorm's residual;
//     the operands that do not depend on x (LN_s of the map keys, LN_r of
//     the relations) are split over the cluster, CTA c normalising its
//     32 / H rows for every CTA while warp 0 attends, into buffers of the
//     sublayer's parity.
// Exact shortcuts (the plain version's values, test_torch_kernel_design):
// the aggregate is zero on every row but 0, so agg @ to_g[:D] is a row-0
// mat-vec (each CTA multiplies its head's 16 aggregate values by its rows
// of to_g[:D] for all D columns; every CTA adds the H partials in head
// order) and the other rows' update is g * s; after the last agent
// sublayer only row 0 is read, so that sublayer's epilogue runs on the
// first m16 tile only.
// A buffer that other CTAs write is read only between the barrier that
// completes it and the next barrier, so no CTA can overwrite it early;
// sn / rn are read up to the next sublayer's products, hence a buffer per
// parity.
// What sets its time (scripts/kernel_stamps.py, PERF.md): the exchanges,
// about 2-3 us per barrier with its remote stores, and the LayerNorms.
//
// Lanes. A batched rollout refines one insert per lane (scenario) at once:
// one launch of B clusters, cluster b reading lane b's [R, D] rows and
// masks ([B, R, ...] arrays) and writing its own rows of the outputs, the
// weights shared. An optional lane mask [B] (the lanes that insert) is
// read by every CTA of a cluster before anything else, so a masked-off
// cluster leaves as a whole, its outputs zeroed, before its first barrier.
// The single pass is the launch with B = 1 and no mask; every active lane
// computes what its single pass computes, bit for bit.

#include <cooperative_groups.h>

#include "mma_tiles.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kRows = 32;          // rows of a pass: two m16 tiles
constexpr int kSlice = 16;         // a CTA's columns of a D-wide product
constexpr int kRefThreads = 256;   // 8 warps
constexpr int kMaxCluster = 8;

// The packed vectors, in the order of the pointer array that
// refine_kernel.py::_layouts lays out (sublayer j = 2i + s).
enum Arg {
  LNQ_S, LNQ_B, LNS_S, LNS_B, LNR_S, LNR_B, BQ, BV, BVR, BG, BS, BO, POST_S,
  POST_B, FFP_S, FFP_B, BF0, BF1, FFQ_S, FFQ_B, BH0, LNH_S, LNH_B, BH_HEAD,
  BH_OFF,
  kNumArgs
};

// Blocks of a stage, each [16, ld] (rows of W^T: row n = output column
// 16c + n, k contiguous), except WGA: to_g's aggregate-half rows 16c + n,
// all D columns.
enum BlockA { A_WQ, A_WK, A_WKR, A_WV, A_WVR, A_WGD, A_WS, A_WGA, kBlocksA };

// The per-CTA tiles (refine_kernel.py::tile_layout computes the same):
// rows padded by 16 bytes (the fragment loads hit distinct banks, rows
// stay 16-byte aligned); stage t of CTA c at ((c * stages) + t) * slot.
//   A (sublayer j, t = 2j): the kBlocksA blocks;
//   B (sublayer j, t = 2j + 1): to_out [16, ld], ff_0 [64, ld] (columns
//     [64c, 64c + 64)), ff_1 [16, ld4];
//   H (t = 4L): each head's Dense_0 [16, ld], then this CTA's heading-bin
//     columns [ch c, ch c + ch) [nh, ld] and offset columns [no, ld].
struct TileLayout {
  int ld, ld4;      // padded rows of D and 4D
  int ch, co;       // heading / offset columns per CTA
  int nh, no;       // the same padded to 8 rows
  int a_elems, b_elems, h_elems, slot, stages;
};

template <typename T>
__host__ __device__ inline TileLayout tile_layout(int L, int D, int kc,
                                                  int angle) {
  TileLayout t;
  const int pad = 16 / (int)sizeof(T);
  t.ld = D + pad;
  t.ld4 = 4 * D + pad;
  t.ch = (angle + kc - 1) / kc;
  t.co = (2 + kc - 1) / kc;
  t.nh = (t.ch + 7) / 8 * 8;
  t.no = (t.co + 7) / 8 * 8;
  t.a_elems = kBlocksA * kSlice * t.ld;
  t.b_elems = 5 * kSlice * t.ld + kSlice * t.ld4;
  t.h_elems = (2 * kSlice + t.nh + t.no) * t.ld;
  t.slot = t.a_elems > t.b_elems ? t.a_elems : t.b_elems;
  t.slot = t.slot > t.h_elems ? t.slot : t.h_elems;
  t.stages = 4 * L + 1;
  return t;
}

struct Params {
  const float* x_sub;      // [B, R, D]
  const void* pl_keys;     // [B, R, D] T
  const void* r_pl;        // [B, R, D] T
  const uint8_t* mask_pl;  // [B, R]
  const void* r_aa;        // [B, R, D] T
  const uint8_t* mask_a;   // [B, R]
  const void* tiles;       // [kc, stages, slot] T
  const float* v[kNumArgs];
  float* out_head;         // [B, angle_size]
  float* out_off;          // [B, 2]
  float* trace;            // [B, 2L, R, D] x after each sublayer, or null
  const uint8_t* lanes;    // [B] lane mask, or null: every lane on
  int L, R, D, angle_size;
};

// p's arrays moved to lane b's rows (T: the type of the key rows).
template <typename T>
__device__ __forceinline__ void to_lane(Params& p, size_t b) {
  const size_t rd = (size_t)p.R * p.D;
  p.x_sub += b * rd;
  p.pl_keys = static_cast<const T*>(p.pl_keys) + b * rd;
  p.r_pl = static_cast<const T*>(p.r_pl) + b * rd;
  p.r_aa = static_cast<const T*>(p.r_aa) + b * rd;
  p.mask_pl += b * p.R;
  p.mask_a += b * p.R;
  p.out_head += b * p.angle_size;
  p.out_off += b * 2;
  if (p.trace != nullptr) p.trace += b * 2 * p.L * rd;
}

template <typename T>
struct RefSmem {
  float *x;      // [32, D] features
  float *ob;     // [32, D] gathered to_out, then ff_1
  float *kv;     // [2, 32, 16] this head's K and V
  float *gs;     // [2, 32, 16] to_g's dst_n half (no bias), to_s (+ b_s)
  float *part;   // [4, 32, 16] ff_1's k-split partials; the heads' too
  float *q, *attn, *a0s;                // [16], [32], [16]
  float *a0, *xp, *g0, *s0;             // exchange: [D], [kc, D], [D], [D]
  float *hb;                            // [2, D] the heads' Dense_0
  T *dn, *ag, *hh, *hop;                // operand rows (T)
  T *sn, *rn;  // [2, 32, ld]: [j % 2] sublayer j's LN_s(src), LN_r(rel)
  T *ring;                              // bf16: [2, slot]
};

// Carves `base` (0 on the host: only the size is wanted); returns bytes.
template <typename T>
__host__ __device__ inline size_t ref_carve(uintptr_t base, int D, int kc,
                                            const TileLayout& t,
                                            RefSmem<T>& s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const uintptr_t p = base + off;
    off += (bytes + 15) / 16 * 16;
    return p;
  };
  const size_t F = sizeof(float), E = sizeof(T);
  s.x = reinterpret_cast<float*>(take(kRows * D * F));
  s.ob = reinterpret_cast<float*>(take(kRows * D * F));
  s.kv = reinterpret_cast<float*>(take(2 * kRows * kSlice * F));
  s.gs = reinterpret_cast<float*>(take(2 * kRows * kSlice * F));
  s.part = reinterpret_cast<float*>(take(4 * kRows * kSlice * F));
  s.q = reinterpret_cast<float*>(take(kSlice * F));
  s.attn = reinterpret_cast<float*>(take(kRows * F));
  s.a0s = reinterpret_cast<float*>(take(kSlice * F));
  s.a0 = reinterpret_cast<float*>(take(D * F));
  s.xp = reinterpret_cast<float*>(take((size_t)kc * D * F));
  s.g0 = reinterpret_cast<float*>(take(D * F));
  s.s0 = reinterpret_cast<float*>(take(D * F));
  s.hb = reinterpret_cast<float*>(take(2 * D * F));
  s.dn = reinterpret_cast<T*>(take((size_t)kRows * t.ld * E));
  s.sn = reinterpret_cast<T*>(take((size_t)2 * kRows * t.ld * E));
  s.rn = reinterpret_cast<T*>(take((size_t)2 * kRows * t.ld * E));
  s.ag = reinterpret_cast<T*>(take((size_t)kRows * t.ld * E));
  s.hh = reinterpret_cast<T*>(take((size_t)kRows * t.ld4 * E));
  s.hop = reinterpret_cast<T*>(take((size_t)2 * t.ld * E));
  s.ring = reinterpret_cast<T*>(
      take(sizeof(T) == 2 ? (size_t)2 * t.slot * E : 0));
  return off;
}

// A matmul operand rounded to T (the plain version's a.to(cdt)).
template <typename T>
__device__ __forceinline__ T to_t(float x);
template <>
__device__ __forceinline__ float to_t<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 to_t<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  __nv_bfloat162 v;
  v.x = to_t<bf16>(a);
  v.y = to_t<bf16>(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// c[0..3] += A[16 m .. 16 m + 16, k0 .. k1) W[n0 .. n0 + 8, k0 .. k1)^T
// for this lane's accumulators of the m16n8 tile: rows 16 m + g (c[0],
// c[1]) and 16 m + g + 8 (c[2], c[3]), columns n0 + 2 t and n0 + 2 t + 1
// (g = lane / 4, t = lane % 4). W holds rows of W^T. bf16: mma.sync; fp32:
// CUDA-core FMAs, k in order.
__device__ __forceinline__ void tile_dot(const bf16* A, int lda, int m,
                                         const bf16* W, int ldw, int n0,
                                         int k0, int k1, float* c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* ap = A + (size_t)(16 * m + g) * lda + 2 * t;
  const bf16* wp = W + (size_t)(n0 + g) * ldw + 2 * t;
#pragma unroll 4
  for (int k = k0; k < k1; k += 16) {
    const uint32_t a[4] = {ld32(ap + k), ld32(ap + 8 * lda + k),
                           ld32(ap + k + 8), ld32(ap + 8 * lda + k + 8)};
    mma_bf16(c, a, ld32(wp + k), ld32(wp + k + 8));
  }
}
__device__ __forceinline__ void tile_dot(const float* A, int lda, int m,
                                         const float* W, int ldw, int n0,
                                         int k0, int k1, float* c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = A + (size_t)(16 * m + g) * lda;
  const float* a1 = a0 + 8 * lda;
  const float* w0 = W + (size_t)(n0 + 2 * t) * ldw;
  const float* w1 = w0 + ldw;
#pragma unroll 2
  for (int k = k0; k < k1; k += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
    const float4 y0 = *reinterpret_cast<const float4*>(w0 + k);
    const float4 y1 = *reinterpret_cast<const float4*>(w1 + k);
    c[0] = fmaf(x0.w, y0.w, fmaf(x0.z, y0.z,
           fmaf(x0.y, y0.y, fmaf(x0.x, y0.x, c[0]))));
    c[1] = fmaf(x0.w, y1.w, fmaf(x0.z, y1.z,
           fmaf(x0.y, y1.y, fmaf(x0.x, y1.x, c[1]))));
    c[2] = fmaf(x1.w, y0.w, fmaf(x1.z, y0.z,
           fmaf(x1.y, y0.y, fmaf(x1.x, y0.x, c[2]))));
    c[3] = fmaf(x1.w, y1.w, fmaf(x1.z, y1.z,
           fmaf(x1.y, y1.y, fmaf(x1.x, y1.x, c[3]))));
  }
}

// This lane's accumulator e of an m16n8 tile: its row and column offsets.
__device__ __forceinline__ int acc_row(int e) {
  return ((threadIdx.x & 31) >> 2) + (e >> 1) * 8;
}
__device__ __forceinline__ int acc_col(int e) {
  return 2 * (threadIdx.x & 3) + (e & 1);
}

// A row of D <= 128 values is held by the lanes of one warp, value k at
// d = lane + 32 k. LayerNorm: two-pass fp32 statistics, (v - mean) * rs *
// s + b; a warp normalises its N rows at once, their shuffles interleaved.

// The LayerNorm scale and offset of this lane's values.
struct LnParams {
  float s[4], b[4];
};
__device__ __forceinline__ LnParams ln_params(const float* s, const float* b,
                                              int D) {
  const int lane = threadIdx.x & 31;
  LnParams p;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = lane + 32 * k;
    p.s[k] = d < D ? s[d] : 0.f;
    p.b[k] = d < D ? b[d] : 0.f;
  }
  return p;
}

template <int N>
__device__ __forceinline__ void warp_sums(float (&a)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] += __shfl_xor_sync(0xffffffffu, a[i], o);
}

// mean and 1 / sqrt(var + eps) of N rows
template <int N>
__device__ __forceinline__ void ln_stats(const float (&v)[N][4], int D,
                                         float (&mean)[N], float (&rs)[N]) {
  const int lane = threadIdx.x & 31;
  float a[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (lane + 32 * k < D) a[i] += v[i][k];
  }
  warp_sums(a);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mean[i] = a[i] / D;
    a[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (lane + 32 * k < D) {
        const float e = v[i][k] - mean[i];
        a[i] += e * e;
      }
  }
  warp_sums(a);
#pragma unroll
  for (int i = 0; i < N; ++i) rs[i] = rsqrtf(a[i] / D + kLnEps);
}

__device__ __forceinline__ float ln_apply(float v, float mean, float rs,
                                          const LnParams& p, int k) {
  return (v - mean) * rs * p.s[k] + p.b[k];
}

// row[d] = T(LayerNorm(v)) for this lane's values
template <typename T>
__device__ __forceinline__ void store_ln(T* row, const float (&v)[4],
                                         float mean, float rs,
                                         const LnParams& p, int D) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (lane + 32 * k < D)
      row[lane + 32 * k] = to_t<T>(ln_apply(v[k], mean, rs, p, k));
}

template <typename In>
__device__ __forceinline__ void load_lanes(float (&v)[4], const In* row,
                                           int D) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = lane + 32 * i;
    v[i] = row != nullptr && d < D ? to_f(row[d]) : 0.f;
  }
}

// The rows of a sublayer's operands that do not depend on x, LN_s of the
// map keys (`src`, map sublayers) and LN_r of the relations, spread over
// the cluster: CTA c normalises rows [c rpc, c rpc + rpc) (rows at or past
// R read as zero), warps w0, w0 + 1, .. one row each in turn, and stores
// them into every CTA's sn / rn.
template <typename T>
__device__ __forceinline__ void input_rows_ln(
    cg::cluster_group& cl, int c, int kc, const T* src, const T* rel, int R,
    T* sn, T* rn, int ld, int D, const LnParams& ps, const LnParams& pr,
    int w0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rpc = (kRows + kc - 1) / kc, nw = 8 - w0;
  const int jobs = (src != nullptr ? 2 : 1) * rpc;
  for (int jb = warp - w0; jb < jobs; jb += nw) {
    const bool key = jb >= rpc;
    const int r = c * rpc + jb % rpc;
    if (r >= kRows) continue;
    float v[1][4], m[1], rs[1];
    load_lanes(v[0], r < R ? (key ? src : rel) + (size_t)r * D : nullptr, D);
    ln_stats(v, D, m, rs);
    const LnParams& pp = key ? ps : pr;
    T y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      y[k] = to_t<T>(ln_apply(v[0][k], m[0], rs[0], pp, k));
    for (int rr = 0; rr < kc; ++rr) {
      T* dst = cl.map_shared_rank(key ? sn : rn, rr) + (size_t)r * ld;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (lane + 32 * k < D) dst[lane + 32 * k] = y[k];
    }
  }
}

// dn[r] = T(LN_q(x[r])) and, if sn is not null, sn[r] = T(LN_s(x[r])) (the
// same statistics) for this warp's N rows warp + 8 i, x[r] in xv.
template <int N, typename T>
__device__ __forceinline__ void x_rows_ln(const float (&xv)[N][4], T* dn,
                                          T* sn, int ld, int D,
                                          const LnParams& pq,
                                          const LnParams& ps) {
  const int warp = threadIdx.x >> 5;
  float m[N], rs[N];
  ln_stats(xv, D, m, rs);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const size_t o = (size_t)(warp + 8 * i) * ld;
    store_ln(dn + o, xv[i], m[i], rs[i], pq, D);
    if (sn != nullptr) store_ln(sn + o, xv[i], m[i], rs[i], ps, D);
  }
}

// x[r] += LN_post(ob[r]); dn[r] = T(LN_ffp(x[r])) for this warp's N rows
// warp + 8 i.
template <typename T, int N>
__device__ __forceinline__ void post_ffp_rows(float* x, const float* ob,
                                              T* dn, int ld, int D,
                                              const LnParams& pp,
                                              const LnParams& pf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float o[N][4], xv[N][4], m[N], rs[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    load_lanes(o[i], ob + (size_t)(warp + 8 * i) * D, D);
    load_lanes(xv[i], x + (size_t)(warp + 8 * i) * D, D);
  }
  ln_stats(o, D, m, rs);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      xv[i][k] += ln_apply(o[i][k], m[i], rs[i], pp, k);
      if (lane + 32 * k < D) x[(size_t)(warp + 8 * i) * D + lane + 32 * k] =
          xv[i][k];
    }
  ln_stats(xv, D, m, rs);
#pragma unroll
  for (int i = 0; i < N; ++i)
    store_ln(dn + (size_t)(warp + 8 * i) * ld, xv[i], m[i], rs[i], pf, D);
}

// x[r] += LN_ffq(ob[r]) for this warp's N rows warp + 8 i; rows < R also
// into `trace` (if not null). With `next`, the next sublayer's operands
// from the new rows: dn = T(LN_q(x)), and sn = T(LN_s(x)) if sn is not
// null (an agent sublayer, whose keys are the rows).
template <int N, typename T>
__device__ __forceinline__ void ffq_rows(float* x, const float* ob,
                                         float* trace, int R, int D,
                                         const LnParams& pf, bool next,
                                         T* dn, T* sn, int ld,
                                         const LnParams& pq,
                                         const LnParams& ps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float f[N][4], m[N], rs[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    load_lanes(f[i], ob + (size_t)(warp + 8 * i) * D, D);
  ln_stats(f, D, m, rs);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = warp + 8 * i;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = lane + 32 * k;
      if (d < D) {
        f[i][k] = x[(size_t)r * D + d] + ln_apply(f[i][k], m[i], rs[i], pf, k);
        x[(size_t)r * D + d] = f[i][k];
        if (trace != nullptr && r < R) trace[(size_t)r * D + d] = f[i][k];
      }
    }
  }
  if (next) x_rows_ln(f, dn, sn, ld, D, pq, ps);
}

// The weight stages of this CTA: bf16 through the ring, fp32 from L2.
template <typename T>
struct Stages {
  const T* src;        // this CTA's stage 0 in global memory
  T* ring;             // [2, slot] (bf16)
  uint64_t* bar;       // [2] (bf16)
  TileLayout t;

  __device__ uint32_t bytes(int st) const {
    const int e = st == t.stages - 1 ? t.h_elems
                                     : st % 2 ? t.b_elems : t.a_elems;
    return (uint32_t)e * sizeof(T);
  }
  // thread 0: start the copy of stage st into its slot (st % 2), once the
  // block is done with the slot's previous stage
  __device__ void issue(int st) {
    if (sizeof(T) != 2 || st >= t.stages || threadIdx.x != 0) return;
    fence_proxy_async();
    mbar_expect_tx(bar + st % 2, bytes(st));
    bulk_g2s(ring + (size_t)(st % 2) * t.slot, src + (size_t)st * t.slot,
             bytes(st), bar + st % 2);
  }
  __device__ const T* acquire(int st) {
    if (sizeof(T) != 2) return src + (size_t)st * t.slot;
    mbar_wait(bar + st % 2, (st / 2) & 1);
    return ring + (size_t)(st % 2) * t.slot;
  }
};

template <typename T>
__global__ void __launch_bounds__(kRefThreads, 1) refine_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_r[];
  __shared__ uint64_t bars[2];
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.block_rank(), kc = (int)cl.num_blocks();
  const int D = p.D, R = p.R, J = 2 * p.L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  {  // this cluster's lane; a masked-off one zeroes its outputs and leaves,
     // every CTA of it before any barrier
    const int b = blockIdx.x / kc;
    to_lane<T>(p, b);
    if (p.lanes != nullptr && !p.lanes[b]) {
      if (c == 0)
        for (int i = tid; i < p.angle_size + 2; i += kRefThreads) {
          if (i < p.angle_size)
            p.out_head[i] = 0.f;
          else
            p.out_off[i - p.angle_size] = 0.f;
        }
      return;
    }
  }
  const TileLayout lay = tile_layout<T>(p.L, D, kc, p.angle_size);
  const int ld = lay.ld, ld4 = lay.ld4, c0 = kSlice * c;
  RefSmem<T> s;
  ref_carve<T>(reinterpret_cast<uintptr_t>(smem_r), D, kc, lay, s);
  Stages<T> w{static_cast<const T*>(p.tiles) + (size_t)c * lay.stages *
                                                    lay.slot,
              s.ring, bars, lay};
  if (sizeof(T) == 2 && tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    fence_barrier_init();
  }
  __syncthreads();
  w.issue(0);
  w.issue(1);
  for (int i = tid; i < kRows * D; i += kRefThreads)
    s.x[i] = i / D < R ? p.x_sub[i] : 0.f;
  cl.sync();  // every CTA of the cluster runs before any remote write

  auto V = [&](Arg a, int j, int per) { return p.v[a] + (size_t)j * per; };
  const float scale = 1.f / sqrtf((float)kSlice);  // exact: 1 / 4
  const T* pl_keys = static_cast<const T*>(p.pl_keys);
  // the products' operands, rounded: LN_q(x), LN_s(src), LN_r(rel); the
  // first sublayer's here, later ones' where their inputs are ready
  {
    float xv[kRows / 8][4];
#pragma unroll
    for (int i = 0; i < kRows / 8; ++i)
      load_lanes(xv[i], s.x + (size_t)(warp + 8 * i) * D, D);
    const LnParams ps = ln_params(V(LNS_S, 0, D), V(LNS_B, 0, D), D);
    x_rows_ln(xv, s.dn, (T*)nullptr, ld, D,
              ln_params(V(LNQ_S, 0, D), V(LNQ_B, 0, D), D), ps);
    input_rows_ln(cl, c, kc, pl_keys, static_cast<const T*>(p.r_pl), R,
                  s.sn, s.rn, ld, D, ps,
                  ln_params(V(LNR_S, 0, D), V(LNR_B, 0, D), D), 0);
  }
  cl.sync();
  for (int j = 0; j < J; ++j) {
    const bool map = j % 2 == 0, last = j == J - 1;
    const int nm = last ? 1 : 2;  // m16 tiles the epilogue needs
    const uint8_t* mask = map ? p.mask_pl : p.mask_a;
    // K = sn wk + rn wkr; V = ((sn wv + bv) + rn wvr) + bvr; G = dn
    // wg[D:]; S = dn ws + bs; q = dn[0] wq + bq: this head's columns
    {
      // the next sublayer's input-row LayerNorm parameters, for later
      const int jn = last ? j : j + 1;
      const LnParams ps_n = ln_params(V(LNS_S, jn, D), V(LNS_B, jn, D), D);
      const LnParams pr_n = ln_params(V(LNR_S, jn, D), V(LNR_B, jn, D), D);
      const T* wa = w.acquire(2 * j);
      auto blk = [&](int b) { return wa + (size_t)b * kSlice * ld; };
      const int m = (warp >> 1) & 1, nb = warp & 1, n0 = 8 * nb;
      const bool kw = warp < 4;
      float a1[4] = {0.f, 0.f, 0.f, 0.f}, a2[4] = {0.f, 0.f, 0.f, 0.f};
      const size_t po = (size_t)(j & 1) * kRows * ld;
      tile_dot(s.sn + po, ld, m, blk(kw ? A_WK : A_WV), ld, n0, 0, D, a1);
      tile_dot(s.rn + po, ld, m, blk(kw ? A_WKR : A_WVR), ld, n0, 0, D, a2);
      const float* bv = V(BV, j, D) + c0;
      const float* bvr = V(BVR, j, D) + c0;
      float* kvo = s.kv + (kw ? 0 : kRows * kSlice);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * m + acc_row(e), col = n0 + acc_col(e);
        kvo[row * kSlice + col] =
            kw ? a1[e] + a2[e] : ((a1[e] + bv[col]) + a2[e]) + bvr[col];
      }
      float a4[4] = {0.f, 0.f, 0.f, 0.f};
      if (m < nm) {
        float a3[4] = {0.f, 0.f, 0.f, 0.f};
        tile_dot(s.dn, ld, m, blk(kw ? A_WGD : A_WS), ld, n0, 0, D, a3);
        const float* bs = V(BS, j, D) + c0;
        float* go = s.gs + (kw ? 0 : kRows * kSlice);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * m + acc_row(e), col = n0 + acc_col(e);
          go[row * kSlice + col] = kw ? a3[e] : a3[e] + bs[col];
        }
      }
      if (!kw && m == 0) {  // row 0's query
        tile_dot(s.dn, ld, 0, blk(A_WQ), ld, n0, 0, D, a4);
        if (lane < 4) {
          const float* bq = V(BQ, j, D) + c0;
          s.q[n0 + acc_col(0)] = a4[0] + bq[n0 + acc_col(0)];
          s.q[n0 + acc_col(1)] = a4[1] + bq[n0 + acc_col(1)];
        }
      }
      __syncthreads();

      const float* bg = V(BG, j, D);
      if (warp == 0) {
        // row 0's attention over the R rows, this head
        const int r = lane;
        const bool on = r < R && mask[r];
        float sc = -INFINITY;
        if (on) {
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < kSlice; ++d)
            acc = fmaf(s.kv[r * kSlice + d], s.q[d], acc);
          sc = acc * scale;
        }
        const float mx = warp_max(sc);
        const float e = on ? expf(sc - mx) : 0.f;
        const float den = warp_sum(e);
        s.attn[r] = e / fmaxf(den, 1e-30f);
        __syncwarp();
        {  // lanes d and d + 16 sum rows [0, 16) and [16, 32)
          const int d = lane & (kSlice - 1), r0 = (lane >> 4) * 16;
          const float* vv = s.kv + kRows * kSlice + d;
          float acc = 0.f;
          for (int rr = r0; rr < r0 + 16; ++rr)
            acc = fmaf(s.attn[rr], vv[rr * kSlice], acc);
          acc += __shfl_xor_sync(0xffffffffu, acc, 16);
          if (lane < kSlice) s.a0s[lane] = acc;
        }
        __syncwarp();
        // this head's share of agg @ to_g[:D] for row 0, every column
        const T* wga = blk(A_WGA);
        float pa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < kSlice; ++k) {
          const float a = to_f(to_t<T>(s.a0s[k]));
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (lane + 32 * i < D)
              pa[i] = fmaf(a, to_f(wga[k * ld + lane + 32 * i]), pa[i]);
        }
        for (int rr = 0; rr < kc; ++rr)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (lane + 32 * i < D)
              cl.map_shared_rank(s.xp, rr)[c * D + lane + 32 * i] = pa[i];
        if (lane < kSlice)
          for (int rr = 0; rr < kc; ++rr)
            cl.map_shared_rank(s.a0, rr)[c0 + lane] = s.a0s[lane];
      } else {
        // rows 1..: agg == 0, so the update is g * s (not read after the
        // last sublayer); row 0's dst_n terms to every CTA
        const int i0 = tid - 32;
        if (!last)
          for (int i = i0; i < (kRows - 1) * kSlice / 2;
               i += kRefThreads - 32) {
            const int r = 1 + i / (kSlice / 2), n = 2 * (i % (kSlice / 2));
            const float* G = s.gs + r * kSlice + n;
            const float* S = s.gs + kRows * kSlice + r * kSlice + n;
            const float u0 = sigmoid(G[0] + bg[c0 + n]) * S[0];
            const float u1 = sigmoid(G[1] + bg[c0 + n + 1]) * S[1];
            for (int rr = 0; rr < kc; ++rr)
              store2(cl.map_shared_rank(s.ag, rr) + (size_t)r * ld + c0 + n,
                     u0, u1);
          }
        if (i0 < kSlice)
          for (int rr = 0; rr < kc; ++rr) {
            cl.map_shared_rank(s.g0, rr)[c0 + i0] = s.gs[i0];
            cl.map_shared_rank(s.s0, rr)[c0 + i0] =
                s.gs[kRows * kSlice + i0];
          }
        // the next sublayer's operands that do not depend on x, into
        // the other parity's buffers (read before the last barrier (1))
        if (!last) {
          const size_t po = (size_t)((j + 1) & 1) * kRows * ld;
          input_rows_ln(cl, c, kc, map ? nullptr : pl_keys,
                        static_cast<const T*>(map ? p.r_aa : p.r_pl), R,
                        s.sn + po, s.rn + po, ld, D, ps_n, pr_n, 1);
        }
      }
      cl.sync();  // (1)
      w.issue(2 * j + 2);
      // row 0: g = sigmoid((agg wg[:D] + dst_n wg[D:]) + bg), agg + g (s -
      // agg); the partials added in head order
      for (int n = tid; n < D; n += kRefThreads) {
        float ga = 0.f;
        for (int rr = 0; rr < kc; ++rr) ga += s.xp[rr * D + n];
        const float g = sigmoid((ga + s.g0[n]) + bg[n]);
        const float a = s.a0[n];
        s.ag[n] = to_t<T>(a + g * (s.s0[n] - a));
      }
      __syncthreads();
    }

    // the epilogue: x = x + postnorm(to_out(agg)); x = x +
    // ff_postnorm(ff_1(relu(ff_0(ff_prenorm(x)))))
    {
      const T* wb = w.acquire(2 * j + 1);
      if (warp < 2 * nm) {
        const int m = warp >> 1, n0 = 8 * (warp & 1);
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        tile_dot(s.ag, ld, m, wb, ld, n0, 0, D, a);
        const float* bo = V(BO, j, D) + c0;
        for (int e = 0; e < 4; e += 2) {
          const int row = 16 * m + acc_row(e), col = n0 + acc_col(e);
          for (int rr = 0; rr < kc; ++rr)
            store2(cl.map_shared_rank(s.ob, rr) + row * D + c0 + col,
                   a[e] + bo[col], a[e + 1] + bo[col + 1]);
        }
      }
      // the LayerNorm parameters of the next step, loaded while the
      // cluster barrier waits
      const LnParams pp = ln_params(V(POST_S, j, D), V(POST_B, j, D), D);
      const LnParams pf = ln_params(V(FFP_S, j, D), V(FFP_B, j, D), D);
      cl.sync();  // (2)
      {
        if (last)
          post_ffp_rows<T, 2>(s.x, s.ob, s.dn, ld, D, pp, pf);
        else
          post_ffp_rows<T, 4>(s.x, s.ob, s.dn, ld, D, pp, pf);
      }
      __syncthreads();
      {  // ff_0: this CTA's 64 columns, 8 per warp; relu, rounded
        const T* wf0 = wb + (size_t)kSlice * ld;
        const int n0 = 8 * warp;
        const float* bf0 = V(BF0, j, 4 * D) + 4 * c0;
        for (int m = 0; m < nm; ++m) {  // each tile's stores overlap the next
          float a[4] = {0.f, 0.f, 0.f, 0.f};
          tile_dot(s.dn, ld, m, wf0, ld, n0, 0, D, a);
          for (int e = 0; e < 4; e += 2) {
            const int row = 16 * m + acc_row(e), col = n0 + acc_col(e);
            const float h0 = fmaxf(a[e] + bf0[col], 0.f);
            const float h1 = fmaxf(a[e + 1] + bf0[col + 1], 0.f);
            for (int rr = 0; rr < kc; ++rr)
              store2(cl.map_shared_rank(s.hh, rr) + (size_t)row * ld4 +
                         4 * c0 + col,
                     h0, h1);
          }
        }
      }
      cl.sync();  // (3)
      {  // ff_1: this head's columns, K = 4D split over the warps
        const T* wf1 = wb + (size_t)5 * kSlice * ld;
        const int tiles = 2 * nm, splits = 8 / tiles, tile = warp % tiles;
        const int split = warp / tiles, m = tile >> 1, n0 = 8 * (tile & 1);
        const int kw = 4 * D / splits;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        tile_dot(s.hh, ld4, m, wf1, ld4, n0, split * kw, (split + 1) * kw,
                 a);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s.part[(split * kRows + 16 * m + acc_row(e)) * kSlice + n0 +
                 acc_col(e)] = a[e];
        __syncthreads();
        w.issue(2 * j + 3);
        const float* bf1 = V(BF1, j, D) + c0;
        for (int i = tid; i < 16 * nm * kSlice; i += kRefThreads) {
          float f = s.part[i];
          for (int sp = 1; sp < splits; ++sp)
            f += s.part[sp * kRows * kSlice + i];
          f += bf1[i % kSlice];
          for (int rr = 0; rr < kc; ++rr)
            cl.map_shared_rank(s.ob, rr)[(i / kSlice) * D + c0 + i % kSlice] =
                f;
        }
      }
      {  // x += ff_postnorm(f), and the next sublayer's LN_q(x) (and
         // LN_s(x) for an agent one); their parameters loaded while the
         // cluster barrier waits
        const LnParams pfq = ln_params(V(FFQ_S, j, D), V(FFQ_B, j, D), D);
        const int jn = last ? j : j + 1;
        const LnParams pq = ln_params(V(LNQ_S, jn, D), V(LNQ_B, jn, D), D);
        const LnParams ps = ln_params(V(LNS_S, jn, D), V(LNS_B, jn, D), D);
        cl.sync();  // (4)
        float* tr = p.trace != nullptr && c == 0 ? p.trace + (size_t)j * R * D
                                                 : nullptr;
        if (last)
          ffq_rows<2, T>(s.x, s.ob, tr, R, D, pfq, false, s.dn, nullptr, ld,
                         pq, ps);
        else
          ffq_rows<4, T>(s.x, s.ob, tr, R, D, pfq, true, s.dn,
                         map ? s.sn + (size_t)kRows * ld : nullptr, ld, pq,
                         ps);
      }
      __syncthreads();
    }
  }

  // heads on row 0: MLPLayer = dense -> LayerNorm -> relu -> dense
  const T* wh = w.acquire(lay.stages - 1);
  for (int i = tid; i < D; i += kRefThreads) s.hop[i] = to_t<T>(s.x[i]);
  __syncthreads();
  {  // both heads' Dense_0, this CTA's 16 columns each; k over 8 groups
    const int o = tid & 31, kg = tid >> 5, hi = o >> 4, n = o & 15;
    const int kw = D / 8;
    const T* row = wh + (size_t)(hi * kSlice + n) * ld;
    float acc = 0.f;
    for (int k = kg * kw; k < (kg + 1) * kw; ++k)
      acc = fmaf(to_f(s.hop[k]), to_f(row[k]), acc);
    s.part[kg * 32 + o] = acc;
    __syncthreads();
    if (tid < 32) {
      float h = 0.f;
      for (int g = 0; g < 8; ++g) h += s.part[g * 32 + o];
      h += V(BH0, hi, D)[c0 + n];
      for (int rr = 0; rr < kc; ++rr)
        cl.map_shared_rank(s.hb, rr)[hi * D + c0 + n] = h;
    }
  }
  cl.sync();
  if (warp < 2) {
    float v[1][4], m[1], rs[1];
    load_lanes(v[0], s.hb + warp * D, D);
    ln_stats(v, D, m, rs);
    const LnParams ph = ln_params(V(LNH_S, warp, D), V(LNH_B, warp, D), D);
    for (int k = 0; k < 4; ++k)
      if (lane + 32 * k < D)
        s.hop[warp * ld + lane + 32 * k] =
            to_t<T>(fmaxf(ln_apply(v[0][k], m[0], rs[0], ph, k), 0.f));
  }
  __syncthreads();
  // this CTA's heading-bin and offset columns, one warp per output
  const int nvh = max(0, min(p.angle_size - c * lay.ch, lay.ch));
  const int nvo = max(0, min(2 - c * lay.co, lay.co));
  for (int o = warp; o < nvh + nvo; o += 8) {
    const bool head = o < nvh;
    const int n = head ? o : o - nvh;
    const T* row = wh + (size_t)(head ? 2 * kSlice + n
                                      : 2 * kSlice + lay.nh + n) * ld;
    const T* in = s.hop + (head ? 0 : ld);
    float acc = 0.f;
    for (int k = lane; k < D; k += 32)
      acc = fmaf(to_f(in[k]), to_f(row[k]), acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      if (head)
        p.out_head[c * lay.ch + n] = acc + p.v[BH_HEAD][c * lay.ch + n];
      else
        p.out_off[c * lay.co + n] = acc + p.v[BH_OFF][c * lay.co + n];
    }
  }
}

template <typename T>
size_t smem_bytes(int L, int D, int kc, int angle) {
  RefSmem<T> s;
  return ref_carve<T>(0, D, kc, tile_layout<T>(L, D, kc, angle), s);
}

template <typename T>
int launch(const Params& p, int kc, int B, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>(p.L, p.D, kc, p.angle_size);
  static size_t allowed = 0;
  cudaError_t err = allow_smem(refine_kernel<T>, bytes, allowed);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kc;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kc * B);
  cfg.blockDim = dim3(kRefThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, refine_kernel<T>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a CTA needs (the wrapper checks them against the
// 227 KB a block can use).
extern "C" int infgen_refine_smem(int dtype, int L, int D, int angle_size) {
  const int kc = D / kSlice;
  return (int)(dtype == 1 ? smem_bytes<bf16>(L, D, kc, angle_size)
                          : smem_bytes<float>(L, D, kc, angle_size));
}

// dtype: 0 = float32, 1 = bfloat16 (pl_keys, r_pl, r_aa and the tiles).
// B lanes: x_sub, pl_keys, r_pl, r_aa [B, R, D], masks [B, R], out_head
// [B, angle_size], out_off [B, 2]; lanes [B] bytes or null (all on).
// ptrs: host array of kNumArgs device pointers (the packed vectors); tiles:
// refine_kernel.py::refine_tiles; trace: [B, 2L, R, D] fp32 (x after each
// sublayer; the last one's row 0 only is computed) or null. Takes heads of
// 16 (H = D / 16 CTAs, 2 <= H <= 8) and R <= 32. Returns a cudaError_t; 0
// on a successful launch.
extern "C" int infgen_refine(int dtype, const float* x_sub,
                             const void* pl_keys, const void* r_pl,
                             const uint8_t* mask_pl, const void* r_aa,
                             const uint8_t* mask_a, const uint64_t* ptrs,
                             const void* tiles, float* out_head,
                             float* out_off, float* trace,
                             const uint8_t* lanes, int B, int L, int R,
                             int D, int H, int Hd, int angle_size,
                             void* stream) {
  if (Hd != kSlice || H * Hd != D || H < 2 || H > kMaxCluster || R < 1 ||
      R > kRows || B < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x_sub = x_sub;
  p.pl_keys = pl_keys;
  p.r_pl = r_pl;
  p.mask_pl = mask_pl;
  p.r_aa = r_aa;
  p.mask_a = mask_a;
  p.tiles = tiles;
  for (int i = 0; i < kNumArgs; ++i)
    p.v[i] = reinterpret_cast<const float*>(ptrs[i]);
  p.out_head = out_head;
  p.out_off = out_off;
  p.trace = trace;
  p.lanes = lanes;
  p.L = L;
  p.R = R;
  p.D = D;
  p.angle_size = angle_size;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, H, B, s);
  if (dtype == 1) return launch<bf16>(p, H, B, s);
  return (int)cudaErrorInvalidValue;
}
