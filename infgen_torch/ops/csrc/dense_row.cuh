// One DenseAttention sublayer for one query row, in one block: the device
// code that motion_column.cu and fused_block.cu share.
//
//   Arg, Sub        the packed parameters of a stack of sublayers
//                   (column_kernel.py::_layouts) and one sublayer of it
//   Smem, carve     the row's working set in shared memory
//   row_query       dnr = LN_dst(x), q = dnr wq + bq
//   row_kv          this row as a key: k = LN_src(x) wk, v = LN_src(x) wv + bv
//   row_attend      masked softmax attention of q over the valid keys, with
//                   relation-biased keys and values
//   row_epilogue    the gated update, out-projection, post-LN residual, FFN
//
// Matrices are of type T and every matmul operand is rounded to T with fp32
// sums (T = float: no rounding); inputs (keys, relations) are of type In;
// LayerNorm is two-pass fp32 with eps 1e-6; softmax is fp32.

#pragma once

#include "common.cuh"

namespace {

// The packed arrays, in the order of the pointer array that
// column_kernel.py::_layouts lays out (matrices [J, in, out], vectors
// [J, n]).
enum Arg {
  WQ, WK, WV, WKR, WVR, WGA, WGD, WS, WO, WF0, WF1,
  LND_S, LND_B, LNS_S, LNS_B, LNR_S, LNR_B, BQ, BV, BVR, BG, BS, BO, POST_S,
  POST_B, FFP_S, FFP_B, BF0, BF1, FFQ_S, FFQ_B,
  kNumArgs
};

constexpr int kTile = 16;  // keys projected per pass

// Sublayer j of a packed stack, and the widths (H heads of Hd, H Hd == D).
struct Sub {
  const void* const* w;
  int j, D, H, Hd;
};

template <typename T>
__device__ __forceinline__ const T* mat(const Sub& u, Arg a, size_t per) {
  return static_cast<const T*>(u.w[a]) + (size_t)u.j * per;
}

__device__ __forceinline__ const float* vec(const Sub& u, Arg a, int per) {
  return static_cast<const float*>(u.w[a]) + (size_t)u.j * per;
}

struct Smem {
  float *x, *dnr, *q, *agg, *t1, *t2, *t3, *h, *xr, *part, *red, *den, *sc,
      *vall, *sn, *rn, *kt;
  int *idx, *scan;
};

// Floats of shared memory for rows of up to nmax keys.
inline size_t smem_floats(int D, int H, int nmax) {
  return (size_t)15 * D + kThreads + 32 + H + nmax + kThreads / 32 + 1 +
         (size_t)nmax * H + (size_t)nmax * D + (size_t)3 * kTile * D;
}

__device__ Smem carve(float* base, int D, int H, int nmax) {
  Smem s;
  s.x = base;              // [D] running feature of this row
  s.dnr = s.x + D;         // [D] LN(x) on the query side, rounded
  s.q = s.dnr + D;         // [D]
  s.agg = s.q + D;         // [D]
  s.t1 = s.agg + D;        // [D]
  s.t2 = s.t1 + D;         // [D]
  s.t3 = s.t2 + D;         // [D]
  s.h = s.t3 + D;          // [4D]
  s.xr = s.h + 4 * D;      // [4D] rounded matmul input
  s.part = s.xr + 4 * D;   // [blockDim]
  s.red = s.part + kThreads;  // [32]
  s.den = s.red + 32;      // [H]
  s.idx = reinterpret_cast<int*>(s.den + H);  // [nmax]
  s.scan = s.idx + nmax;   // [blockDim / 32 + 1]
  s.sc = reinterpret_cast<float*>(s.scan + kThreads / 32 + 1);  // [nmax, H]
  s.vall = s.sc + (size_t)nmax * H;   // [nmax, D] values of valid keys
  s.sn = s.vall + (size_t)nmax * D;   // [kTile, D]
  s.rn = s.sn + kTile * D;            // [kTile, D]
  s.kt = s.rn + kTile * D;            // [kTile, D]
  return s;
}

// agg = masked-softmax attention of q over the N keys of sublayer u: key
// row k is LN(keys[k]) projected by to_k / to_v (or, with keys null, the
// shared ksh[k] / vsh[k]), plus the relation terms LN(rel[k]) w_kr and
// LN(rel[k]) w_vr + b_vr. Only keys with mask[k] are read; no valid key
// gives agg = 0.
template <typename T, typename In>
__device__ void row_attend(const Sub& u, const In* keys, const In* rel,
                           const uint8_t* mask, int N, const float* ksh,
                           const float* vsh, const Smem& s) {
  const int D = u.D, H = u.H, Hd = u.Hd, tid = threadIdx.x, bd = blockDim.x;
  const size_t DD = (size_t)D * D;
  const float scale = 1.f / sqrtf((float)Hd);
  const int n = compact(mask, N, s.idx, s.scan);
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int m = min(kTile, n - t0);
    float* vt = s.vall + (size_t)t0 * D;
    for (int i = tid; i < m * D; i += bd) {
      const size_t o = (size_t)s.idx[t0 + i / D] * D + i % D;
      s.rn[i] = to_f(rel[o]);
      if (keys) s.sn[i] = to_f(keys[o]);
    }
    __syncthreads();
    rows_ln<T, true>(s.rn, D, s.rn, D, m, D, vec(u, LNR_S, D),
                     vec(u, LNR_B, D));
    rows_mm<T>(s.rn, D, m, D, mat<T>(u, WKR, DD), D, nullptr, s.kt, D, false);
    rows_mm<T>(s.rn, D, m, D, mat<T>(u, WVR, DD), D, vec(u, BVR, D), vt, D,
               false);
    if (keys) {
      // k = LN(key) wk + kr; v = (LN(key) wv + bv) + vr
      rows_ln<T, true>(s.sn, D, s.sn, D, m, D, vec(u, LNS_S, D),
                       vec(u, LNS_B, D));
      rows_mm<T>(s.sn, D, m, D, mat<T>(u, WK, DD), D, nullptr, s.kt, D, true);
      rows_mm<T>(s.sn, D, m, D, mat<T>(u, WV, DD), D, vec(u, BV, D), vt, D,
                 true);
    } else {
      for (int i = tid; i < m * D; i += bd) {
        const size_t o = (size_t)s.idx[t0 + i / D] * D + i % D;
        s.kt[i] += ksh[o];
        vt[i] += vsh[o];
      }
      __syncthreads();
    }
    for (int i = tid; i < m * H; i += bd) {
      const int r = i / H, h = i % H;
      float acc = 0.f;
      for (int d = 0; d < Hd; ++d)
        acc = fmaf(s.kt[r * D + h * Hd + d], s.q[h * Hd + d], acc);
      s.sc[(t0 + r) * H + h] = acc * scale;
    }
    __syncthreads();
  }
  // two-pass softmax per head; agg = sum_k p_k v_k / max(sum_k p_k, 1e-30)
  const int warp = tid >> 5, lane = tid & 31, nw = bd >> 5;
  for (int h = warp; h < H; h += nw) {
    float mx = -INFINITY;
    for (int k = lane; k < n; k += 32) mx = fmaxf(mx, s.sc[k * H + h]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int k = lane; k < n; k += 32) {
      const float e = expf(s.sc[k * H + h] - mx);
      s.sc[k * H + h] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) s.den[h] = sum;
  }
  __syncthreads();
  for (int d = tid; d < D; d += bd) {
    const int h = d / Hd;
    float acc = 0.f;
    for (int k = 0; k < n; ++k)
      acc = fmaf(s.sc[k * H + h], s.vall[(size_t)k * D + d], acc);
    s.agg[d] = acc / fmaxf(s.den[h], 1e-30f);
  }
  __syncthreads();
}

// The query side of sublayer u for this block's row: dnr = LN(x) rounded,
// q = dnr wq + bq.
template <typename T>
__device__ void row_query(const Sub& u, const Smem& s) {
  const int D = u.D;
  layer_norm(s.x, s.t1, vec(u, LND_S, D), vec(u, LND_B, D), D, s.red);
  round_vec<T>(s.t1, s.dnr, D);
  matvec<T>(s.dnr, D, mat<T>(u, WQ, (size_t)D * D), D, vec(u, BQ, D), s.q,
            s.part);
}

// This block's row as a key of sublayer u: t2 = k = LN_src(x) wk,
// t3 = v = LN_src(x) wv + bv.
template <typename T>
__device__ void row_kv(const Sub& u, const Smem& s) {
  const int D = u.D;
  const size_t DD = (size_t)D * D;
  layer_norm(s.x, s.t1, vec(u, LNS_S, D), vec(u, LNS_B, D), D, s.red);
  round_vec<T>(s.t1, s.xr, D);
  matvec<T>(s.xr, D, mat<T>(u, WK, DD), D, nullptr, s.t2, s.part);
  matvec<T>(s.xr, D, mat<T>(u, WV, DD), D, vec(u, BV, D), s.t3, s.part);
}

// The gated update and FFN of sublayer u for this block's row:
// g = sigmoid((agg wga + dnr wgd) + bg); agg += g (dnr ws + bs - agg);
// x += postnorm(agg wo + bo);
// x += ff_postnorm(ff_1(relu(ff_0(ff_prenorm(x))))).
template <typename T>
__device__ void row_epilogue(const Sub& u, const Smem& s) {
  const int D = u.D, tid = threadIdx.x, bd = blockDim.x;
  const size_t DD = (size_t)D * D;
  round_vec<T>(s.agg, s.xr, D);
  matvec<T>(s.xr, D, mat<T>(u, WGA, DD), D, nullptr, s.t1, s.part);
  matvec<T>(s.dnr, D, mat<T>(u, WGD, DD), D, nullptr, s.t2, s.part);
  matvec<T>(s.dnr, D, mat<T>(u, WS, DD), D, vec(u, BS, D), s.t3, s.part);
  const float* bg = vec(u, BG, D);
  for (int i = tid; i < D; i += bd) {
    const float g = sigmoid((s.t1[i] + s.t2[i]) + bg[i]);
    s.agg[i] = s.agg[i] + g * (s.t3[i] - s.agg[i]);
  }
  __syncthreads();
  round_vec<T>(s.agg, s.xr, D);
  matvec<T>(s.xr, D, mat<T>(u, WO, DD), D, vec(u, BO, D), s.t1, s.part);
  layer_norm(s.t1, s.t2, vec(u, POST_S, D), vec(u, POST_B, D), D, s.red);
  for (int i = tid; i < D; i += bd) s.x[i] += s.t2[i];
  __syncthreads();
  layer_norm(s.x, s.t1, vec(u, FFP_S, D), vec(u, FFP_B, D), D, s.red);
  round_vec<T>(s.t1, s.xr, D);
  matvec<T>(s.xr, D, mat<T>(u, WF0, 4 * DD), 4 * D, vec(u, BF0, 4 * D), s.h,
            s.part);
  for (int i = tid; i < 4 * D; i += bd)
    s.xr[i] = round_to<T>(fmaxf(s.h[i], 0.f));
  __syncthreads();
  matvec<T>(s.xr, 4 * D, mat<T>(u, WF1, 4 * DD), D, vec(u, BF1, D), s.t1,
            s.part);
  layer_norm(s.t1, s.t2, vec(u, FFQ_S, D), vec(u, FFQ_B, D), D, s.red);
  for (int i = tid; i < D; i += bd) s.x[i] += s.t2[i];
  __syncthreads();
}

__device__ void zero(float* v, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = 0.f;
  __syncthreads();
}

}  // namespace
