// The seed stack + heads of one query, spread over a thread-block cluster
// of kCluster CTAs. seed_eval.cu runs it on K/V in the compute type,
// seed_eval_full.cu on its precompute's fp32 K/V; both pass the weights
// that seed_kernel.py::pack_seed_params packs (common.cuh::seed_weights).
//
// The math is the plain seed_eval_reference's: L layers x {occ2sa, pt2sa,
// a2sa} with pre-LN, masked softmax with a zero-aggregate fallback, the
// gated update, post-LN and a 4D FFN, then the four heads; occ2sa takes
// v_occ[i] as its aggregate; every matmul rounds its input vector to T and
// sums in fp32. Only the summation order differs.
//
// Design. A one-row chain of about 60 dependent mat-vecs is latency bound
// on one SM: each product waits on its weights from L2. Here each of the
// kCluster CTAs
//   - owns a column slice of every mat-vec (D / kCluster columns, 4D /
//     kCluster of ff_0, about G / kCluster of the grid head) and a slice
//     of each attention's keys;
//   - prefetches its weight slices with cp.async into a two-stage ring of
//     shared memory in the chain's static order (stage = a sublayer's
//     attention-side matrices, its FFN matrices, or the heads), so the next
//     stage lands while this one multiplies;
//   - writes each mat-vec's slice into every CTA's copy of the vector
//     through distributed shared memory, then waits at a cluster barrier;
//     LayerNorms and the elementwise steps run on the whole vector in every
//     CTA, so only the products and attention are split;
//   - keeps, for its keys, the softmax partials (max, sum and partial
//     aggregate per head); after a cluster barrier every CTA combines the
//     kCluster partials itself.
// A buffer that other CTAs write is read only between the barrier that
// completes it and the next barrier, so no CTA can overwrite it early; the
// heads alternate two buffers for that reason.

#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCluster = 8;
constexpr int kStackThreads = 256;

// Elements of T in one ring stage: the largest stage is a sublayer's FFN
// slices, ff_0 [D, 4w] and ff_1 [4D, w] (w = D / kCluster).
__host__ __device__ inline int stack_stage_elems(int D) {
  return 8 * D * (D / kCluster);
}

// Keys per CTA of an attention over N keys.
__host__ __device__ inline int keys_per_cta(int N) {
  return (N + kCluster - 1) / kCluster;
}

// Floats of shared memory before the ring, and the total bytes.
__host__ __device__ inline int stack_floats(int D, int H, int P, int A) {
  const int npc = keys_per_cta(P > A ? P : A);
  const int n = 18 * D + 4 * kStackThreads + 32 + npc * H + 2 * H + D +
                4 * D / kCluster;
  return (n + 3) & ~3;
}
template <typename T>
inline size_t stack_bytes(int D, int H, int P, int A) {
  return (size_t)stack_floats(D, H, P, A) * sizeof(float) +
         (size_t)2 * stack_stage_elems(D) * sizeof(T);
}

template <typename T>
struct StackSmem {
  float *sd, *dst_n, *x, *agg, *t1, *t2;  // local [D]
  float *q, *gag, *o, *f;                  // written by every CTA [D]
  float *h;                                // written by every CTA [4D]
  float *xr;                               // [4D] rounded matmul input
  float *part, *red, *sc, *mp, *ys;
  T* ring;                                 // [2, stage]
};

template <typename T>
__device__ StackSmem<T> stack_carve(float* base, int D, int H, int P,
                                    int A) {
  const int npc = keys_per_cta(P > A ? P : A);
  StackSmem<T> s;
  float* p = base;
  s.sd = p;    p += D;
  s.dst_n = p; p += D;
  s.x = p;     p += D;
  s.agg = p;   p += D;
  s.t1 = p;    p += D;
  s.t2 = p;    p += D;
  s.q = p;     p += D;
  s.gag = p;   p += D;
  s.o = p;     p += D;
  s.f = p;     p += D;
  s.h = p;     p += 4 * D;
  s.xr = p;    p += 4 * D;
  s.part = p;  p += 4 * kStackThreads;  // partial sums
  s.red = p;   p += 32;
  s.sc = p;    p += npc * H;         // scores / weights of this CTA's keys
  s.mp = p;    p += 2 * H + D;       // partial: max[H], sum[H], agg[D]
  s.ys = p;                          // [4w] this CTA's mat-vec outputs
  s.ring = reinterpret_cast<T*>(base + stack_floats(D, H, P, A));
  return s;
}

// Copy rows k < K of the column slice [c0, c0 + wc) of W [K, N] into dst
// [K, wc] (cp.async, 16-byte pieces; wc * sizeof(T) a multiple of 16).
template <typename T>
__device__ void load_slice(const T* W, int K, int N, int c0, int wc, T* dst) {
  const int per = 16 / sizeof(T), cpr = wc / per;
  for (int i = threadIdx.x; i < K * cpr; i += blockDim.x) {
    const int k = i / cpr, ch = i % cpr;
    cp_async16(dst + (size_t)k * wc + ch * per,
               W + (size_t)k * N + c0 + ch * per);
  }
}

// Stage s of the chain (sublayer j = s / 2; the heads at s = 2J): issue its
// slices' copies into `dst` and commit them as one group.
template <typename T>
__device__ void load_stage(const SeedWeights<T>& w, int s, int J, int D,
                           int rank, T* dst) {
  const int wc = D / kCluster, c0 = rank * wc;
  const size_t DD = (size_t)D * D;
  if (s == 2 * J) {
    for (int hi = 0; hi < 4; ++hi)
      load_slice(w.wh0 + hi * DD, D, D, c0, wc, dst + (size_t)hi * D * wc);
  } else if (s % 2 == 0) {  // wq (if it attends), wg [2D], ws, wo
    const int j = s / 2, sub = j % 3;
    if (sub != 0)
      load_slice(w.wq + (size_t)(2 * (j / 3) + sub - 1) * DD, D, D, c0, wc,
                 dst);
    T* d = dst + (size_t)D * wc;
    load_slice(w.wg + (size_t)j * 2 * DD, 2 * D, D, c0, wc, d);
    d += (size_t)2 * D * wc;
    load_slice(w.ws + (size_t)j * DD, D, D, c0, wc, d);
    d += (size_t)D * wc;
    load_slice(w.wo + (size_t)j * DD, D, D, c0, wc, d);
  } else {                  // wf0 [D, 4w slice], wf1 [4D, w]
    const int j = s / 2;
    load_slice(w.wf0 + (size_t)j * 4 * DD, D, 4 * D, 4 * c0, 4 * wc, dst);
    load_slice(w.wf1 + (size_t)j * 4 * DD, 4 * D, D, c0, wc,
               dst + (size_t)4 * D * wc);
  }
  cp_commit();
}

// ys[c] = sum_k xr[k] W[k, c] + bias[c] for c < wc, W [K, wc] in shared
// memory; groups of threads split k and add their sums in a fixed order.
template <typename T>
__device__ void slice_mv(const float* xr, int K, const T* W, int wc,
                         const float* bias, float* ys, float* part) {
  const int tid = threadIdx.x, G = blockDim.x / wc;
  const int c = tid % wc, g = tid / wc, chunk = (K + G - 1) / G;
  if (g < G) {
    const int k0 = g * chunk, k1 = min(K, k0 + chunk);
    float acc = 0.f;
#pragma unroll 8
    for (int k = k0; k < k1; ++k)
      acc = fmaf(xr[k], to_f(W[(size_t)k * wc + c]), acc);
    part[g * wc + c] = acc;
  }
  __syncthreads();
  if (tid < wc) {
    float acc = 0.f;
    for (int gg = 0; gg < G; ++gg) acc += part[gg * wc + tid];
    ys[tid] = acc + bias[tid];
  }
  __syncthreads();
}

// dst[off + i] = ys[i] (i < n) in every CTA of the cluster, then a cluster
// barrier (which also orders this CTA's threads).
__device__ void gather(cg::cluster_group& cl, const float* ys, int n,
                       float* dst, int off) {
  for (int i = threadIdx.x; i < n * kCluster; i += blockDim.x) {
    float* remote = cl.map_shared_rank(dst, i / n);
    remote[off + i % n] = ys[i % n];
  }
  cl.sync();
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(p)[0];
  const __nv_bfloat162 b = reinterpret_cast<const __nv_bfloat162*>(p)[1];
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

template <typename T>
__device__ void round_into(const float* in, float* xr, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) xr[i] = round_to<T>(in[i]);
  __syncthreads();
}

// agg = masked-softmax attention of q over N keys (K, V [N, D] rows; masked
// keys take no part): this CTA scores its key slice, keeps the
// per-head max, sum and partial aggregate, and after a cluster barrier
// combines every CTA's partials. No valid key anywhere gives agg = 0.
template <typename KV>
__device__ void cluster_attend(cg::cluster_group& cl, int rank,
                               const float* q, const KV* K, const KV* V,
                               const uint8_t* mask, int N, int D, int H,
                               int Hd, float* sc, float* mp, float* part,
                               float* agg) {
  const int tid = threadIdx.x, bd = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = bd >> 5;
  const int npc = keys_per_cta(N), n0 = rank * npc;
  const int nk = max(0, min(N, n0 + npc) - n0);
  const float scale = rsqrtf((float)Hd);
  for (int i = tid; i < nk * H; i += bd) {
    const int n = n0 + i / H, h = i % H;
    float acc = -INFINITY;
    if (mask[n]) {
      const KV* kr = K + (size_t)n * D + h * Hd;
      const float* qh = q + h * Hd;
      acc = 0.f;
#pragma unroll 4
      for (int d = 0; d < Hd; d += 4) {
        const float4 k4 = load4(kr + d);
        acc = fmaf(k4.x, qh[d], acc);
        acc = fmaf(k4.y, qh[d + 1], acc);
        acc = fmaf(k4.z, qh[d + 2], acc);
        acc = fmaf(k4.w, qh[d + 3], acc);
      }
      acc *= scale;
    }
    sc[i] = acc;
  }
  __syncthreads();
  for (int h = warp; h < H; h += nw) {
    float mx = -INFINITY;
    for (int n = lane; n < nk; n += 32) mx = fmaxf(mx, sc[n * H + h]);
    mx = warp_max(mx);
    float s = 0.f;
    for (int n = lane; n < nk; n += 32) {
      const float e = mask[n0 + n] ? expf(sc[n * H + h] - mx) : 0.f;
      sc[n * H + h] = e;
      s += e;
    }
    s = warp_sum(s);
    if (lane == 0) {
      mp[h] = mx;
      mp[H + h] = s;
    }
  }
  __syncthreads();
  // partial aggregate: thread = (4 columns, key group), the slice's keys
  // split over the groups and read four rows ahead; a masked key's row
  // (never written) is read but selected away, its weight being 0
  const int d4n = D / 4, groups = max(bd / d4n, 1);
  const int chunk = (nk + groups - 1) / groups;
  for (int i = tid; i < groups * d4n; i += bd) {
    const int d = (i % d4n) * 4, g = i / d4n, h = d / Hd;
    const int a = g * chunk, b = min(nk, a + chunk);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int n = a; n < b; ++n) {
      const float4 v = load4(V + (size_t)(n0 + n) * D + d);
      const bool on = mask[n0 + n] != 0;
      const float w = sc[n * H + h];
      acc.x = fmaf(w, on ? v.x : 0.f, acc.x);
      acc.y = fmaf(w, on ? v.y : 0.f, acc.y);
      acc.z = fmaf(w, on ? v.z : 0.f, acc.z);
      acc.w = fmaf(w, on ? v.w : 0.f, acc.w);
    }
    float* pp = part + g * D + d;
    pp[0] = acc.x;
    pp[1] = acc.y;
    pp[2] = acc.z;
    pp[3] = acc.w;
  }
  __syncthreads();
  for (int d = tid; d < D; d += bd) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += part[g * D + d];
    mp[2 * H + d] = acc;
  }
  cl.sync();
  for (int d = tid; d < D; d += bd) {
    const int h = d / Hd;
    float m = -INFINITY;
    for (int r = 0; r < kCluster; ++r)
      m = fmaxf(m, cl.map_shared_rank(mp, r)[h]);
    float den = 0.f, acc = 0.f;
    if (m != -INFINITY) {
      for (int r = 0; r < kCluster; ++r) {
        const float* rp = cl.map_shared_rank(mp, r);
        const float e = expf(rp[h] - m);  // 0 for a CTA with no valid key
        den = fmaf(rp[H + h], e, den);
        acc = fmaf(rp[2 * H + d], e, acc);
      }
    }
    agg[d] = acc / fmaxf(den, 1e-30f);
  }
  __syncthreads();
}

// One evaluation of the seed stack and heads by this CTA of the cluster.
// v_occ [L, D], K/V [L, N, D] of type KV. `wait_inputs` runs after the
// first weight stage is in flight and before any input is read (the caller
// waits there for the kernel that wrote them).
template <typename T, typename KV, typename Wait>
__device__ void cluster_stack_and_heads(
    const SeedWeights<T>& w, const float* sd0, const KV* v_occ,
    const KV* k_pt, const KV* v_pt, const uint8_t* mask_pl, const KV* k_a,
    const KV* v_a, const uint8_t* mask_a, float* out_small, float* out_pos,
    int L, int P, int A, int D, int H, int Hd, int G, float* smem,
    Wait wait_inputs) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int J = 3 * L, tid = threadIdx.x, bd = blockDim.x;
  const int wc = D / kCluster, c0 = rank * wc, stage = stack_stage_elems(D);
  const StackSmem<T> s = stack_carve<T>(smem, D, H, P, A);
  int st = 0;  // the stage in use
  load_stage(w, 0, J, D, rank, s.ring);
  // the next stage into the other buffer, then wait for this one
  auto acquire = [&]() -> const T* {
    if (st + 1 <= 2 * J) {
      load_stage(w, st + 1, J, D, rank, s.ring + ((st + 1) & 1) * stage);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    return s.ring + (st & 1) * stage;
  };
  wait_inputs();
  for (int i = tid; i < D; i += bd) s.sd[i] = sd0[i];
  cl.sync();  // every CTA of the cluster runs before any remote write

  for (int j = 0; j < J; ++j) {
    const int li = j / 3, sub = j % 3;
    layer_norm(s.sd, s.dst_n, w.lnq_s + j * D, w.lnq_b + j * D, D, s.red);
    const T* wa = acquire();  // wq, wg, ws, wo slices
    if (sub == 0) {
      for (int i = tid; i < D; i += bd) s.agg[i] = to_f(v_occ[li * D + i]);
      __syncthreads();
    } else {
      const int k = 2 * li + sub - 1, N = sub == 1 ? P : A;
      round_into<T>(s.dst_n, s.xr, D);
      slice_mv(s.xr, D, wa, wc, w.bq + k * D + c0, s.ys, s.part);
      gather(cl, s.ys, wc, s.q, c0);
      cluster_attend<KV>(cl, rank, s.q,
                         (sub == 1 ? k_pt : k_a) + (size_t)li * N * D,
                         (sub == 1 ? v_pt : v_a) + (size_t)li * N * D,
                         sub == 1 ? mask_pl : mask_a, N, D, H, Hd, s.sc,
                         s.mp, s.part, s.agg);
    }
    // gate: sigmoid(to_g([agg, dst_n])); update toward to_s(dst_n)
    round_into<T>(s.agg, s.xr, D);
    round_into<T>(s.dst_n, s.xr + D, D);
    const T* wg = wa + (size_t)D * wc;
    slice_mv(s.xr, 2 * D, wg, wc, w.bg + j * D + c0, s.ys, s.part);
    for (int i = tid; i < wc; i += bd) s.t1[i] = s.ys[i];
    __syncthreads();
    slice_mv(s.xr + D, D, wg + (size_t)2 * D * wc, wc, w.bs + j * D + c0,
             s.ys, s.part);
    for (int i = tid; i < wc; i += bd) {
      const float a = s.agg[c0 + i];
      s.ys[i] = a + sigmoid(s.t1[i]) * (s.ys[i] - a);
    }
    __syncthreads();
    gather(cl, s.ys, wc, s.gag, c0);
    // x = sd + postnorm(to_out(agg))
    round_into<T>(s.gag, s.xr, D);
    slice_mv(s.xr, D, wg + (size_t)3 * D * wc, wc, w.bo + j * D + c0, s.ys,
             s.part);
    gather(cl, s.ys, wc, s.o, c0);
    layer_norm(s.o, s.t2, w.post_s + j * D, w.post_b + j * D, D, s.red);
    for (int i = tid; i < D; i += bd) s.x[i] = s.sd[i] + s.t2[i];
    __syncthreads();
    ++st;
    // sd = x + ff_postnorm(ff_1(relu(ff_0(ff_prenorm(x)))))
    layer_norm(s.x, s.t1, w.ffp_s + j * D, w.ffp_b + j * D, D, s.red);
    const T* wf = acquire();
    round_into<T>(s.t1, s.xr, D);
    slice_mv(s.xr, D, wf, 4 * wc, w.bf0 + j * 4 * D + 4 * c0, s.ys, s.part);
    for (int i = tid; i < 4 * wc; i += bd) s.ys[i] = fmaxf(s.ys[i], 0.f);
    __syncthreads();
    gather(cl, s.ys, 4 * wc, s.h, 4 * c0);
    round_into<T>(s.h, s.xr, 4 * D);
    slice_mv(s.xr, 4 * D, wf + (size_t)4 * D * wc, wc, w.bf1 + j * D + c0,
             s.ys, s.part);
    gather(cl, s.ys, wc, s.f, c0);
    layer_norm(s.f, s.t2, w.ffq_s + j * D, w.ffq_b + j * D, D, s.red);
    for (int i = tid; i < D; i += bd) s.sd[i] = s.x[i] + s.t2[i];
    __syncthreads();
    ++st;
  }

  // heads: MLPLayer = dense -> LayerNorm -> relu -> dense
  const T* wh = acquire();
  const int gs = (G + kCluster - 1) / kCluster;
  for (int hi = 0; hi < 4; ++hi) {
    float* buf = hi % 2 ? s.gag : s.o;  // alternate: see the header
    round_into<T>(s.sd, s.xr, D);
    slice_mv(s.xr, D, wh + (size_t)hi * D * wc, wc, w.bh0 + hi * D + c0,
             s.ys, s.part);
    gather(cl, s.ys, wc, buf, c0);
    layer_norm(buf, s.t2, w.lnh_s + hi * D, w.lnh_b + hi * D, D, s.red);
    for (int i = tid; i < D; i += bd) s.xr[i] = round_to<T>(fmaxf(s.t2[i], 0.f));
    __syncthreads();
    if (hi < 3) {
      if (rank == 0)
        matvec<T>(s.xr, D, w.wsm + (size_t)hi * D * kSmallCols, kSmallCols,
                  w.bsm + hi * kSmallCols, out_small + hi * kSmallCols,
                  s.part);
    } else {
      for (int c = rank * gs + tid; c < min(G, (rank + 1) * gs); c += bd) {
        float acc = 0.f;
#pragma unroll 16
        for (int k = 0; k < D; ++k)
          acc = fmaf(s.xr[k], to_f(w.wpos[(size_t)k * G + c]), acc);
        out_pos[c] = acc + w.bpos[c];
      }
    }
  }
}

}  // namespace
