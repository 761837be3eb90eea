// Device code shared by the port's kernels (seed_eval.cu, seed_eval_full.cu,
// refine.cu, motion_column.cu, fused_block.cu): compute-dtype conversion,
// block and warp reductions, LayerNorm and matrix products over vectors and
// row tiles in shared memory, order-keeping compaction of masks, one-query
// masked attention, the seed stack + heads, cp.async copies and bulk
// (TMA) copies with their mbarriers.
//
// The arithmetic contract of every kernel, which is the TPU kernels' own:
// matmul operands are rounded to the compute dtype T (float or bf16) and
// multiplied by T weights with fp32 sums; LayerNorm statistics are fp32
// (two-pass, eps 1e-6); softmax is masked and fp32, and a fully masked key
// set aggregates to exactly zero; the gated update is agg + g * (s - agg).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSmallCols = 4;  // seed state 2 / type 3 / shape 3, padded
constexpr float kLnEps = 1e-6f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte asynchronous copy global -> shared (cp.async, L2 only), and the
// group commit / wait that order such copies.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bulk asynchronous copies (the TMA unit, no tensor map): one thread moves
// a contiguous run of bytes global -> shared and reports it to an mbarrier
// in shared memory; the threads that read it wait on the barrier's phase.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
// After initialising barriers, before any thread or copy uses them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Orders this thread's earlier shared-memory accesses before later bulk
// copies into the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// bytes: a multiple of 16; both addresses 16-byte aligned.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory, calling the runtime
// only when `done` (the largest size set so far for it) is smaller.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& done) {
  if (bytes <= done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done = bytes;
  return e;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
  return warp_sum(v);
}

// out = LayerNorm(in) * s + b over n values (two-pass fp32 statistics);
// in and out must not alias.
__device__ void layer_norm(const float* in, float* out, const float* s,
                           const float* b, int n, float* red) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += in[i];
  const float mean = block_sum(acc, red) / n;
  acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = in[i] - mean;
    acc += d * d;
  }
  const float r = rsqrtf(block_sum(acc, red) / n + kLnEps);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[i] = (in[i] - mean) * r * s[i] + b[i];
  __syncthreads();
}

// xr[i] = in[i] rounded to the compute dtype (the matmul operand).
template <typename T>
__device__ void round_vec(const float* in, float* xr, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) xr[i] = round_to<T>(in[i]);
  __syncthreads();
}

// y[c] = sum_k xr[k] * W[k, c] + bias[c] for c < n_out (bias may be null);
// W is [n_in, n_out]. With fewer columns than threads, groups of threads
// split k and `part` (blockDim floats) holds their partial sums, added in a
// fixed order.
template <typename T>
__device__ void matvec(const float* xr, int n_in, const T* W, int n_out,
                       const float* bias, float* y, float* part) {
  const int bd = blockDim.x, tid = threadIdx.x;
  if (n_out >= bd) {
    for (int c = tid; c < n_out; c += bd) {
      float acc = 0.f;
      for (int k = 0; k < n_in; ++k)
        acc = fmaf(xr[k], to_f(W[(size_t)k * n_out + c]), acc);
      y[c] = acc + (bias ? bias[c] : 0.f);
    }
    __syncthreads();
    return;
  }
  const int groups = bd / n_out;
  const int c = tid % n_out, g = tid / n_out;
  if (g < groups) {
    const int chunk = (n_in + groups - 1) / groups;
    const int k0 = g * chunk, k1 = min(n_in, k0 + chunk);
    float acc = 0.f;
    for (int k = k0; k < k1; ++k)
      acc = fmaf(xr[k], to_f(W[(size_t)k * n_out + c]), acc);
    part[g * n_out + c] = acc;
  }
  __syncthreads();
  if (tid < n_out) {
    float acc = 0.f;
    for (int gg = 0; gg < groups; ++gg) acc += part[gg * n_out + tid];
    y[tid] = acc + (bias ? bias[tid] : 0.f);
  }
  __syncthreads();
}

// Row tiles: R rows of n values each, row-major in shared memory with a
// leading dimension.

// out[r] = LayerNorm(in[r]) * s + b for r < R, one warp per row, two-pass
// fp32 statistics; with kRound the result is stored rounded to T (a matmul
// operand and nothing else). in and out may alias.
template <typename T, bool kRound>
__device__ void rows_ln(const float* in, int ldi, float* out, int ldo, int R,
                        int n, const float* s, const float* b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int r = warp; r < R; r += nw) {
    const float* x = in + (size_t)r * ldi;
    float acc = 0.f;
    for (int i = lane; i < n; i += 32) acc += x[i];
    const float mean = warp_sum(acc) / n;
    acc = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float d = x[i] - mean;
      acc += d * d;
    }
    const float rs = rsqrtf(warp_sum(acc) / n + kLnEps);
    float* y = out + (size_t)r * ldo;
    for (int i = lane; i < n; i += 32) {
      const float v = (x[i] - mean) * rs * s[i] + b[i];
      y[i] = kRound ? round_to<T>(v) : v;
    }
  }
  __syncthreads();
}

// y[r, c] = sum_k x[r, k] * W[k, c] + bias[c] (bias may be null) for r < R,
// c < n_out; with `accumulate`, y[r, c] += that instead. x holds the matmul
// operands, already rounded to T. W [n_in, n_out] is in global memory.
// Threads take (column, row group) pairs, so consecutive threads read
// consecutive weights of a row; each thread sums its rows' dot products in
// a fixed k order, eight rows per pass over W. The k loop is unrolled so
// that several weight loads are in flight: the products wait on L2, not on
// arithmetic. (Unrolling matvec's k loops the same way made the one-row
// seed stack slower on an H100, 0.40 -> 0.59 ms: PERF.md.)
template <typename T>
__device__ void rows_mm(const float* x, int ldx, int R, int n_in, const T* W,
                        int n_out, const float* bias, float* y, int ldy,
                        bool accumulate) {
  const int bd = blockDim.x;
  const int groups = max(1, min(R, bd / n_out));
  for (int i = threadIdx.x; i < groups * n_out; i += bd) {
    const int c = i % n_out, g = i / n_out;
    for (int r0 = g; r0 < R; r0 += 8 * groups) {
      float acc[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u] = 0.f;
#pragma unroll 4
      for (int k = 0; k < n_in; ++k) {
        const float w = to_f(W[(size_t)k * n_out + c]);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int r = r0 + u * groups;
          if (r < R) acc[u] = fmaf(x[(size_t)r * ldx + k], w, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = r0 + u * groups;
        if (r < R) {
          const float v = acc[u] + (bias ? bias[c] : 0.f);
          float* dst = y + (size_t)r * ldy + c;
          *dst = accumulate ? *dst + v : v;
        }
      }
    }
  }
  __syncthreads();
}

// idx[0..count) = the indices i < n with flags[i] != 0, in ascending order;
// returns count to every thread. `scan` holds blockDim / 32 + 1 ints.
__device__ int compact(const uint8_t* flags, int n, int* idx, int* scan) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  int base = 0;
  for (int c0 = 0; c0 < n; c0 += blockDim.x) {
    const int i = c0 + threadIdx.x;
    const bool on = i < n && flags[i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    __syncthreads();  // scan may still be read by the previous chunk
    if (lane == 0) scan[warp] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {
      int run = 0;
      for (int w = 0; w < nw; ++w) {
        const int c = scan[w];
        scan[w] = run;
        run += c;
      }
      scan[nw] = run;
    }
    __syncthreads();
    if (on)
      idx[base + scan[warp] + __popc(ballot & ((1u << lane) - 1u))] = i;
    base += scan[nw];
  }
  __syncthreads();
  return base;
}

// agg = masked-softmax attention of query q over N keys (K, V [N, D] KV).
// A masked key's K and V rows are never read: its weight is exactly 0 in
// the plain version too (exp(...) * 0), and the max over a head with any
// valid key is a valid key's score (a masked score sits 1e9 below), so the
// result is the same as scoring every key.
template <typename KV>
__device__ void attend(const float* q, const KV* K, const KV* V,
                       const uint8_t* mask, int N, int D, int H, int Hd,
                       float* sc, float* ssum, float* agg, float* part) {
  const int bd = blockDim.x, tid = threadIdx.x;
  const float scale = rsqrtf((float)Hd);
  for (int i = tid; i < N * H; i += bd) {
    const int n = i / H, h = i % H;
    if (!mask[n]) {
      sc[i] = -INFINITY;
      continue;
    }
    const KV* kr = K + (size_t)n * D + h * Hd;
    const float* qh = q + h * Hd;
    float acc = 0.f;
    for (int d = 0; d < Hd; ++d) acc = fmaf(to_f(kr[d]), qh[d], acc);
    sc[i] = acc * scale;
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, nwarps = bd >> 5;
  for (int h = warp; h < H; h += nwarps) {
    float mx = -INFINITY;
    for (int n = lane; n < N; n += 32) mx = fmaxf(mx, sc[n * H + h]);
    mx = warp_max(mx);
    float s = 0.f;
    for (int n = lane; n < N; n += 32) {
      const float e = mask[n] ? expf(sc[n * H + h] - mx) : 0.f;
      sc[n * H + h] = e;
      s += e;
    }
    s = warp_sum(s);
    if (lane == 0) ssum[h] = fmaxf(s, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < N * H; i += bd) sc[i] = sc[i] / ssum[i % H];
  __syncthreads();
  // agg[d] = sum_n attn[n, d / Hd] * V[n, d], keys split over thread groups
  const int groups = max(bd / D, 1);
  const int chunk = (N + groups - 1) / groups;
  for (int i = tid; i < groups * D; i += bd) {
    const int d = i % D, g = i / D;
    const int n0 = g * chunk, n1 = min(N, n0 + chunk);
    const int h = d / Hd;
    float acc = 0.f;
    for (int n = n0; n < n1; ++n)
      if (mask[n]) acc = fmaf(sc[n * H + h], to_f(V[(size_t)n * D + d]), acc);
    part[g * D + d] = acc;
  }
  __syncthreads();
  for (int d = tid; d < D; d += bd) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += part[g * D + d];
    agg[d] = acc;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The seed stack + heads (infgen_torch/ops/seed_kernel.py::pack_seed_params
// packs its parameters; seed_eval.cu and seed_eval_full.cu run it).

template <typename T>
struct SeedWeights {
  const T *wq, *wg, *ws, *wo, *wf0, *wf1, *wh0, *wsm, *wpos;
  const float *lnq_s, *lnq_b, *bq, *bg, *bs, *bo, *post_s, *post_b, *ffp_s,
      *ffp_b, *bf0, *bf1, *ffq_s, *ffq_b, *bh0, *lnh_s, *lnh_b, *bsm, *bpos;
};

// The packed buffers, in this order (seed_kernel.py::_layouts):
// matrices wq [2L,D,D] (pt2sa and a2sa only, k = 2i + s - 1) wg [J,2D,D]
// ws [J,D,D] wo [J,D,D] wf0 [J,D,4D] wf1 [J,4D,D] wh0 [4,D,D] wsm [3,D,4]
// wpos [D,G]; vectors lnq_s lnq_b [J,D]; bq [2L,D]; bg bs bo post_s post_b
// ffp_s ffp_b [J,D]; bf0 [J,4D]; bf1 ffq_s ffq_b [J,D]; bh0 lnh_s lnh_b
// [4,D]; bsm [3,4]; bpos [G].
template <typename T>
__device__ SeedWeights<T> seed_weights(const void* weights,
                                       const float* vectors, int L, int D) {
  const int J = 3 * L;
  SeedWeights<T> w;
  w.wq = static_cast<const T*>(weights);
  w.wg = w.wq + (size_t)2 * L * D * D;
  w.ws = w.wg + (size_t)J * 2 * D * D;
  w.wo = w.ws + (size_t)J * D * D;
  w.wf0 = w.wo + (size_t)J * D * D;
  w.wf1 = w.wf0 + (size_t)J * D * 4 * D;
  w.wh0 = w.wf1 + (size_t)J * 4 * D * D;
  w.wsm = w.wh0 + (size_t)4 * D * D;
  w.wpos = w.wsm + (size_t)3 * D * kSmallCols;
  w.lnq_s = vectors;
  w.lnq_b = w.lnq_s + J * D;
  w.bq = w.lnq_b + J * D;
  w.bg = w.bq + 2 * L * D;
  w.bs = w.bg + J * D;
  w.bo = w.bs + J * D;
  w.post_s = w.bo + J * D;
  w.post_b = w.post_s + J * D;
  w.ffp_s = w.post_b + J * D;
  w.ffp_b = w.ffp_s + J * D;
  w.bf0 = w.ffp_b + J * D;
  w.bf1 = w.bf0 + J * 4 * D;
  w.ffq_s = w.bf1 + J * D;
  w.ffq_b = w.ffq_s + J * D;
  w.bh0 = w.ffq_b + J * D;
  w.lnh_s = w.bh0 + 4 * D;
  w.lnh_b = w.lnh_s + 4 * D;
  w.bsm = w.lnh_b + 4 * D;
  w.bpos = w.bsm + 3 * kSmallCols;
  return w;
}

// Floats of shared memory the stack needs.
inline size_t seed_stack_floats(int D, int H, int P, int A) {
  const int nkeys = P > A ? P : A;
  return (size_t)16 * D + kThreads + 32 + H + (size_t)nkeys * H;
}

// One evaluation of the seed stack (L layers x {occ2sa, pt2sa, a2sa}: pre-
// LN, masked softmax with a zero-aggregate fallback, gated update, post-LN,
// a 4D FFN) and the four heads, in one block. occ2sa takes v_occ[i] as its
// aggregate; to_g is applied to [agg, dst_n]; the query LayerNorm is
// prenorm_dst for occ2sa and pt2sa, prenorm_src for a2sa (packed per
// sublayer). K/V and v_occ are of type KV: the compute dtype when they were
// precomputed outside, fp32 when the full kernel computed them.
template <typename T, typename KV>
__device__ void seed_stack_and_heads(
    const SeedWeights<T>& w, const float* sd0, const KV* v_occ,
    const KV* k_pt, const KV* v_pt, const uint8_t* mask_pl, const KV* k_a,
    const KV* v_a, const uint8_t* mask_a, float* out_small, float* out_pos,
    int L, int P, int A, int D, int H, int Hd, int G, float* smem) {
  const int J = 3 * L, tid = threadIdx.x, bd = blockDim.x;
  float* sd = smem;            // [D] running seed feature
  float* dst_n = sd + D;       // [D]
  float* q = dst_n + D;        // [D]
  float* agg = q + D;          // [D]
  float* x = agg + D;          // [D]
  float* t1 = x + D;           // [D]
  float* t2 = t1 + D;          // [D]
  float* h = t2 + D;           // [4D]
  float* xr = h + 4 * D;       // [4D] rounded matmul input
  float* part = xr + 4 * D;    // [blockDim] partial sums
  float* red = part + bd;      // [32]
  float* ssum = red + 32;      // [H]
  float* sc = ssum + H;        // [max(P, A) * H] scores / weights

  for (int i = tid; i < D; i += bd) sd[i] = sd0[i];
  __syncthreads();

  for (int j = 0; j < J; ++j) {
    const int li = j / 3, s = j % 3;
    layer_norm(sd, dst_n, w.lnq_s + j * D, w.lnq_b + j * D, D, red);
    if (s == 0) {  // occ2sa: one always-valid key, agg = its value
      const KV* vo = v_occ + (size_t)li * D;
      for (int i = tid; i < D; i += bd) agg[i] = to_f(vo[i]);
      __syncthreads();
    } else {
      const int N = s == 1 ? P : A;
      const KV* K = (s == 1 ? k_pt : k_a) + (size_t)li * N * D;
      const KV* V = (s == 1 ? v_pt : v_a) + (size_t)li * N * D;
      const uint8_t* mask = s == 1 ? mask_pl : mask_a;
      const int k = 2 * li + s - 1;
      round_vec<T>(dst_n, xr, D);
      matvec<T>(xr, D, w.wq + (size_t)k * D * D, D, w.bq + k * D, q, part);
      attend<KV>(q, K, V, mask, N, D, H, Hd, sc, ssum, agg, part);
    }
    // gate: sigmoid(to_g([agg, dst_n])); update toward to_s(dst_n)
    round_vec<T>(agg, xr, D);
    round_vec<T>(dst_n, xr + D, D);
    matvec<T>(xr, 2 * D, w.wg + (size_t)j * 2 * D * D, D, w.bg + j * D, t1,
              part);
    round_vec<T>(dst_n, xr, D);
    matvec<T>(xr, D, w.ws + (size_t)j * D * D, D, w.bs + j * D, t2, part);
    for (int i = tid; i < D; i += bd)
      agg[i] = agg[i] + sigmoid(t1[i]) * (t2[i] - agg[i]);
    __syncthreads();
    // x = sd + postnorm(to_out(agg))
    round_vec<T>(agg, xr, D);
    matvec<T>(xr, D, w.wo + (size_t)j * D * D, D, w.bo + j * D, t1, part);
    layer_norm(t1, t2, w.post_s + j * D, w.post_b + j * D, D, red);
    for (int i = tid; i < D; i += bd) x[i] = sd[i] + t2[i];
    __syncthreads();
    // sd = x + ff_postnorm(ff_1(relu(ff_0(ff_prenorm(x)))))
    layer_norm(x, t1, w.ffp_s + j * D, w.ffp_b + j * D, D, red);
    round_vec<T>(t1, xr, D);
    matvec<T>(xr, D, w.wf0 + (size_t)j * D * 4 * D, 4 * D,
              w.bf0 + j * 4 * D, h, part);
    for (int i = tid; i < 4 * D; i += bd) h[i] = fmaxf(h[i], 0.f);
    __syncthreads();
    round_vec<T>(h, xr, 4 * D);
    matvec<T>(xr, 4 * D, w.wf1 + (size_t)j * 4 * D * D, D, w.bf1 + j * D, t1,
              part);
    layer_norm(t1, t2, w.ffq_s + j * D, w.ffq_b + j * D, D, red);
    for (int i = tid; i < D; i += bd) sd[i] = x[i] + t2[i];
    __syncthreads();
  }

  // heads: MLPLayer = dense -> LayerNorm -> relu -> dense
  for (int hi = 0; hi < 4; ++hi) {
    round_vec<T>(sd, xr, D);
    matvec<T>(xr, D, w.wh0 + (size_t)hi * D * D, D, w.bh0 + hi * D, t1,
              part);
    layer_norm(t1, t2, w.lnh_s + hi * D, w.lnh_b + hi * D, D, red);
    for (int i = tid; i < D; i += bd) xr[i] = round_to<T>(fmaxf(t2[i], 0.f));
    __syncthreads();
    if (hi < 3)
      matvec<T>(xr, D, w.wsm + (size_t)hi * D * kSmallCols, kSmallCols,
                w.bsm + hi * kSmallCols, out_small + hi * kSmallCols, part);
    else
      matvec<T>(xr, D, w.wpos, G, w.bpos, out_pos, part);
  }
}

}  // namespace
