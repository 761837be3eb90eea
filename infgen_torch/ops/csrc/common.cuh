// Device code shared by the port's kernels (seed_eval.cu, seed_eval_full.cu,
// refine.cu, motion_column.cu, fused_block.cu, r_biased_attention.cu):
// compute-dtype conversion, block and warp reductions, LayerNorm and matrix
// products over vectors and row tiles in shared memory, order-keeping
// compaction of masks, the seed stack's packed weights, cp.async copies and
// bulk (TMA) copies with their mbarriers.
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
// arithmetic.
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

// ---------------------------------------------------------------------------
// The seed stack's packed weights (infgen_torch/ops/seed_kernel.py::
// pack_seed_params packs them; cluster_stack.cuh runs the stack for
// seed_eval.cu and seed_eval_full.cu).

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

}  // namespace
