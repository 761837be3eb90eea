// One whole DenseAttention layer on Hopper: pre-LN, the query / key / value
// projections, masked softmax attention with relation-biased keys and
// values, the gated update, out-projection, post-LN residual and the FFN,
// for Q query rows over at most 128 keys each.
//
// Replaces the TPU kernel infgen_tpu/ops/fused_block.py::
// fused_attention_block. Three key modes: keys gathered per query
// ([Q, K, D]), keys shared by every query ([K, D]) and self-attention (the
// keys are the query rows). Precision is the TPU kernel's: fp32 master
// weights, inputs of type In (float or bf16) read as fp32, everything in
// fp32 with no operand rounding (dense_row.cuh with T = float), the output
// written in In's type or fp32.
//
// Bound. The agent-agent call of the flagship rollout (Q = K = 128, D = 128,
// 8x16 heads) is about 0.57 G multiply-adds when every pair is valid,
// almost all of it the relation projections ([Q K, D] x [D, 2 HD]: each
// pair's r row through w_kr and w_vr), against 4.2 MB of bf16 relations to
// read: 17 us of fp32 arithmetic at 67 TFLOP/s against 1.3 us of HBM
// traffic, so operations bound it. The temporal (K = 12) and map (K = 5)
// calls are a tenth and a twentieth of that. Only valid pairs count: with
// the rollout's masks (few agents within 60 m of each other) the work
// shrinks with the pairs.
//
// Design. One block per query row (dense_row.cuh, as the trunk column's
// kernels): the row's valid keys are compacted in order and projected in
// tiles of kTile in shared memory, so masked pairs cost nothing; scores and
// values of every valid key stay in shared memory for an exact two-pass
// softmax. With shared or self keys the keys' own projections
// (LN_src(x) wk, LN_src(x) wv + bv) do not depend on the query, so a
// prologue launch computes them once per call, one block per key row, into
// fp32 scratch that every query block reads. Products run on the CUDA cores
// in fp32 and each block reads the weights from L2; tensor-core tiles over
// the pairs are the work of a later change.

#include "dense_row.cuh"

namespace {

struct Params {
  const void* x;       // [Q, D] In
  const void* src;     // [Q, K, D] (per query) or [K, D] (shared) In; null:
                       // self-attention over x
  const void* r;       // [Q, K, D] In
  const uint8_t* mask; // [Q, K]
  const void* w[kNumArgs];
  void* out;           // [Q, D] In
  float* scratch;      // [2, K, D]: the shared keys' k and v
  int Q, K, D, H, Hd, per_query;
};

template <typename In>
__device__ void load_row(const In* src, float* x, int D) {
  for (int i = threadIdx.x; i < D; i += blockDim.x) x[i] = to_f(src[i]);
  __syncthreads();
}

__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);
}

// Key row blockIdx.x of a shared or self call: k = LN_src(row) wk,
// v = LN_src(row) wv + bv into scratch.
template <typename In>
__global__ void __launch_bounds__(kThreads, 1) key_kernel(Params p) {
  extern __shared__ float smem[];
  const Smem s = carve(smem, p.D, p.H, 0);
  const int k = blockIdx.x, D = p.D;
  const In* rows = static_cast<const In*>(p.src ? p.src : p.x);
  load_row(rows + (size_t)k * D, s.x, D);
  row_kv<float>(Sub{p.w, 0, D, p.H, p.Hd}, s);
  float* ks = p.scratch + (size_t)k * D;
  float* vs = p.scratch + ((size_t)p.K + k) * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    ks[i] = s.t2[i];
    vs[i] = s.t3[i];
  }
}

// Query row blockIdx.x: the whole layer.
template <typename In>
__global__ void __launch_bounds__(kThreads, 1) query_kernel(Params p) {
  extern __shared__ float smem[];
  const Smem s = carve(smem, p.D, p.H, p.K);
  const int a = blockIdx.x, K = p.K, D = p.D;
  const Sub u{p.w, 0, D, p.H, p.Hd};
  load_row(static_cast<const In*>(p.x) + (size_t)a * D, s.x, D);
  row_query<float>(u, s);
  const In* keys = p.per_query
                       ? static_cast<const In*>(p.src) + (size_t)a * K * D
                       : nullptr;
  row_attend<float, In>(u, keys,
                        static_cast<const In*>(p.r) + (size_t)a * K * D,
                        p.mask + (size_t)a * K, K, p.scratch,
                        p.scratch + (size_t)K * D, s);
  row_epilogue<float>(u, s);
  In* out = static_cast<In*>(p.out) + (size_t)a * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) store(s.x[i], out + i);
}

template <typename In>
int launch(Params& p, cudaStream_t stream) {
  cudaError_t err;
  if (!p.per_query) {
    const size_t kb = smem_floats(p.D, p.H, 0) * sizeof(float);
    err = cudaFuncSetAttribute(
        key_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kb);
    if (err != cudaSuccess) return (int)err;
    key_kernel<In><<<p.K, kThreads, kb, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t qb = smem_floats(p.D, p.H, p.K) * sizeof(float);
  err = cudaFuncSetAttribute(
      query_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)qb);
  if (err != cudaSuccess) return (int)err;
  query_kernel<In><<<p.Q, kThreads, qb, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, x_src, r and the output; the weights
// are fp32). x_src: null for self-attention. per_query: x_src is [Q, K, D].
// ptrs: host array of kNumArgs device pointers (one sublayer's pack).
// scratch: fp32 [2, K, D] unless per_query. Returns a cudaError_t; 0 on
// successful launches.
extern "C" int infgen_fused_block(int dtype, const void* x, const void* x_src,
                                  const void* r, const uint8_t* mask,
                                  const uint64_t* ptrs, void* out,
                                  float* scratch, int Q, int K, int D, int H,
                                  int Hd, int per_query, void* stream) {
  Params p;
  p.x = x;
  p.src = x_src;
  p.r = r;
  p.mask = mask;
  for (int i = 0; i < kNumArgs; ++i)
    p.w[i] = reinterpret_cast<const void*>(ptrs[i]);
  p.out = out;
  p.scratch = scratch;
  p.Q = Q;
  p.K = K;
  p.D = D;
  p.H = H;
  p.Hd = Hd;
  p.per_query = per_query;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
