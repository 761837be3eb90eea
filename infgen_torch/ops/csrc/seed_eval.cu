// One insertion-seed evaluation on Hopper: the seed stack (L layers x
// {occ2sa, pt2sa, a2sa} attention sublayers, each with pre-LN, masked softmax
// with a zero-aggregate fallback, gated update, post-LN and a 4D FFN) and the
// four seed heads (state, type, shape, grid-cell logits), in one launch.
//
// Replaces the TPU kernel infgen_tpu/ops/seed_kernel.py::seed_eval_kernel
// (its math is _stack_and_heads there). The TPU's blocking does not carry
// over: the selector matrix that split the 128-lane axis into heads is gone
// (a head is d / head_dim here), the small heads are padded to 4 columns
// instead of D, the grid head is not padded, and the masks are [N] bytes
// instead of lane-replicated [N, D] floats.
//
// Semantics kept exactly: masked softmax with max subtraction and an
// all-masked key set giving a zero aggregate (e / max(sum e, 1e-30));
// to_g applied to [agg, dst_n] (rows [:D] for agg, [D:] for dst_n); the
// query LayerNorm is prenorm_dst for occ2sa and pt2sa and prenorm_src for
// a2sa (packed per sublayer by the wrapper); occ2sa takes v_occ[i] as its
// aggregate; LayerNorm eps 1e-6; every matmul rounds its input vector to the
// compute dtype T (float or bf16), multiplies by T weights and accumulates
// in fp32; LayerNorm statistics and softmax are fp32.
//
// Bound. Per evaluation at the flagship shapes (D=128, H=8x16, L=3, P=1024,
// A=128, G=1961) in bf16 the kernel must read the K/V rows of the valid keys
// (at most K_pt+V_pt 1.57 MB and K_a+V_a 0.2 MB; masked keys' rows are not
// read), the sublayer weights (12 D^2 in each of the 9 sublayers, plus the
// query projection D^2 in the 6 that attend: 3.7 MB) and the heads 0.6 MB:
// at most about 6 MB, so about 1.8 us at the 3.35 TB/s of HBM. Across the
// evaluations of one token step the weights and K/V would stay in the 50 MB
// L2, which could go lower still; the bound quoted is HBM's. Its arithmetic
// is ~6 MFLOP of fp32 FMA, far below either roof: the kernel is bound by
// bytes.
//
// Design, and what it leaves on the table. One thread block of 512 threads
// per evaluation (the stack and heads live in common.cuh, shared with
// seed_eval_full.cu); the running [D] vector and every intermediate stay in
// shared memory. Mat-vecs use one thread per output column (consecutive
// threads read consecutive weights of a row, so loads coalesce), with the
// input split across thread groups when a layer has fewer columns than
// threads. Scores use one thread per (key, head); the max and sum of each
// head's softmax are warp reductions over the keys. One block runs on one
// SM of the card's 132, so the kernel reaches a few percent of the HBM
// bound at best: splitting the keys over a cluster and streaming K/V with
// TMA is the work of a later change.

#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) seed_eval_kernel(
    const float* sd0, const void* v_occ, const void* k_pt, const void* v_pt,
    const uint8_t* mask_pl, const void* k_a, const void* v_a,
    const uint8_t* mask_a, const void* weights, const float* vectors,
    float* out_small, float* out_pos, int L, int P, int A, int D, int H,
    int Hd, int G) {
  extern __shared__ float smem[];
  seed_stack_and_heads<T, T>(
      seed_weights<T>(weights, vectors, L, D), sd0,
      static_cast<const T*>(v_occ), static_cast<const T*>(k_pt),
      static_cast<const T*>(v_pt), mask_pl, static_cast<const T*>(k_a),
      static_cast<const T*>(v_a), mask_a, out_small, out_pos, L, P, A, D, H,
      Hd, G, smem);
}

template <typename T>
int launch(const float* sd0, const void* v_occ, const void* k_pt,
           const void* v_pt, const uint8_t* mask_pl, const void* k_a,
           const void* v_a, const uint8_t* mask_a, const void* weights,
           const float* vectors, float* out_small, float* out_pos, int L,
           int P, int A, int D, int H, int Hd, int G, cudaStream_t stream) {
  const size_t bytes = seed_stack_floats(D, H, P, A) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      seed_eval_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  seed_eval_kernel<T><<<1, kThreads, bytes, stream>>>(
      sd0, v_occ, k_pt, v_pt, mask_pl, k_a, v_a, mask_a, weights, vectors,
      out_small, out_pos, L, P, A, D, H, Hd, G);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (K/V, v_occ and packed matrices).
// Returns a cudaError_t; 0 on a successful launch.
extern "C" int infgen_seed_eval(
    int dtype, const float* sd0, const void* v_occ, const void* k_pt,
    const void* v_pt, const uint8_t* mask_pl, const void* k_a,
    const void* v_a, const uint8_t* mask_a, const void* weights,
    const float* vectors, float* out_small, float* out_pos, int L, int P,
    int A, int D, int H, int Hd, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(sd0, v_occ, k_pt, v_pt, mask_pl, k_a, v_a, mask_a,
                         weights, vectors, out_small, out_pos, L, P, A, D, H,
                         Hd, G, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(sd0, v_occ, k_pt, v_pt, mask_pl, k_a, v_a,
                                 mask_a, weights, vectors, out_small,
                                 out_pos, L, P, A, D, H, Hd, G, s);
  return (int)cudaErrorInvalidValue;
}
