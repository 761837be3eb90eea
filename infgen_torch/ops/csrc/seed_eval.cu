// One insertion-seed evaluation on Hopper: the seed stack (L layers x
// {occ2sa, pt2sa, a2sa} attention sublayers, each with pre-LN, masked softmax
// with a zero-aggregate fallback, gated update, post-LN and a 4D FFN) and the
// four seed heads (state, type, shape, grid-cell logits), in one launch of
// one thread-block cluster.
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
// at most about 6 MB, so about 1.8 us at the 3.35 TB/s of HBM. Its
// arithmetic is ~6 MFLOP of fp32 FMA, far below either roof: the kernel is
// bound by bytes.
//
// Design. The one-row chain of about 60 dependent mat-vecs is latency bound
// on one SM. It runs on the cluster stack of cluster_stack.cuh (shared with
// seed_eval_full.cu, which feeds it fp32 K/V): kCluster CTAs each own a
// column slice of every mat-vec and a slice of each attention's keys,
// prefetch their weight slices with cp.async in the chain's order, and
// exchange each mat-vec's slice through distributed shared memory. K/V are
// read in the compute type T, as the caller made them. Nothing precedes it
// in this library, so it is launched without programmatic dependent launch.
//
// Lanes. A batched rollout evaluates one seed per lane (scenario) at once:
// one launch of B clusters, cluster b evaluating lane b's v_occ, K/V and
// masks ([B, ...] arrays) against the shared sd0 and weights into its own
// rows of the outputs. An optional lane mask [B] switches lanes off: every
// CTA of a cluster reads the same flag, so a masked-off cluster leaves as a
// whole before its first cluster barrier, having zeroed its outputs. At
// B = 8 the grid is 64 CTAs, one wave on 132 SMs. The single evaluation is
// the launch with B = 1 and no mask.

#include "cluster_stack.cuh"

namespace {

struct Args {
  const float* sd0;
  const void *v_occ, *k_pt, *v_pt;
  const uint8_t* mask_pl;
  const void *k_a, *v_a;
  const uint8_t* mask_a;
  const void* weights;
  const float* vectors;
  float *out_small, *out_pos;
  const uint8_t* lanes;  // [B] lane mask, or null: every lane on
  int B, L, P, A, D, H, Hd, G;
};

template <typename T>
__global__ void __launch_bounds__(kStackThreads, 1) seed_eval_kernel(
    Args a) {
  extern __shared__ __align__(16) float smem[];
  const int lane = blockIdx.x / kCluster;
  float* out_small = a.out_small + (size_t)lane * 3 * kSmallCols;
  float* out_pos = a.out_pos + (size_t)lane * a.G;
  if (a.lanes != nullptr && !a.lanes[lane]) {
    const int n = 3 * kSmallCols + a.G, step = kCluster * blockDim.x;
    for (int i = (blockIdx.x % kCluster) * blockDim.x + threadIdx.x; i < n;
         i += step) {
      if (i < 3 * kSmallCols)
        out_small[i] = 0.f;
      else
        out_pos[i - 3 * kSmallCols] = 0.f;
    }
    return;
  }
  const size_t lp = (size_t)a.L * a.P * a.D, la = (size_t)a.L * a.A * a.D;
  cluster_stack_and_heads<T, T>(
      seed_weights<T>(a.weights, a.vectors, a.L, a.D), a.sd0,
      static_cast<const T*>(a.v_occ) + (size_t)lane * a.L * a.D,
      static_cast<const T*>(a.k_pt) + lane * lp,
      static_cast<const T*>(a.v_pt) + lane * lp, a.mask_pl + lane * a.P,
      static_cast<const T*>(a.k_a) + lane * la,
      static_cast<const T*>(a.v_a) + lane * la, a.mask_a + lane * a.A,
      out_small, out_pos, a.L, a.P, a.A, a.D, a.H, a.Hd, a.G, smem, [] {});
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = stack_bytes<T>(a.D, a.H, a.P, a.A);
  static size_t allowed = 0;
  cudaError_t err = allow_smem(seed_eval_kernel<T>, bytes, allowed);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * a.B);
  cfg.blockDim = dim3(kStackThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, seed_eval_kernel<T>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a CTA of the stack needs (the wrapper checks them
// against the 227 KB a block can use).
extern "C" int infgen_seed_eval_smem(int dtype, int L, int P, int A, int D,
                                     int H, int G) {
  (void)L;
  (void)G;
  return (int)(dtype == 1 ? stack_bytes<__nv_bfloat16>(D, H, P, A)
                          : stack_bytes<float>(D, H, P, A));
}

// dtype: 0 = float32, 1 = bfloat16 (K/V, v_occ and packed matrices).
// B lanes: v_occ [B, L, D], K/V [B, L, P or A, D], masks [B, P or A],
// out_small [B, 3, 4], out_pos [B, G]; lanes [B] bytes or null (all on).
// Returns a cudaError_t; 0 on a successful launch.
extern "C" int infgen_seed_eval_lanes(
    int dtype, const float* sd0, const void* v_occ, const void* k_pt,
    const void* v_pt, const uint8_t* mask_pl, const void* k_a,
    const void* v_a, const uint8_t* mask_a, const void* weights,
    const float* vectors, float* out_small, float* out_pos,
    const uint8_t* lanes, int B, int L, int P, int A, int D, int H, int Hd,
    int G, void* stream) {
  const Args a{sd0,     v_occ,     k_pt,    v_pt,  mask_pl, k_a, v_a,
               mask_a,  weights,   vectors, out_small, out_pos, lanes, B, L,
               P,       A,         D,       H,     Hd,      G};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

// One evaluation: the launch above with one lane and no mask.
extern "C" int infgen_seed_eval(
    int dtype, const float* sd0, const void* v_occ, const void* k_pt,
    const void* v_pt, const uint8_t* mask_pl, const void* k_a,
    const void* v_a, const uint8_t* mask_a, const void* weights,
    const float* vectors, float* out_small, float* out_pos, int L, int P,
    int A, int D, int H, int Hd, int G, void* stream) {
  return infgen_seed_eval_lanes(dtype, sd0, v_occ, k_pt, v_pt, mask_pl, k_a,
                                v_a, mask_a, weights, vectors, out_small,
                                out_pos, nullptr, 1, L, P, A, D, H, Hd, G,
                                stream);
}
