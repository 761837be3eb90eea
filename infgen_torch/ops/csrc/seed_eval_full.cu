// One insertion-seed evaluation from raw inputs on Hopper: the per-step
// precompute and the seed stack + heads, as two kernels launched in order on
// one stream by one call.
//
// Replaces the TPU kernel infgen_tpu/ops/seed_kernel.py::
// seed_eval_full_kernel (_kernel_full there). The precompute it folds in:
//   - the occupancy MLP seed_agent_occ_embed (fp32: the module has no compute
//     dtype) and each layer's occ2sa value, LN(occ_emb) @ to_v + b;
//   - map K/V of every layer: k0 / v0 (the rollout-invariant x_pt
//     projections, in the compute dtype T) plus the geometry term
//     LN(r_pl) @ w_kr (and @ w_vr + b_vr), summed in fp32 and never rounded
//     to T (the non-full path rounds that sum);
//   - the agent rows' zero-aggregate key chain (occ2sa, pt2sa, a2sa steps of
//     each layer, agg == 0) and each layer's agent K/V from the chain state
//     before that layer's a2sa step plus the geometry term of r_sa.
// The stack then runs as in seed_eval.cu (common.cuh), on fp32 K/V.
//
// Bound. At the flagship shapes (D=128, 8x16 heads, L=3, P=1024, A=128,
// G=1961) in bf16 one evaluation must read k0/v0 (1.57 MB), r_pl (0.26 MB),
// the agent column and r_sa (65 KB), the stack's weights (4.3 MB) and the
// precompute's matrices (7 D^2 per layer, 0.69 MB) and occupancy MLP rows
// of the occupied cells (512 B each): about 7 MB, about 2 us at 3.35 TB/s,
// less where keys are masked (a masked key's rows are never read). Its
// arithmetic is about 0.33 G multiply-adds with every key valid: the map
// geometry terms (2 D^2 per map row and layer) and the agent chain (11 D^2
// per step, 8 steps, plus 4 D^2 per layer for K/V), 0.7 us at the bf16
// tensor-core peak: bytes bound it.
//
// Design. The precompute is row parallel: the first kernel gives each block
// a tile of map rows (all layers' K/V of those rows), of agent rows (their
// whole chain and K/V) or the occupancy MLP, and skips masked rows, whose
// K/V the stack never reads. A block holds its tile in shared memory and
// multiplies it by the weights with one thread per (output column, row
// group), so each weight read from L2 serves several rows. Results go to
// fp32 scratch; the second kernel is the one-block stack of seed_eval.cu,
// reading them. Weights are read from L2 by every block of a tile kind, and
// the stack runs on one SM: tensor-core tiles (wgmma) and a split stack are
// the work of a later change.

#include "common.cuh"

namespace {

// The precompute's packed arrays, in the order of the pointer array that
// seed_kernel.py::_full_layouts lays out: matrices [L, D, D] in T, then
// fp32 vectors and the occupancy MLP.
enum FullArg {
  PTR_WKR, PTR_WVR, SAR_WKR, SAR_WVR, KA_WK, KA_WV, OCC_WV,
  PTR_LNR_S, PTR_LNR_B, PTR_BVR, SAR_LNR_S, SAR_LNR_B, SAR_BVR, KA_LNS_S,
  KA_LNS_B, KA_BV, OCC_LNS_S, OCC_LNS_B, OCC_BV,
  OE_W0, OE_B0, OE_LN_S, OE_LN_B, OE_W1, OE_B1,
  kNumFullArgs
};

struct FullPtrs {
  const void* p[kNumFullArgs];
};

constexpr int kMapTile = 16;    // map rows per block
constexpr int kAgentTile = 4;   // agent rows per block (8 chain steps each)

struct PreParams {
  const void* k0;          // [L, P, D] T
  const void* v0;          // [L, P, D] T
  const void* r_pl;        // [P, D] T
  const uint8_t* mask_pl;  // [P]
  const void* agent_col;   // [A, D] T
  const void* r_sa;        // [A, D] T
  const uint8_t* mask_a;   // [A]
  const uint8_t* occ;      // [G]
  const void* weights;     // the stack's packed matrices (chain steps)
  const float* vectors;    // the stack's packed vectors
  FullPtrs x;
  float* v_occ;            // [L, D] out
  float* K_pt;             // [L, P, D] out
  float* V_pt;             // [L, P, D] out
  float* K_a;              // [L, A, D] out
  float* V_a;              // [L, A, D] out
  int L, P, A, D, G, n_map_blocks, n_agent_blocks;
};

template <typename T>
__device__ __forceinline__ const T* mat(const PreParams& p, FullArg a,
                                        int i) {
  return static_cast<const T*>(p.x.p[a]) + (size_t)i * p.D * p.D;
}

__device__ __forceinline__ const float* vec(const PreParams& p, FullArg a,
                                            int i) {
  return static_cast<const float*>(p.x.p[a]) + (size_t)i * p.D;
}

// Map rows [r0, r0 + kMapTile): K/V of every layer for the valid ones.
template <typename T>
__device__ void map_rows(const PreParams& p, int r0, float* smem) {
  const int D = p.D, tid = threadIdx.x, bd = blockDim.x;
  int* idx = reinterpret_cast<int*>(smem);          // [kMapTile]
  int* scan = idx + kMapTile;                       // [bd / 32 + 1]
  float* raw = smem + kMapTile + kThreads / 32 + 1;  // [kMapTile, D]
  float* rn = raw + kMapTile * D;                    // [kMapTile, D]
  float* acc = rn + kMapTile * D;                    // [kMapTile, D]
  const int n = compact(p.mask_pl + r0, min(kMapTile, p.P - r0), idx, scan);
  if (n == 0) return;
  const T* rpl = static_cast<const T*>(p.r_pl);
  for (int i = tid; i < n * D; i += bd)
    raw[i] = to_f(rpl[(size_t)(r0 + idx[i / D]) * D + i % D]);
  __syncthreads();
  const T* k0 = static_cast<const T*>(p.k0);
  const T* v0 = static_cast<const T*>(p.v0);
  for (int l = 0; l < p.L; ++l) {
    rows_ln<T, true>(raw, D, rn, D, n, D, vec(p, PTR_LNR_S, l),
                     vec(p, PTR_LNR_B, l));
    rows_mm<T>(rn, D, n, D, mat<T>(p, PTR_WKR, l), D, nullptr, acc, D, false);
    for (int i = tid; i < n * D; i += bd) {
      const size_t o = ((size_t)l * p.P + r0 + idx[i / D]) * D + i % D;
      p.K_pt[o] = to_f(k0[o]) + acc[i];
    }
    __syncthreads();
    rows_mm<T>(rn, D, n, D, mat<T>(p, PTR_WVR, l), D, nullptr, acc, D, false);
    const float* bvr = vec(p, PTR_BVR, l);
    for (int i = tid; i < n * D; i += bd) {
      const size_t o = ((size_t)l * p.P + r0 + idx[i / D]) * D + i % D;
      p.V_pt[o] = (to_f(v0[o]) + acc[i]) + bvr[i % D];
    }
    __syncthreads();
  }
}

// One zero-aggregate step of stack sublayer j on the n rows of `ag`
// (the key chain): agg = sigmoid(to_g([0, dst_n])) * to_s(dst_n), then the
// residual and FFN epilogue. fp32 residual carrier.
template <typename T>
__device__ void zero_agg_rows(const SeedWeights<T>& w, int j, float* ag,
                              int n, int D, float* dn, float* t1, float* t2,
                              float* h4) {
  const int tid = threadIdx.x, bd = blockDim.x;
  rows_ln<T, true>(ag, D, dn, D, n, D, w.lnq_s + j * D, w.lnq_b + j * D);
  rows_mm<T>(dn, D, n, D, w.wg + (size_t)j * 2 * D * D + (size_t)D * D, D,
             w.bg + j * D, t1, D, false);
  rows_mm<T>(dn, D, n, D, w.ws + (size_t)j * D * D, D, w.bs + j * D, t2, D,
             false);
  for (int i = tid; i < n * D; i += bd)
    t1[i] = round_to<T>(sigmoid(t1[i]) * t2[i]);
  __syncthreads();
  rows_mm<T>(t1, D, n, D, w.wo + (size_t)j * D * D, D, w.bo + j * D, t2, D,
             false);
  rows_ln<T, false>(t2, D, t2, D, n, D, w.post_s + j * D, w.post_b + j * D);
  for (int i = tid; i < n * D; i += bd) ag[i] += t2[i];
  __syncthreads();
  rows_ln<T, true>(ag, D, dn, D, n, D, w.ffp_s + j * D, w.ffp_b + j * D);
  rows_mm<T>(dn, D, n, D, w.wf0 + (size_t)j * D * 4 * D, 4 * D,
             w.bf0 + j * 4 * D, h4, 4 * D, false);
  for (int i = tid; i < n * 4 * D; i += bd)
    h4[i] = round_to<T>(fmaxf(h4[i], 0.f));
  __syncthreads();
  rows_mm<T>(h4, 4 * D, n, 4 * D, w.wf1 + (size_t)j * 4 * D * D, D,
             w.bf1 + j * D, t2, D, false);
  rows_ln<T, false>(t2, D, t2, D, n, D, w.ffq_s + j * D, w.ffq_b + j * D);
  for (int i = tid; i < n * D; i += bd) ag[i] += t2[i];
  __syncthreads();
}

// Agent rows [r0, r0 + kAgentTile): the key chain and every layer's K/V of
// the valid ones.
template <typename T>
__device__ void agent_rows(const PreParams& p, int r0, float* smem) {
  const int D = p.D, tid = threadIdx.x, bd = blockDim.x;
  const int A = p.A;
  int* idx = reinterpret_cast<int*>(smem);              // [kAgentTile]
  int* scan = idx + kAgentTile;                          // [bd / 32 + 1]
  float* ag = smem + kAgentTile + kThreads / 32 + 1;     // [tile, D]
  float* rsa = ag + kAgentTile * D;                      // [tile, D]
  float* dn = rsa + kAgentTile * D;                      // [tile, D]
  float* rn = dn + kAgentTile * D;                       // [tile, D]
  float* t1 = rn + kAgentTile * D;                       // [tile, D]
  float* t2 = t1 + kAgentTile * D;                       // [tile, D]
  float* h4 = t2 + kAgentTile * D;                       // [tile, 4D]
  const int n = compact(p.mask_a + r0, min(kAgentTile, A - r0), idx, scan);
  if (n == 0) return;
  const T* col = static_cast<const T*>(p.agent_col);
  const T* r_sa = static_cast<const T*>(p.r_sa);
  for (int i = tid; i < n * D; i += bd) {
    const size_t o = (size_t)(r0 + idx[i / D]) * D + i % D;
    ag[i] = to_f(col[o]);
    rsa[i] = to_f(r_sa[o]);
  }
  __syncthreads();
  const SeedWeights<T> w = seed_weights<T>(p.weights, p.vectors, p.L, D);
  for (int l = 0; l < p.L; ++l) {
    zero_agg_rows<T>(w, 3 * l, ag, n, D, dn, t1, t2, h4);      // occ2sa
    zero_agg_rows<T>(w, 3 * l + 1, ag, n, D, dn, t1, t2, h4);  // pt2sa
    // this layer's a2sa keys: the chain before its own zero-agg step
    rows_ln<T, true>(ag, D, dn, D, n, D, vec(p, KA_LNS_S, l),
                     vec(p, KA_LNS_B, l));
    rows_ln<T, true>(rsa, D, rn, D, n, D, vec(p, SAR_LNR_S, l),
                     vec(p, SAR_LNR_B, l));
    rows_mm<T>(dn, D, n, D, mat<T>(p, KA_WK, l), D, nullptr, t1, D, false);
    rows_mm<T>(rn, D, n, D, mat<T>(p, SAR_WKR, l), D, nullptr, t1, D, true);
    for (int i = tid; i < n * D; i += bd)
      p.K_a[((size_t)l * A + r0 + idx[i / D]) * D + i % D] = t1[i];
    __syncthreads();
    rows_mm<T>(dn, D, n, D, mat<T>(p, KA_WV, l), D, vec(p, KA_BV, l), t1, D,
               false);
    rows_mm<T>(rn, D, n, D, mat<T>(p, SAR_WVR, l), D, nullptr, t1, D, true);
    const float* bvr = vec(p, SAR_BVR, l);
    for (int i = tid; i < n * D; i += bd)
      p.V_a[((size_t)l * A + r0 + idx[i / D]) * D + i % D] =
          t1[i] + bvr[i % D];
    __syncthreads();
    if (l + 1 < p.L)  // the last layer's a2sa step is never read
      zero_agg_rows<T>(w, 3 * l + 2, ag, n, D, dn, t1, t2, h4);
  }
}

// The occupancy MLP (fp32) and every layer's occ2sa value.
template <typename T>
__device__ void occupancy(const PreParams& p, float* smem) {
  const int D = p.D, tid = threadIdx.x, bd = blockDim.x;
  int* scan = reinterpret_cast<int*>(smem);             // [bd / 32 + 1]
  int* idx = scan + kThreads / 32 + 1;                   // [G]
  float* h = reinterpret_cast<float*>(idx + p.G);        // [D]
  float* e = h + D;                                      // [D]
  float* t = e + D;                                      // [D]
  float* part = t + D;                                   // [blockDim]
  float* red = part + bd;                                // [32]
  // occ @ W0 over the occupied cells only: an empty cell adds 0 * w
  const int n = compact(p.occ, p.G, idx, scan);
  const float* w0 = static_cast<const float*>(p.x.p[OE_W0]);
  const float* b0 = static_cast<const float*>(p.x.p[OE_B0]);
  for (int c = tid; c < D; c += bd) {
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc += w0[(size_t)idx[k] * D + c];
    t[c] = acc + b0[c];
  }
  __syncthreads();
  layer_norm(t, h, static_cast<const float*>(p.x.p[OE_LN_S]),
             static_cast<const float*>(p.x.p[OE_LN_B]), D, red);
  for (int i = tid; i < D; i += bd) h[i] = fmaxf(h[i], 0.f);
  __syncthreads();
  matvec<float>(h, D, static_cast<const float*>(p.x.p[OE_W1]), D,
                static_cast<const float*>(p.x.p[OE_B1]), e, part);
  for (int l = 0; l < p.L; ++l) {
    layer_norm(e, t, vec(p, OCC_LNS_S, l), vec(p, OCC_LNS_B, l), D, red);
    round_vec<T>(t, h, D);
    matvec<T>(h, D, mat<T>(p, OCC_WV, l), D, vec(p, OCC_BV, l),
              p.v_occ + (size_t)l * D, part);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) precompute_kernel(PreParams p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  if (b < p.n_map_blocks)
    map_rows<T>(p, b * kMapTile, smem);
  else if (b < p.n_map_blocks + p.n_agent_blocks)
    agent_rows<T>(p, (b - p.n_map_blocks) * kAgentTile, smem);
  else
    occupancy<T>(p, smem);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) stack_kernel(
    const float* sd0, const float* v_occ, const float* k_pt,
    const float* v_pt, const uint8_t* mask_pl, const float* k_a,
    const float* v_a, const uint8_t* mask_a, const void* weights,
    const float* vectors, float* out_small, float* out_pos, int L, int P,
    int A, int D, int H, int Hd, int G) {
  extern __shared__ float smem[];
  seed_stack_and_heads<T, float>(seed_weights<T>(weights, vectors, L, D),
                                 sd0, v_occ, k_pt, v_pt, mask_pl, k_a, v_a,
                                 mask_a, out_small, out_pos, L, P, A, D, H,
                                 Hd, G, smem);
}

size_t precompute_bytes(int D, int G) {
  const size_t head = kThreads / 32 + 1;
  const size_t map = kMapTile + head + (size_t)3 * kMapTile * D;
  const size_t agent = kAgentTile + head + (size_t)10 * kAgentTile * D;
  const size_t occ = head + G + (size_t)3 * D + kThreads + 32;
  size_t m = map > agent ? map : agent;
  m = m > occ ? m : occ;
  return m * sizeof(float);
}

template <typename T>
int launch(PreParams& p, const float* sd0, float* out_small, float* out_pos,
           int H, int Hd, cudaStream_t stream) {
  p.n_map_blocks = (p.P + kMapTile - 1) / kMapTile;
  p.n_agent_blocks = (p.A + kAgentTile - 1) / kAgentTile;
  const size_t pre = precompute_bytes(p.D, p.G);
  cudaError_t err = cudaFuncSetAttribute(
      precompute_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pre);
  if (err != cudaSuccess) return (int)err;
  const size_t stack = seed_stack_floats(p.D, H, p.P, p.A) * sizeof(float);
  err = cudaFuncSetAttribute(stack_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)stack);
  if (err != cudaSuccess) return (int)err;
  precompute_kernel<T><<<p.n_map_blocks + p.n_agent_blocks + 1, kThreads,
                         pre, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stack_kernel<T><<<1, kThreads, stack, stream>>>(
      sd0, p.v_occ, p.K_pt, p.V_pt, p.mask_pl, p.K_a, p.V_a, p.mask_a,
      p.weights, p.vectors, out_small, out_pos, p.L, p.P, p.A, p.D, H, Hd,
      p.G);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (k0, v0, r_pl, agent_col, r_sa and the
// packed matrices). full_ptrs: host array of kNumFullArgs device pointers.
// v_occ .. v_a: fp32 scratch the first kernel writes and the second reads.
// Returns a cudaError_t; 0 on successful launches.
extern "C" int infgen_seed_eval_full(
    int dtype, const float* sd0, const void* k0, const void* v0,
    const void* r_pl, const uint8_t* mask_pl, const void* agent_col,
    const void* r_sa, const uint8_t* mask_a, const uint8_t* occ,
    const void* weights, const float* vectors, const uint64_t* full_ptrs,
    float* v_occ, float* K_pt, float* V_pt, float* K_a, float* V_a,
    float* out_small, float* out_pos, int L, int P, int A, int D, int H,
    int Hd, int G, void* stream) {
  PreParams p;
  p.k0 = k0;
  p.v0 = v0;
  p.r_pl = r_pl;
  p.mask_pl = mask_pl;
  p.agent_col = agent_col;
  p.r_sa = r_sa;
  p.mask_a = mask_a;
  p.occ = occ;
  p.weights = weights;
  p.vectors = vectors;
  for (int i = 0; i < kNumFullArgs; ++i)
    p.x.p[i] = reinterpret_cast<const void*>(full_ptrs[i]);
  p.v_occ = v_occ;
  p.K_pt = K_pt;
  p.V_pt = V_pt;
  p.K_a = K_a;
  p.V_a = V_a;
  p.L = L;
  p.P = P;
  p.A = A;
  p.D = D;
  p.G = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, sd0, out_small, out_pos, H, Hd, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, sd0, out_small, out_pos, H, Hd, s);
  return (int)cudaErrorInvalidValue;
}
