// One insertion-seed evaluation from raw inputs on Hopper: the per-step
// precompute, then the seed stack + heads over a thread-block cluster, as
// two kernels launched in order on one stream by one call.
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
// The precompute's fp32 results stay in device memory (the caller's
// scratch), where the stack reads them.
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
// Design of the bf16 path (the main path's type). Operands rounded to bf16
// and multiplied with fp32 sums is exactly what the tensor cores' bf16
// mma computes, so the precompute's products run there (mma.sync
// m16n8k16, fp32 accumulators in registers):
//   - map rows: a [64 valid rows, D] x [D, D] tile product per layer and
//     projection (w_kr, w_vr); the epilogue adds k0 / v0 and b_vr in fp32;
//   - the agent chain: tiles of up to 32 valid agent rows run the 8 steps
//     and the 3 K/V projections as [32, D] x [D, D] tile products;
//   - weights arrive as [D, D] tiles of W^T (seed_kernel.py::chain_tiles,
//     in the order a block uses them) through a three-stage cp.async ring
//     in shared memory, so the next two tiles land while this one
//     multiplies;
//   - the occupancy MLP and each layer's occ2sa value take one block per
//     layer of the same launch, their mat-vecs reading weights eight rows
//     ahead.
// The stack (cluster_stack.cuh) spreads the one-query chain over a cluster
// of 8 CTAs, which prefetch their column slices of the weights; it is
// launched with programmatic dependent launch, so its first weight stage
// loads while the precompute runs, and it waits for the precompute's
// results before reading them. The fp32 path (held to the fp32 limits)
// keeps the precompute on CUDA-core FMAs, with each block reading the
// weights from L2 for a small row tile; its stack is the same cluster
// stack.
// What sets its time (on an H100, PERF.md): the precompute, whose agent
// chain blocks (100 tiles each) finish long after the map and occupancy
// blocks, then the stack. Tiles of 16 rows and a four-stage ring did not
// shorten the chain.
//
// Lanes. A batched rollout evaluates one seed per lane (scenario) at once:
// the inputs and the scratch carry a leading lane axis ([B, L, P, D] k0 /
// v0, [B, P, D] r_pl, [B, A, D] agent column and r_sa, [B, ...] masks and
// occupancy rows; sd0 and the weights shared). The precompute's grid gains
// a lane dimension (blockIdx.y: its row tiles run over every lane), and the
// stack launches one cluster of kCluster CTAs per lane. An optional lane
// mask [B] switches lanes off: their precompute blocks leave at once, and
// every CTA of their stack cluster zeroes its share of the outputs and
// leaves before its first cluster barrier. The single evaluation is the
// launch with B = 1 and no mask; every active lane computes what its
// single evaluation computes, bit for bit.

#include "cluster_stack.cuh"
#include "mma_tiles.cuh"

namespace {

// The precompute's packed arrays, in the order of the pointer array that
// seed_kernel.py::_full_layouts lays out: matrices [L, D, D] in T, then
// fp32 vectors and the occupancy MLP, then the tiles of chain_tiles.
enum FullArg {
  PTR_WKR, PTR_WVR, SAR_WKR, SAR_WVR, KA_WK, KA_WV, OCC_WV,
  PTR_LNR_S, PTR_LNR_B, PTR_BVR, SAR_LNR_S, SAR_LNR_B, SAR_BVR, KA_LNS_S,
  KA_LNS_B, KA_BV, OCC_LNS_S, OCC_LNS_B, OCC_BV,
  OE_W0, OE_B0, OE_LN_S, OE_LN_B, OE_W1, OE_B1,
  TILES,  // the bf16 path's weight tiles (null for fp32)
  kNumFullArgs
};

struct FullPtrs {
  const void* p[kNumFullArgs];
};

// the fp32 path: CUDA-core row tiles
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
  const uint8_t* lanes;    // [B] lane mask, or null: every lane on
  int L, P, A, D, G, n_map_blocks, n_agent_blocks;
};

// p's arrays moved to lane b's ([B, ...] arrays; T: the raw inputs' type).
// Returns false when the lane is masked off.
template <typename T>
__device__ __forceinline__ bool pre_lane(PreParams& p, size_t b) {
  if (p.lanes != nullptr && !p.lanes[b]) return false;
  const size_t lp = (size_t)p.L * p.P * p.D, la = (size_t)p.L * p.A * p.D;
  p.k0 = static_cast<const T*>(p.k0) + b * lp;
  p.v0 = static_cast<const T*>(p.v0) + b * lp;
  p.r_pl = static_cast<const T*>(p.r_pl) + b * p.P * p.D;
  p.mask_pl += b * p.P;
  p.agent_col = static_cast<const T*>(p.agent_col) + b * p.A * p.D;
  p.r_sa = static_cast<const T*>(p.r_sa) + b * p.A * p.D;
  p.mask_a += b * p.A;
  p.occ += b * p.G;
  p.v_occ += b * p.L * p.D;
  p.K_pt += b * lp;
  p.V_pt += b * lp;
  p.K_a += b * la;
  p.V_a += b * la;
  return true;
}

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

// y[c] = sum_k xr[k] W[k, c] + bias[c] for c < n_out <= blockDim, W
// [n_in, n_out] in global memory read eight rows ahead; groups of threads
// split k and add their sums in a fixed order (`part`: blockDim floats).
template <typename T>
__device__ void mv_global(const float* xr, int n_in, const T* W, int n_out,
                          const float* bias, float* y, float* part) {
  const int tid = threadIdx.x, G = max(1, (int)blockDim.x / n_out);
  const int c = tid % n_out, g = tid / n_out, chunk = (n_in + G - 1) / G;
  if (g < G) {
    const int k0 = g * chunk, k1 = min(n_in, k0 + chunk);
    float acc = 0.f;
#pragma unroll 8
    for (int k = k0; k < k1; ++k)
      acc = fmaf(xr[k], to_f(W[(size_t)k * n_out + c]), acc);
    part[g * n_out + c] = acc;
  }
  __syncthreads();
  if (tid < n_out) {
    float acc = 0.f;
    for (int gg = 0; gg < G; ++gg) acc += part[gg * n_out + tid];
    y[tid] = acc + bias[tid];
  }
  __syncthreads();
}

inline size_t occ_layer_bytes(int D, int G) {
  return ((size_t)kThreads / 32 + 1 + G + 3 * D + kThreads + 32) * 4;
}

// The occupancy MLP (fp32) and layer l's occ2sa value: one block per layer,
// each computing the embedding itself (blockDim <= kThreads).
template <typename T>
__device__ void occupancy_layer(const PreParams& p, int l, float* smem) {
  const int D = p.D, tid = threadIdx.x, bd = blockDim.x;
  int* scan = reinterpret_cast<int*>(smem);             // [bd / 32 + 1]
  int* idx = scan + kThreads / 32 + 1;                   // [G]
  float* t = reinterpret_cast<float*>(idx + p.G);        // [D]
  float* h = t + D;                                      // [D]
  float* e = h + D;                                      // [D]
  float* part = e + D;                                   // [bd]
  float* red = part + bd;                                // [32]
  // occ @ W0 over the occupied cells only: an empty cell adds 0 * w
  const int n = compact(p.occ, p.G, idx, scan);
  const float* w0 = static_cast<const float*>(p.x.p[OE_W0]);
  const int G2 = max(1, bd / D);
  for (int i = tid; i < G2 * D; i += bd) {
    const int c = i % D, g = i / D;
    float acc = 0.f;
#pragma unroll 8
    for (int k = g; k < n; k += G2) acc += w0[(size_t)idx[k] * D + c];
    part[g * D + c] = acc;
  }
  __syncthreads();
  const float* b0 = static_cast<const float*>(p.x.p[OE_B0]);
  for (int c = tid; c < D; c += bd) {
    float acc = 0.f;
    for (int g = 0; g < G2; ++g) acc += part[g * D + c];
    t[c] = acc + b0[c];
  }
  __syncthreads();
  layer_norm(t, h, static_cast<const float*>(p.x.p[OE_LN_S]),
             static_cast<const float*>(p.x.p[OE_LN_B]), D, red);
  for (int i = tid; i < D; i += bd) h[i] = fmaxf(h[i], 0.f);
  __syncthreads();
  mv_global<float>(h, D, static_cast<const float*>(p.x.p[OE_W1]), D,
                   static_cast<const float*>(p.x.p[OE_B1]), e, part);
  layer_norm(e, t, vec(p, OCC_LNS_S, l), vec(p, OCC_LNS_B, l), D, red);
  round_vec<T>(t, h, D);
  mv_global<T>(h, D, mat<T>(p, OCC_WV, l), D, vec(p, OCC_BV, l),
               p.v_occ + (size_t)l * D, part);
}

// The fp32 precompute: map and agent row tiles on CUDA-core FMAs.
__global__ void __launch_bounds__(kThreads, 1) precompute_fp32_kernel(
    PreParams p) {
  extern __shared__ __align__(16) float smem[];
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  using T = float;
  if (!pre_lane<T>(p, blockIdx.y)) return;
  const int b = blockIdx.x;
  if (b < p.n_map_blocks)
    map_rows<T>(p, b * kMapTile, smem);
  else if (b < p.n_map_blocks + p.n_agent_blocks)
    agent_rows<T>(p, (b - p.n_map_blocks) * kAgentTile, smem);
  else
    occupancy_layer<T>(p, b - p.n_map_blocks - p.n_agent_blocks, smem);
}


// ---------------------------------------------------------------------------
// The bf16 precompute: tensor-core tile products.

constexpr int kPreThreads = 256;  // 8 warps: the mma tiles assume it
constexpr int kChainRows = 32;    // agent rows per chain block
constexpr int kMapRows = 64;      // map rows per block
constexpr int kChainMT = kChainRows / 16;  // m16 tiles of a chain block

// Tiles of chain_tiles before the map's: 11 per zero-aggregate step (3L - 1
// steps) and 4 per layer's agent K/V.
__host__ __device__ inline int n_chain_tiles(int L) { return 37 * L - 11; }

// A block's run through consecutive tiles [begin, end) of `tiles` ([n, D, D]
// bf16), staged in `ring` (kTileStages [D, D + 8] buffers, rows padded so
// that the fragment loads hit distinct banks) with cp.async, one commit
// group per tile; up to kTileStages - 1 tiles are in flight ahead of the
// one in use. (Bulk copies of one row each were twice as slow: a tile is
// D of them.)
constexpr int kTileStages = 3;

struct TileStream {
  const bf16* tiles;
  bf16* ring;
  int D, t, begin, end, loaded;
};

__device__ void tile_top_up(TileStream& s) {
  const int D = s.D, cpr = D / 8;
  while (s.loaded < s.t + kTileStages && s.loaded < s.end) {
    const bf16* src = s.tiles + (size_t)s.loaded * D * D;
    bf16* dst = s.ring + ((s.loaded - s.begin) % kTileStages) * D * (D + 8);
    for (int i = threadIdx.x; i < D * cpr; i += blockDim.x) {
      const int n = i / cpr, ch = i % cpr;
      cp_async16(dst + n * (D + 8) + ch * 8, src + (size_t)n * D + ch * 8);
    }
    cp_commit();
    ++s.loaded;
  }
}

__device__ const bf16* tile_acquire(TileStream& s) {
  tile_top_up(s);
  switch (s.loaded - s.t - 1) {  // groups that may stay in flight
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    default: cp_wait<kTileStages - 1>(); break;
  }
  __syncthreads();
  return s.ring + ((s.t - s.begin) % kTileStages) * s.D * (s.D + 8);
}

__device__ void tile_release(TileStream& s) {
  __syncthreads();  // the buffer is refilled at a later top-up
  ++s.t;
}

template <int MT>
__device__ void zero_acc(float (&acc)[MT][2][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
}

// acc += A [16 MT, D] (bf16, row stride lda) x B^T, B [D, D + 8] the staged
// tile of W^T (row n = output column n). Warp w owns output columns
// [w D / 8, (w + 1) D / 8), D / 64 n8 blocks of it.
template <int MT>
__device__ void mma_tile(const bf16* A, int lda, const bf16* B, int D,
                         float (&acc)[MT][2][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, nb = D / 64, n0 = warp * nb * 8;
  const int ldb = D + 8;
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const bf16* ap = A + (m * 16 + g) * lda + k0 + 2 * t;
      a[m][0] = ld32(ap);
      a[m][1] = ld32(ap + 8 * lda);
      a[m][2] = ld32(ap + 8);
      a[m][3] = ld32(ap + 8 * lda + 8);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j < nb) {
        const bf16* bp = B + (n0 + j * 8 + g) * ldb + k0 + 2 * t;
        const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(acc[m][j], a[m], b0, b1);
      }
    }
  }
}

// The row and column of accumulator [m][j][e] of this thread.
__device__ __forceinline__ void acc_coord(int m, int j, int e, int D,
                                          int& row, int& col) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  row = m * 16 + (lane >> 2) + (e >> 1) * 8;
  col = warp * (D / 64) * 8 + j * 8 + 2 * (lane & 3) + (e & 1);
}

// fn(row, column, value + b1[column] + b2[column]) for each accumulator of
// this thread (b1, b2 may be null). The thread's bias values are read
// before any fn runs, so the loads overlap rather than wait behind fn's
// stores.
template <int MT, typename Fn>
__device__ void for_acc(const float (&acc)[MT][2][4], int D, const float* b1,
                        const float* b2, Fn fn) {
  const int nb = D / 64;
  float b[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int row, col;
      acc_coord(0, j, e, D, row, col);
      b[j][e] = 0.f;
      if (j < nb) {
        if (b1) b[j][e] = __ldg(b1 + col);
        if (b2) b[j][e] += __ldg(b2 + col);
      }
    }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (j < nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int row, col;
          acc_coord(m, j, e, D, row, col);
          fn(row, col, acc[m][j][e] + b[j][e & 1]);
        }
}

// dst[0..D) = bf16(LayerNorm(src) * s + b), by one warp (D <= 128).
template <typename In>
__device__ void ln_warp_bf16(const In* src, bf16* dst, int D, const float* s,
                             const float* b) {
  const int lane = threadIdx.x & 31;
  float v[4];
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = lane + 32 * i;
    v[i] = d < D ? to_f(src[d]) : 0.f;
    acc += v[i];
  }
  const float mean = warp_sum(acc) / D;
  acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = lane + 32 * i;
    const float e = d < D ? v[i] - mean : 0.f;
    acc += e * e;
  }
  const float rs = rsqrtf(warp_sum(acc) / D + kLnEps);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int d = lane + 32 * i;
    if (d < D) dst[d] = __float2bfloat16((v[i] - mean) * rs * s[d] + b[d]);
  }
}

// out[r] = bf16(LN(in[r])) for r < R, one warp per row.
__device__ void ln_rows_bf16(const float* in, int ldi, bf16* out, int ldo,
                             int R, int D, const float* s, const float* b) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int r = warp; r < R; r += nw)
    ln_warp_bf16(in + (size_t)r * ldi, out + (size_t)r * ldo, D, s, b);
  __syncthreads();
}

// Bytes of shared memory of a chain block and of a map block.
inline size_t chain_bytes(int D, int A) {
  return (size_t)3 * kChainRows * D * 4 +
         ((size_t)2 * kChainRows * (D + 8) + (size_t)kChainRows * (4 * D + 8) +
          (size_t)kTileStages * D * (D + 8)) * 2 +
         (size_t)(A + kPreThreads / 32 + 1) * 4;
}
inline size_t map_bytes(int D, int P) {
  return ((size_t)kMapRows * (D + 8) + (size_t)kTileStages * D * (D + 8)) * 2 +
         (size_t)(P + kPreThreads / 32 + 1) * 4;
}

struct ChainTile {
  float *ag, *t1, *t2;
  bf16 *xa, *xb, *hh;
  int D;
};

// One zero-aggregate step of stack sublayer j on the tile's rows (the key
// chain): agg = sigmoid(to_g([0, dst_n])) * to_s(dst_n), then the residual
// and FFN epilogue; 11 tiles of the stream.
__device__ void chain_step(const SeedWeights<bf16>& w, int j, const ChainTile& c,
                           TileStream& ts) {
  const int D = c.D, tid = threadIdx.x, bd = blockDim.x, R = kChainRows;
  const int lda = D + 8, ldh = 4 * D + 8;
  float acc[kChainMT][2][4];
  ln_rows_bf16(c.ag, D, c.xa, lda, R, D, w.lnq_s + j * D, w.lnq_b + j * D);
  zero_acc(acc);
  mma_tile<kChainMT>(c.xa, lda, tile_acquire(ts), D, acc);
  tile_release(ts);
  for_acc(acc, D, w.bg + j * D, nullptr,
          [&](int r, int n, float v) { c.t1[r * D + n] = v; });
  zero_acc(acc);
  mma_tile<kChainMT>(c.xa, lda, tile_acquire(ts), D, acc);
  tile_release(ts);
  for_acc(acc, D, w.bs + j * D, nullptr,
          [&](int r, int n, float v) { c.t2[r * D + n] = v; });
  __syncthreads();
  for (int i = tid; i < R * D; i += bd)
    c.xa[(i / D) * lda + i % D] =
        __float2bfloat16(sigmoid(c.t1[i]) * c.t2[i]);
  __syncthreads();
  zero_acc(acc);
  mma_tile<kChainMT>(c.xa, lda, tile_acquire(ts), D, acc);
  tile_release(ts);
  for_acc(acc, D, w.bo + j * D, nullptr,
          [&](int r, int n, float v) { c.t1[r * D + n] = v; });
  __syncthreads();
  rows_ln<bf16, false>(c.t1, D, c.t1, D, R, D, w.post_s + j * D,
                       w.post_b + j * D);
  for (int i = tid; i < R * D; i += bd) c.ag[i] += c.t1[i];
  __syncthreads();
  ln_rows_bf16(c.ag, D, c.xa, lda, R, D, w.ffp_s + j * D, w.ffp_b + j * D);
  for (int q = 0; q < 4; ++q) {
    zero_acc(acc);
    mma_tile<kChainMT>(c.xa, lda, tile_acquire(ts), D, acc);
    tile_release(ts);
    for_acc(acc, D, w.bf0 + j * 4 * D + q * D, nullptr,
            [&](int r, int n, float v) {
              c.hh[r * ldh + q * D + n] = __float2bfloat16(fmaxf(v, 0.f));
            });
  }
  __syncthreads();
  zero_acc(acc);
  for (int q = 0; q < 4; ++q) {
    mma_tile<kChainMT>(c.hh + q * D, ldh, tile_acquire(ts), D, acc);
    tile_release(ts);
  }
  for_acc(acc, D, w.bf1 + j * D, nullptr,
          [&](int r, int n, float v) { c.t1[r * D + n] = v; });
  __syncthreads();
  rows_ln<bf16, false>(c.t1, D, c.t1, D, R, D, w.ffq_s + j * D,
                       w.ffq_b + j * D);
  for (int i = tid; i < R * D; i += bd) c.ag[i] += c.t1[i];
  __syncthreads();
}

// Agent chain tile `tile` (valid agents [32 tile, 32 tile + 32) in order):
// the key chain and every layer's K/V.
__device__ void chain_block(const PreParams& p, int tile, unsigned char* sm) {
  const int D = p.D, A = p.A, L = p.L, tid = threadIdx.x, bd = blockDim.x;
  const int R = kChainRows, lda = D + 8;
  ChainTile c;
  c.D = D;
  c.ag = reinterpret_cast<float*>(sm);
  c.t1 = c.ag + R * D;
  c.t2 = c.t1 + R * D;
  c.xa = reinterpret_cast<bf16*>(c.t2 + R * D);
  c.xb = c.xa + R * lda;
  c.hh = c.xb + R * lda;
  bf16* ring = c.hh + R * (4 * D + 8);
  int* idx = reinterpret_cast<int*>(ring + kTileStages * D * (D + 8));
  int* scan = idx + A;
  const int n_all = compact(p.mask_a, A, idx, scan);
  const int r0 = tile * R;
  if (r0 >= n_all) return;
  const int n = min(R, n_all - r0);
  const int* rows = idx + r0;
  const bf16* col = static_cast<const bf16*>(p.agent_col);
  const bf16* rsa = static_cast<const bf16*>(p.r_sa);
  TileStream ts{static_cast<const bf16*>(p.x.p[TILES]), ring, D, 0, 0,
                n_chain_tiles(L), 0};
  tile_top_up(ts);
  for (int i = tid; i < R * D; i += bd) {
    const int r = i / D;
    c.ag[i] = r < n ? to_f(col[(size_t)rows[r] * D + i % D]) : 0.f;
  }
  __syncthreads();
  const SeedWeights<bf16> w = seed_weights<bf16>(p.weights, p.vectors, L, D);
  const int warp = tid >> 5, nw = bd >> 5;
  float acc[kChainMT][2][4];
  for (int l = 0; l < L; ++l) {
    chain_step(w, 3 * l, c, ts);      // occ2sa
    chain_step(w, 3 * l + 1, c, ts);  // pt2sa
    // this layer's a2sa keys: the chain before its own zero-agg step
    ln_rows_bf16(c.ag, D, c.xa, lda, R, D, vec(p, KA_LNS_S, l),
                 vec(p, KA_LNS_B, l));
    for (int r = warp; r < n; r += nw)
      ln_warp_bf16(rsa + (size_t)rows[r] * D, c.xb + r * lda, D,
                   vec(p, SAR_LNR_S, l), vec(p, SAR_LNR_B, l));
    for (int i = tid; i < (R - n) * lda; i += bd)
      c.xb[n * lda + i] = __float2bfloat16(0.f);
    __syncthreads();
    float* Ka = p.K_a + (size_t)l * A * D;
    float* Va = p.V_a + (size_t)l * A * D;
    zero_acc(acc);
    mma_tile<kChainMT>(c.xa, lda, tile_acquire(ts), D, acc);  // to_k
    tile_release(ts);
    mma_tile<kChainMT>(c.xb, lda, tile_acquire(ts), D, acc);  // w_kr
    tile_release(ts);
    for_acc(acc, D, nullptr, nullptr, [&](int r, int m, float v) {
      if (r < n) Ka[(size_t)rows[r] * D + m] = v;
    });
    zero_acc(acc);
    mma_tile<kChainMT>(c.xa, lda, tile_acquire(ts), D, acc);  // to_v
    tile_release(ts);
    mma_tile<kChainMT>(c.xb, lda, tile_acquire(ts), D, acc);  // w_vr
    tile_release(ts);
    for_acc(acc, D, vec(p, KA_BV, l), vec(p, SAR_BVR, l),
            [&](int r, int m, float v) {
              if (r < n) Va[(size_t)rows[r] * D + m] = v;
            });
    if (l + 1 < L)  // the last layer's a2sa step is never read
      chain_step(w, 3 * l + 2, c, ts);
  }
}

// Map tile `tile` (valid map rows [64 tile, 64 tile + 64)), layer l: K/V.
__device__ void map_block(const PreParams& p, int tile, int l,
                          unsigned char* sm) {
  const int D = p.D, P = p.P, lda = D + 8, tid = threadIdx.x;
  const int warp = tid >> 5, nw = blockDim.x >> 5;
  bf16* xa = reinterpret_cast<bf16*>(sm);
  bf16* ring = xa + kMapRows * lda;
  int* idx = reinterpret_cast<int*>(ring + kTileStages * D * (D + 8));
  int* scan = idx + P;
  const int n_all = compact(p.mask_pl, P, idx, scan);
  const int r0 = tile * kMapRows;
  if (r0 >= n_all) return;
  const int n = min(kMapRows, n_all - r0);
  const int* rows = idx + r0;
  const int t0 = n_chain_tiles(p.L) + 2 * l;
  TileStream ts{static_cast<const bf16*>(p.x.p[TILES]), ring, D, t0, t0,
                t0 + 2, t0};
  tile_top_up(ts);
  const bf16* rpl = static_cast<const bf16*>(p.r_pl);
  for (int r = warp; r < n; r += nw)
    ln_warp_bf16(rpl + (size_t)rows[r] * D, xa + r * lda, D,
                 vec(p, PTR_LNR_S, l), vec(p, PTR_LNR_B, l));
  for (int i = tid; i < (kMapRows - n) * lda; i += blockDim.x)
    xa[n * lda + i] = __float2bfloat16(0.f);
  __syncthreads();
  const bf16* k0 = static_cast<const bf16*>(p.k0) + (size_t)l * P * D;
  const bf16* v0 = static_cast<const bf16*>(p.v0) + (size_t)l * P * D;
  float* K = p.K_pt + (size_t)l * P * D;
  float* V = p.V_pt + (size_t)l * P * D;
  float acc[4][2][4], base[4][2][4];
  const int nb = D / 64;
  // base[m][j][e] = k0 (then v0) of the accumulator's map row and column,
  // all read before any store so that the loads overlap
  auto load_base = [&](const bf16* src) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int r, col;
          acc_coord(m, j, e, D, r, col);
          base[m][j][e] = j < nb && r < n
                              ? to_f(src[(size_t)rows[r] * D + col]) : 0.f;
        }
  };
  load_base(k0);
  zero_acc(acc);
  mma_tile<4>(xa, lda, tile_acquire(ts), D, acc);
  tile_release(ts);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, col;
        acc_coord(m, j, e, D, r, col);
        if (j < nb && r < n)
          K[(size_t)rows[r] * D + col] = base[m][j][e] + acc[m][j][e];
      }
  load_base(v0);
  zero_acc(acc);
  mma_tile<4>(xa, lda, tile_acquire(ts), D, acc);
  tile_release(ts);
  const float* bvr = vec(p, PTR_BVR, l);
  float bb[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int r, col;
      acc_coord(0, j, e, D, r, col);
      bb[j][e] = j < nb ? __ldg(bvr + col) : 0.f;
    }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, col;
        acc_coord(m, j, e, D, r, col);
        if (j < nb && r < n)
          V[(size_t)rows[r] * D + col] =
              (base[m][j][e] + acc[m][j][e]) + bb[j][e & 1];
      }
}

// Blocks: the agent chain tiles first (the longest), then map tiles x
// layers, then one occupancy block per layer.
__global__ void __launch_bounds__(kPreThreads, 1) precompute_bf16_kernel(
    PreParams p) {
  extern __shared__ __align__(16) unsigned char smem_b[];
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  if (!pre_lane<bf16>(p, blockIdx.y)) return;
  const int b = blockIdx.x;
  if (b < p.n_agent_blocks) {
    chain_block(p, b, smem_b);
  } else if (b < p.n_agent_blocks + p.n_map_blocks) {
    const int m = b - p.n_agent_blocks;
    map_block(p, m / p.L, m % p.L, smem_b);
  } else {
    occupancy_layer<bf16>(p, b - p.n_agent_blocks - p.n_map_blocks,
                          reinterpret_cast<float*>(smem_b));
  }
}

// ---------------------------------------------------------------------------
// The stack

struct StackArgs {
  const float *sd0, *v_occ, *k_pt, *v_pt, *k_a, *v_a;
  const uint8_t *mask_pl, *mask_a;
  const void* weights;
  const float* vectors;
  float *out_small, *out_pos;
  const uint8_t* lanes;  // [B] lane mask, or null: every lane on
  int L, P, A, D, H, Hd, G;
};

// One cluster per lane: lane b's precompute results and masks, its rows of
// the outputs. A masked-off cluster zeroes its outputs and leaves before
// its first cluster barrier (and reads nothing of the precompute).
template <typename T>
__global__ void __launch_bounds__(kStackThreads, 1) stack_kernel(StackArgs a) {
  extern __shared__ __align__(16) float smem[];
  const size_t b = blockIdx.x / kCluster;
  float* out_small = a.out_small + b * 3 * kSmallCols;
  float* out_pos = a.out_pos + b * a.G;
  if (a.lanes != nullptr && !a.lanes[b]) {
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
  cluster_stack_and_heads<T, float>(
      seed_weights<T>(a.weights, a.vectors, a.L, a.D), a.sd0,
      a.v_occ + b * a.L * a.D, a.k_pt + b * lp, a.v_pt + b * lp,
      a.mask_pl + b * a.P, a.k_a + b * la, a.v_a + b * la,
      a.mask_a + b * a.A, out_small, out_pos, a.L, a.P, a.A, a.D, a.H,
      a.Hd, a.G, smem,
      [] { asm volatile("griddepcontrol.wait;\n" ::: "memory"); });
}

size_t precompute_fp32_bytes(int D, int G) {
  const size_t head = kThreads / 32 + 1;
  const size_t map = kMapTile + head + (size_t)3 * kMapTile * D;
  const size_t agent = kAgentTile + head + (size_t)10 * kAgentTile * D;
  const size_t m = (map > agent ? map : agent) * sizeof(float);
  return m > occ_layer_bytes(D, G) ? m : occ_layer_bytes(D, G);
}

size_t precompute_bf16_bytes(int D, int P, int A, int G) {
  size_t m = chain_bytes(D, A);
  m = m > map_bytes(D, P) ? m : map_bytes(D, P);
  return m > occ_layer_bytes(D, G) ? m : occ_layer_bytes(D, G);
}

template <typename T>
size_t pre_bytes(int D, int P, int A, int G) {
  return sizeof(T) == 2 ? precompute_bf16_bytes(D, P, A, G)
                        : precompute_fp32_bytes(D, G);
}

// stages: 1 the precompute, 2 the stack (reading the scratch a previous
// call filled), 3 both.
template <typename T>
int launch(PreParams& p, const float* sd0, float* out_small, float* out_pos,
           int B, int H, int Hd, int stages, cudaStream_t stream) {
  cudaError_t err;
  if (stages & 1) {
    const size_t pre = pre_bytes<T>(p.D, p.P, p.A, p.G);
    int grid;
    void (*kernel)(PreParams);
    if (sizeof(T) == 2) {
      p.n_agent_blocks = (p.A + kChainRows - 1) / kChainRows;
      p.n_map_blocks = (p.P + kMapRows - 1) / kMapRows * p.L;
      kernel = precompute_bf16_kernel;
      grid = p.n_agent_blocks + p.n_map_blocks + p.L;
    } else {
      p.n_map_blocks = (p.P + kMapTile - 1) / kMapTile;
      p.n_agent_blocks = (p.A + kAgentTile - 1) / kAgentTile;
      kernel = precompute_fp32_kernel;
      grid = p.n_map_blocks + p.n_agent_blocks + p.L;
    }
    static size_t allowed = 0;
    err = allow_smem(kernel, pre, allowed);
    if (err != cudaSuccess) return (int)err;
    kernel<<<dim3(grid, B), sizeof(T) == 2 ? kPreThreads : kThreads, pre,
             stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (stages & 2) {
    const size_t bytes = stack_bytes<T>(p.D, H, p.P, p.A);
    static size_t allowed_stack = 0;
    err = allow_smem(stack_kernel<T>, bytes, allowed_stack);
    if (err != cudaSuccess) return (int)err;
    StackArgs a{sd0,       p.v_occ,    p.K_pt,      p.V_pt, p.K_a, p.V_a,
                p.mask_pl, p.mask_a,   p.weights,   p.vectors,
                out_small, out_pos,    p.lanes,     p.L,    p.P,   p.A,
                p.D,       H,          Hd,          p.G};
    cudaLaunchAttribute attrs[2];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = kCluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[1].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster * B);
    cfg.blockDim = dim3(kStackThreads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cfg.attrs = attrs;
    cfg.numAttrs = (stages & 1) ? 2 : 1;
    err = cudaLaunchKernelEx(&cfg, stack_kernel<T>, a);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory the largest block of either kernel needs (the
// wrapper checks them against the 227 KB a block can use).
extern "C" int infgen_seed_eval_full_smem(int dtype, int L, int P, int A,
                                          int D, int H, int G) {
  (void)L;
  const size_t pre = dtype == 1 ? pre_bytes<__nv_bfloat16>(D, P, A, G)
                                : pre_bytes<float>(D, P, A, G);
  const size_t st = dtype == 1 ? stack_bytes<__nv_bfloat16>(D, H, P, A)
                               : stack_bytes<float>(D, H, P, A);
  return (int)(pre > st ? pre : st);
}

// dtype: 0 = float32, 1 = bfloat16 (k0, v0, r_pl, agent_col, r_sa and the
// packed matrices). B lanes: every input but sd0, every scratch array and
// the outputs carry a leading lane axis (B = 1: one evaluation's arrays);
// lanes [B] bytes or null (all on). full_ptrs: host array of kNumFullArgs
// device pointers (TILES: seed_kernel.py::chain_tiles for bf16, else
// null). v_occ .. v_a: fp32 scratch the first kernel writes and the second
// reads. stages: see launch. Returns a cudaError_t; 0 on successful
// launches.
extern "C" int infgen_seed_eval_full(
    int dtype, const float* sd0, const void* k0, const void* v0,
    const void* r_pl, const uint8_t* mask_pl, const void* agent_col,
    const void* r_sa, const uint8_t* mask_a, const uint8_t* occ,
    const void* weights, const float* vectors, const uint64_t* full_ptrs,
    float* v_occ, float* K_pt, float* V_pt, float* K_a, float* V_a,
    float* out_small, float* out_pos, const uint8_t* lanes, int B, int L,
    int P, int A, int D, int H, int Hd, int G, int stages, void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  PreParams p;
  p.lanes = lanes;
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
  if (dtype == 0)
    return launch<float>(p, sd0, out_small, out_pos, B, H, Hd, stages, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, sd0, out_small, out_pos, B, H, Hd,
                                 stages, s);
  return (int)cudaErrorInvalidValue;
}
