// The whole trunk column of one token step on Hopper: L layers x (temporal,
// map, agent-agent) DenseAttention forwards with relation-biased K/V, the
// gated update and the FFN, for every agent row.
//
// Replaces the TPU kernel infgen_tpu/ops/column_kernel.py::
// motion_column_kernel. On the TPU the grid runs the layers in order on one
// core with the running column in VMEM; here blocks run in parallel and
// every agent-agent sublayer reads all rows' current features as keys, a
// grid-wide dependency. So a column is 2L launches in order on one stream
// (bf16: 3L + 1, below):
// per layer a row kernel (the temporal and map sublayers, which only read
// the row's own keys, then the agent-agent sublayer's per-row prologue: its
// query and the row's shared key and value) and an agent-agent kernel
// (attention over the other rows' shared keys, biased by the pair
// relation, and the epilogue).
// The running column stays fp32 in shared memory within a launch and in
// global memory between launches; row l of the output is layer l's result.
//
// Lanes (what jax.vmap of the TPU kernel computes): a call may take B
// scenarios at once, each launch's grid gaining a second dimension, one
// lane per blockIdx.y, so a call launches as many kernels as without lanes.
// A block reads and writes its own lane's arrays, occupancy bound and
// scratch only (at_lane): agent-agent keys never cross lanes, and each
// lane computes what the call on its arrays alone computes, bit for bit.
//
// Rounding follows the TPU kernel: key and relation inputs arrive in the
// compute dtype T, the running column stays fp32 through all 3L sublayers,
// and every matmul operand is rounded to T with fp32 sums. Occupancy bound:
// rows at or above *n_rows (a device int, read here) skip their attention
// and take the zero-aggregate epilogue, which is what a row with every key
// masked gets from the full computation, so outputs are bitwise the same.
// A masked key's relation and key rows are never read: its softmax weight
// is exactly 0.
//
// Bound. At the flagship shapes (D=128, 8x16 heads, L=6, A=128, W=12, K=5)
// with every row and key live, one column in the direct form is about
// 4.6 G multiply-adds, most of them the agent-agent relation projections
// (A^2 pairs x 2 D^2 per layer), and must move about 18 MB in bf16 (r_aa
// 4.2 MB, the key stack 2.4 MB, weights about 10 MB). With the rollout's
// masks only the valid pairs count. chip_smoke.py::column_cost_least
// takes each key and relation term in its form of least time: in bf16 the
// direct form on the tensor cores (989 TFLOP/s) beats the reassociated one
// on the CUDA cores (67 TFLOP/s) for every term; in fp32 the reassociated
// relation term is cheaper.
//
// The bf16 path (the latency preset's). Operands rounded to bf16 with fp32
// sums are what mma.sync m16n8k16 computes, so every product runs on the
// tensor cores, and a block owns a tile of kCR = 16 agent rows (one m16
// tile; D = 128 fits whole rows, so LayerNorms stay row-local).
//   - Pair terms: the direct form, for every sublayer. At bf16 it is the
//     form of least time for every key and relation term
//     (column_cost_least picks it on the smoke's inputs), and it keeps the
//     plain version's operand rounding as it is: the
//     reassociated value side would need fp32 left operands (sum p LN(r)),
//     which the bf16 mma cannot take. A pair's key and value projections
//     (LN(key) w_k + LN(r) w_kr, LN(key) w_v + LN(r) w_vr + b_v + b_vr; the
//     agent-agent sublayer's relation part only) depend on the inputs
//     alone, not on the running column, so one launch before the layers
//     (pair_kernel) computes them for every layer and sublayer: blocks of
//     16 (temporal, map) or 4 (agent-agent) query rows stage their
//     sublayer's matrices once, list their rows' valid pairs in order, and
//     each warp takes tiles of 16 pairs (LayerNorm, bf16 operand tiles,
//     [16, D] x [D, D] products per matrix), storing fp32 k and v rows in
//     the call's scratch. Spread over some 290 blocks, this is what keeps
//     the card busy: inside the 8 row-tile blocks of a layer the same
//     products ran at about 12-25 us per tile of 16 pairs and left the
//     other SMs idle (PERF.md).
//   - Row-level products (q, the agent-agent prologue's shared k / v,
//     wga, wgd, ws, wo, wf0, wf1): [16, D] x [D, D] tile products, each
//     warp owning 16 output columns. The weights arrive as [D, D] tiles of
//     W^T, pre-transposed and swizzled by column_kernel.py::column_tiles
//     (17 per sublayer), one bulk copy (TMA) per tile on an mbarrier,
//     through a ring of kSlots = 4 tiles in shared memory in the order of
//     use, so each weight read serves the tile's 16 rows.
//   - Attention: a warp reads a query row's valid pairs' k and v rows
//     (adding the key row's shared k / v for the agent-agent sublayer),
//     eight keys at a time, scores them against q and keeps an online
//     softmax (running max and denominator per head) and the weighted
//     value sums, all fp32, each lane owning four columns of one head. The
//     temporal and map sublayers' attention runs in the row kernel, a warp
//     per row; the agent-agent one, whose rows have up to A keys, in a
//     launch of its own with eight warps per row (aa_attend_kernel, A
//     blocks), whose states are merged in a fixed order.
//   - Launches: 3L + 1: the pair kernel, then per layer the row kernel
//     (temporal, map, the agent-agent prologue), the agent-agent attention
//     (it reads every row's shared k / v, a grid-wide dependency) and the
//     agent-agent epilogue kernel.
// What sets its time (on an H100, PERF.md): the row-tile kernels'
// epilogues, about 0.6-0.9 us per [D, D] weight tile, of which the wait for
// the tile's copy is about 0.15 (a fifth ring slot, and four partial sums
// to shorten the dependent mma chains, changed nothing); then the pair
// launch.
// The fp32 path (a check path) keeps the design below, unchanged: each
// block owns one agent row, gathers its row's valid keys in ascending
// order, and projects them in tiles of kTile rows held in shared memory
// (LayerNorm, then the key / value and relation matmuls with one thread
// per output column and row group); scores and values of all valid keys
// stay in shared memory for an exact two-pass softmax; products on the
// CUDA cores in fp32, weights re-read from L2 by every block. Its per-row
// device code (query, attention, epilogue) is dense_row.cuh's.

#include "dense_row.cuh"
#include "mma_tiles.cuh"

namespace {

// per-layer hand-over from the row kernel to the agent-agent kernel
// (bf16: AGG, the agent-agent attention's aggregate, from aa_attend_kernel)
enum Scratch { XMID, DNAA, QAA, KSH, VSH, AGG };

// The arrays of a call over B lanes (one scenario each; B = 1 without a
// lane axis). A kernel's blockIdx.y is its lane: at_lane moves the pointers
// to that lane's arrays, and layer l of the key stack and of the output is
// at layer_rows(p, l) rows, past every lane's earlier layers.
struct Params {
  const float* x0;         // [B, A, D]
  const void* key_stack;   // [L, B, A, W, D] T
  const void* r_t;         // [B, A, W, D] T
  const uint8_t* t_mask;   // [B, A, W]
  const void* pl_keys;     // [B, A, K, D] T
  const void* r_pl;        // [B, A, K, D] T
  const uint8_t* pl_mask;  // [B, A, K]
  const void* r_aa;        // [B, A, A, D] T
  const uint8_t* aa_mask;  // [B, A, A]
  const int* n_rows;       // [B] or null (every row)
  const void* w[kNumArgs];
  const void* tiles;       // bf16: column_tiles [3L, 17, D, D]; fp32: null
  float* out;              // [L, B, A, D]
  float* scratch;          // [B, lane_scratch]
  size_t lane_scratch;     // fp32: 5 A D; bf16: 6 A D + L pair_layer
  int L, B, A, W, K, D, H, Hd, nmax;
};

__device__ __forceinline__ Sub sub(const Params& p, int j) {
  return Sub{p.w, j, p.D, p.H, p.Hd};
}

// Lane b's view of the call: its own rows, keys, masks, bound and scratch.
template <typename T>
__device__ __forceinline__ Params at_lane(Params p, int b) {
  const size_t A = p.A, AD = A * p.D;
  p.x0 += b * AD;
  p.key_stack = static_cast<const T*>(p.key_stack) + b * AD * p.W;
  p.r_t = static_cast<const T*>(p.r_t) + b * AD * p.W;
  p.t_mask += b * A * p.W;
  p.pl_keys = static_cast<const T*>(p.pl_keys) + b * AD * p.K;
  p.r_pl = static_cast<const T*>(p.r_pl) + b * AD * p.K;
  p.pl_mask += b * A * p.K;
  p.r_aa = static_cast<const T*>(p.r_aa) + b * AD * A;
  p.aa_mask += b * A * A;
  if (p.n_rows) p.n_rows += b;
  p.out += b * AD;
  p.scratch += b * p.lane_scratch;
  return p;
}

// Rows before layer l in the key stack and the output: l B A.
__device__ __forceinline__ size_t layer_rows(const Params& p, int l) {
  return (size_t)l * p.B * p.A;
}

__device__ __forceinline__ bool live_row(const Params& p, int a) {
  return a < (p.n_rows ? *p.n_rows : p.A);
}

// Layer l, row blockIdx.x: the temporal and map sublayers, then the
// agent-agent sublayer's prologue, handed over through `scratch`.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) row_kernel(Params p0, int l) {
  extern __shared__ float smem[];
  const Params p = at_lane<T>(p0, blockIdx.y);
  const Smem s = carve(smem, p.D, p.H, p.nmax);
  const int a = blockIdx.x, A = p.A, D = p.D, tid = threadIdx.x;
  const int bd = blockDim.x;
  const bool live = live_row(p, a);
  const float* x_in = l == 0 ? p.x0 + (size_t)a * D
                             : p.out + (layer_rows(p, l - 1) + a) * D;
  for (int i = tid; i < D; i += bd) s.x[i] = x_in[i];
  __syncthreads();

  // temporal: the row's own W-column key window
  Sub u = sub(p, 3 * l);
  row_query<T>(u, s);
  if (live)
    row_attend<T, T>(u,
                     static_cast<const T*>(p.key_stack) +
                         (layer_rows(p, l) + a) * p.W * D,
                     static_cast<const T*>(p.r_t) + (size_t)a * p.W * D,
                     p.t_mask + (size_t)a * p.W, p.W, nullptr, nullptr, s);
  else
    zero(s.agg, D);
  row_epilogue<T>(u, s);

  // map: the row's K nearest map tokens
  u = sub(p, 3 * l + 1);
  row_query<T>(u, s);
  if (live)
    row_attend<T, T>(u,
                     static_cast<const T*>(p.pl_keys) + (size_t)a * p.K * D,
                     static_cast<const T*>(p.r_pl) + (size_t)a * p.K * D,
                     p.pl_mask + (size_t)a * p.K, p.K, nullptr, nullptr, s);
  else
    zero(s.agg, D);
  row_epilogue<T>(u, s);

  // agent-agent prologue: the query, and this row as a key
  u = sub(p, 3 * l + 2);
  row_query<T>(u, s);
  row_kv<T>(u, s);
  float* sc = p.scratch + (size_t)a * D;
  const size_t AD = (size_t)A * D;
  for (int i = tid; i < D; i += bd) {
    sc[XMID * AD + i] = s.x[i];
    sc[DNAA * AD + i] = s.dnr[i];
    sc[QAA * AD + i] = s.q[i];
    sc[KSH * AD + i] = s.t2[i];
    sc[VSH * AD + i] = s.t3[i];
  }
}

// Layer l, row blockIdx.x: attention over the other rows' shared keys with
// the pair relations, the epilogue, and the layer's output row.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) aa_kernel(Params p0, int l) {
  extern __shared__ float smem[];
  const Params p = at_lane<T>(p0, blockIdx.y);
  const Smem s = carve(smem, p.D, p.H, p.nmax);
  const int a = blockIdx.x, A = p.A, D = p.D, tid = threadIdx.x;
  const int bd = blockDim.x;
  const Sub u = sub(p, 3 * l + 2);
  const size_t AD = (size_t)A * D;
  const float* sc = p.scratch + (size_t)a * D;
  for (int i = tid; i < D; i += bd) {
    s.x[i] = sc[XMID * AD + i];
    s.dnr[i] = sc[DNAA * AD + i];
    s.q[i] = sc[QAA * AD + i];
  }
  __syncthreads();
  if (live_row(p, a))
    row_attend<T, T>(u, nullptr,
                     static_cast<const T*>(p.r_aa) + (size_t)a * A * D,
                     p.aa_mask + (size_t)a * A, A, p.scratch + KSH * AD,
                     p.scratch + VSH * AD, s);
  else
    zero(s.agg, D);
  row_epilogue<T>(u, s);
  float* out = p.out + (layer_rows(p, l) + a) * D;
  for (int i = tid; i < D; i += bd) out[i] = s.x[i];
}

template <typename T>
int launch(Params& p, cudaStream_t stream) {
  p.nmax = max(p.A, max(p.W, p.K));
  const size_t bytes = smem_floats(p.D, p.H, p.nmax) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      row_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      aa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.A, p.B);
  for (int l = 0; l < p.L; ++l) {
    row_kernel<T><<<grid, kThreads, bytes, stream>>>(p, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    aa_kernel<T><<<grid, kThreads, bytes, stream>>>(p, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The bf16 path: the pair projections of every layer on the tensor cores,
// then tiles of kCR agent rows.

constexpr int kCD = 128;              // D
constexpr int kCHd = 16;              // head_dim
constexpr int kCH = kCD / kCHd;       // heads
constexpr int kCR = 16;               // agent rows per block: one m16 tile
constexpr int kCThreads = 256;        // 8 warps, 16 output columns each
constexpr int kCWarps = kCThreads / 32;
constexpr int kSlots = 4;             // weight tiles staged or in flight
constexpr int kTileElems = kCD * kCD;
constexpr int kTileBytes = kTileElems * 2;
constexpr int kRowF = kCR * kCD;      // elements of a [kCR, D] row tile
constexpr int kMaxKeys = 256;         // keys per query (uint8 indices)
constexpr int kAaRows = 4;            // query rows per agent-agent pair block

// The [D, D] tiles of W^T of one sublayer, in column_kernel.py::
// column_tiles's order (wf0 by blocks of D output columns, wf1 by blocks of
// D input rows).
enum Tile { T_Q, T_K, T_KR, T_V, T_VR, T_GA, T_GD, T_S, T_O, T_F0,
            T_F1 = T_F0 + 4, kSubTiles = T_F1 + 4 };
// Tiles a row kernel streams (per sublayer q and the epilogue's twelve,
// for the temporal and map sublayers; then the agent-agent prologue's q,
// k, v) and an agent-agent kernel (the epilogue's).
constexpr int kEpiTiles = kSubTiles - T_GA;
constexpr int kRowSeq = 2 * (1 + kEpiTiles) + 3;
constexpr int kAaSeq = kEpiTiles;

// Shared memory of a row or agent-agent block, and of a pair block, in
// bytes (col_carve and pair_kernel lay them out).
constexpr size_t kEpiBytes = kRowF * 2 + 4 * kRowF * 2 + kRowF * 4;
constexpr size_t kColSmem = (size_t)kSlots * kTileBytes + 3 * kRowF * 4 +
                            kRowF * 2 + kEpiBytes + kCWarps * kMaxKeys;
constexpr size_t kPairSmem = (size_t)4 * kTileBytes +
                             (size_t)kCWarps * 2 * kRowF * 2 +
                             (size_t)kCR * kMaxKeys;

// Element (row, k) of a swizzled [rows, D] bf16 tile: 16-byte chunk k / 8
// of a row sits at chunk (k / 8) ^ (row % 8), so the eight rows a fragment
// load touches hit distinct banks.
__device__ __forceinline__ int swz(int row, int k) {
  return row * kCD + (((k >> 3) ^ (row & 7)) << 3) + (k & 7);
}

// acc[j] += A W for the n8 column blocks n0 + 8 j (j < NJ, n0 a multiple
// of 8): A a swizzled [16, D] bf16 row tile, Wt the swizzled tile of W^T.
template <int NJ>
__device__ __forceinline__ void mma_sw(const bf16* A, const bf16* Wt, int n0,
                                       float (&acc)[NJ][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* a_lo = A + g * kCD + 2 * t;
  const bf16* a_hi = a_lo + 8 * kCD;
  const bf16* bp = Wt + (n0 + g) * kCD + 2 * t;
#pragma unroll
  for (int c = 0; c < kCD / 8; c += 2) {
    const int o0 = (c ^ g) << 3, o1 = ((c + 1) ^ g) << 3;
    const uint32_t a[4] = {ld32(a_lo + o0), ld32(a_hi + o0), ld32(a_lo + o1),
                           ld32(a_hi + o1)};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const bf16* b = bp + j * 8 * kCD;
      mma_bf16(acc[j], a, ld32(b + o0), ld32(b + o1));
    }
  }
}

// The row products: acc += A W for this warp's 16 output columns.
__device__ __forceinline__ void mma_rows(const bf16* A, const bf16* Wt,
                                         float (&acc)[2][4]) {
  mma_sw<2>(A, Wt, 16 * (threadIdx.x >> 5), acc);
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// The tile row and column of this warp's row-product accumulator [j][e]
// (the warp owns output columns [16 warp, 16 warp + 16)).
__device__ __forceinline__ void acc_rc(int j, int e, int& row, int& col) {
  const int lane = threadIdx.x & 31;
  row = (lane >> 2) + 8 * (e >> 1);
  col = 16 * (threadIdx.x >> 5) + 8 * j + 2 * (lane & 3) + (e & 1);
}

// bias[col] of this warp's row-product accumulator [j][e & 1], read before
// its product so that the loads overlap the mma (bias may be null: 0).
struct Bias2 {
  float v[2][2];
};
__device__ __forceinline__ Bias2 bias2(const float* bias) {
  Bias2 b;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    int row, col;
    acc_rc(j, 0, row, col);
    const float2 x = bias ? *reinterpret_cast<const float2*>(bias + col)
                          : make_float2(0.f, 0.f);
    b.v[j][0] = x.x;
    b.v[j][1] = x.y;
  }
  return b;
}

// This lane's four values [4 lane, 4 lane + 4) of a D-row: LayerNorm over
// the warp (two-pass fp32 statistics), then * s + b.
__device__ __forceinline__ void ln4(float (&v)[4], const float* s,
                                    const float* b) {
  const int c = 4 * (threadIdx.x & 31);
  const float4 s4 = *reinterpret_cast<const float4*>(s + c);
  const float4 b4 = *reinterpret_cast<const float4*>(b + c);
  const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, bv[4] = {b4.x, b4.y, b4.z,
                                                         b4.w};
  float acc = (v[0] + v[1]) + (v[2] + v[3]);
  const float mean = warp_sum(acc) / kCD;
  acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float d = v[i] - mean;
    acc += d * d;
  }
  const float rs = rsqrtf(warp_sum(acc) / kCD + kLnEps);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = (v[i] - mean) * rs * sv[i] + bv[i];
}

__device__ __forceinline__ void load4(const float* row, float (&v)[4]) {
  const float4 x =
      *reinterpret_cast<const float4*>(row + 4 * (threadIdx.x & 31));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void unpack4(uint2 u, float (&v)[4]) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

// Row `row` of a swizzled bf16 tile, this lane's four values, rounded.
__device__ __forceinline__ void store4(bf16* tile, int row,
                                       const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(tile + swz(row, 4 * (threadIdx.x & 31))) = u;
}

__device__ int live_rows(const Params& p) {
  return p.n_rows ? min(*p.n_rows, p.A) : p.A;
}

// idx[0..n) = the keys k < N with mask[k], in ascending order, by one
// warp; returns n.
__device__ int warp_compact(const uint8_t* mask, int N, uint8_t* idx) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int c0 = 0; c0 < N; c0 += 32) {
    const bool on = c0 + lane < N && mask[c0 + lane] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    if (on) idx[n + __popc(bal & ((1u << lane) - 1u))] = (uint8_t)(c0 + lane);
    n += __popc(bal);
  }
  __syncwarp();
  return n;
}

// The pair projections, in scratch after its six [A, D] rows: at
// l * pair_layer + the sublayer's offset (pair_rows_of) they hold, per
// query row a and its i-th valid key, k = [i][0] and v = [i][1] (fp32
// [D] each) of sublayer 3l + kind: LN(key) w_k + LN(r) w_kr and
// LN(key) w_v + LN(r) w_vr + b_v + b_vr for the temporal (kind 0) and map
// (1) sublayers, LN(r) w_kr and LN(r) w_vr + b_vr for the agent-agent (2)
// one, whose key rows add their shared k / v later.
__host__ __device__ inline size_t pair_layer(int A, int W, int K) {
  return (size_t)A * (W + K + A) * 2 * kCD;
}
__device__ float* pair_rows_of(const Params& p, int l, int kind, int a) {
  const int N = kind == 0 ? p.W : kind == 1 ? p.K : p.A;
  const size_t off = kind == 0 ? 0
                     : kind == 1 ? (size_t)p.A * p.W
                                 : (size_t)p.A * (p.W + p.K);
  return p.scratch + (size_t)6 * p.A * kCD + l * pair_layer(p.A, p.W, p.K) +
         (off + (size_t)a * N) * 2 * kCD;
}

// Row `row` of a swizzled bf16 tile from 64 bf16 values per lane (half
// `half` of the row; the pair's other lane, lane ^ 1, holds the other
// half): LayerNorm with two-pass fp32 statistics, * s + b, rounded; zeros
// where `on` is false (the pair's lanes agree on it).
__device__ __forceinline__ void ln_half(const uint4 (&raw)[8], bool on,
                                        const float* s, const float* b,
                                        bf16* tile, int row, int half) {
  float v[64];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw[c]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[8 * c + 2 * e] = on ? __low2float(h2[e]) : 0.f;
      v[8 * c + 2 * e + 1] = on ? __high2float(h2[e]) : 0.f;
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc += v[i];
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  const float mean = acc / kCD;
  acc = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float d = v[i] - mean;
    acc += d * d;
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  const float rs = rsqrtf(acc / kCD + kLnEps);
  const float* sh = s + 64 * half;
  const float* bh = b + 64 * half;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 8 * c + 2 * e;
      const float x0 = on ? (v[k] - mean) * rs * sh[k] + bh[k] : 0.f;
      const float x1 = on ? (v[k + 1] - mean) * rs * sh[k + 1] + bh[k + 1]
                          : 0.f;
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      w[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(tile + swz(row, 64 * half + 8 * c)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Blocks of the pair kernel per layer: temporal and map blocks of kCR
// query rows, agent-agent blocks of kAaRows.
__host__ __device__ inline int pair_blocks(int A) {
  return 2 * ((A + kCR - 1) / kCR) + (A + kAaRows - 1) / kAaRows;
}

// Block b: layer l, sublayer kind, query rows [a0, a0 + R). Stages the
// sublayer's key and relation matrices (one bulk copy each), lists the
// valid (row, key) pairs of its live rows in order, and gives each warp
// tiles of 16 pairs: LayerNorm, rounded to bf16 into the warp's operand
// tiles, [16, D] x [D, D] products, fp32 rows stored.
__global__ void __launch_bounds__(kCThreads, 1) pair_kernel(Params p0) {
  extern __shared__ __align__(128) unsigned char smem_c[];
  const Params p = at_lane<bf16>(p0, blockIdx.y);
  __shared__ uint64_t bar;
  __shared__ int offs[kCR + 1];
  const int A = p.A, nb = (A + kCR - 1) / kCR;
  const int l = blockIdx.x / pair_blocks(A), b = blockIdx.x % pair_blocks(A);
  const int kind = b < 2 * nb ? b / nb : 2;
  const int R = kind < 2 ? kCR : kAaRows;
  const int a0 = (kind < 2 ? b % nb : b - 2 * nb) * R;
  const int N = kind == 0 ? p.W : kind == 1 ? p.K : A;
  const bool keyed = kind < 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  bf16* wt = reinterpret_cast<bf16*>(smem_c);       // [4 or 2, D, D]
  bf16* sn = wt + 4 * kTileElems + (size_t)warp * 2 * kRowF;
  bf16* rn = sn + kRowF;
  uint8_t* keys = reinterpret_cast<uint8_t*>(wt + 4 * kTileElems +
                                             (size_t)kCWarps * 2 * kRowF);
  const int j = 3 * l + kind, nm = keyed ? 4 : 2;
  if (tid == 0) {
    mbar_init(&bar, 1);
    fence_barrier_init();
    const int order[4] = {T_K, T_KR, T_V, T_VR};
    mbar_expect_tx(&bar, nm * kTileBytes);
    const bf16* tiles = static_cast<const bf16*>(p.tiles);
    for (int m = 0; m < nm; ++m)
      bulk_g2s(wt + (size_t)m * kTileElems,
               tiles + ((size_t)j * kSubTiles + order[keyed ? m : 2 * m + 1]) *
                           kTileElems,
               kTileBytes, &bar);
  }
  const bf16* rel = static_cast<const bf16*>(
      kind == 0 ? p.r_t : kind == 1 ? p.r_pl : p.r_aa);
  const bf16* src = static_cast<const bf16*>(kind == 0 ? p.key_stack
                                                       : p.pl_keys);
  if (kind == 0) src += layer_rows(p, l) * p.W * kCD;
  const uint8_t* mask = kind == 0 ? p.t_mask : kind == 1 ? p.pl_mask
                                                         : p.aa_mask;
  const int nlive = live_rows(p);
  for (int rr = warp; rr < R; rr += kCWarps) {
    const int a = a0 + rr;
    const int n = a < nlive ? warp_compact(mask + (size_t)a * N, N,
                                           keys + rr * kMaxKeys)
                            : 0;
    if (lane == 0) offs[rr + 1] = n;
  }
  __syncthreads();
  if (tid == 0) {
    offs[0] = 0;
    for (int rr = 0; rr < R; ++rr) offs[rr + 1] += offs[rr];
  }
  __syncthreads();
  const int total = offs[R];
  if (total == 0) {
    if (tid == 0) mbar_wait(&bar, 0);  // no copy outlives the block
    return;
  }
  const Sub u = sub(p, j);
  const float *lr_s = vec(u, LNR_S, kCD), *lr_b = vec(u, LNR_B, kCD);
  const float *lk_s = vec(u, LNS_S, kCD), *lk_b = vec(u, LNS_B, kCD);
  const float *bv = vec(u, BV, kCD), *bvr = vec(u, BVR, kCD);
  mbar_wait(&bar, 0);
  const bf16 *wk = wt, *wkr = wt + kTileElems, *wv = wt + 2 * kTileElems,
             *wvr = wt + 3 * kTileElems;
  if (!keyed) {
    wkr = wt;
    wvr = wt + kTileElems;
  }
  // pair q of the block: its row and its index among the row's valid keys
  auto locate = [&](int q, int& rr, int& i) {
    rr = 0;
    while (rr + 1 < R && offs[rr + 1] <= q) ++rr;
    i = q - offs[rr];
  };
  for (int t0 = warp * 16; t0 < total; t0 += kCWarps * 16) {
    // two lanes per pair row, each half of it: LayerNorm, rounded to bf16
    {
      const int i = lane >> 1, half = lane & 1;
      const bool on = t0 + i < total;
      uint4 raw_r[8], raw_k[8];
      if (on) {
        int rr, ii;
        locate(t0 + i, rr, ii);
        const size_t o =
            ((size_t)(a0 + rr) * N + keys[rr * kMaxKeys + ii]) * kCD +
            64 * half;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          raw_r[c] = *reinterpret_cast<const uint4*>(rel + o + 8 * c);
          if (keyed) raw_k[c] = *reinterpret_cast<const uint4*>(src + o + 8 * c);
        }
      }
      ln_half(raw_r, on, lr_s, lr_b, rn, i, half);
      if (keyed) ln_half(raw_k, on, lk_s, lk_b, sn, i, half);
    }
    __syncwarp();
    float* dst[2] = {nullptr, nullptr};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = t0 + g + 8 * h;
      if (q < total) {
        int rr, i;
        locate(q, rr, i);
        dst[h] = pair_rows_of(p, l, kind, a0 + rr) + (size_t)i * 2 * kCD;
      }
    }
#pragma unroll 1
    for (int part = 0; part < 2; ++part) {
      float acc[16][4];
      zero(acc);
      if (keyed) mma_sw<16>(sn, part ? wv : wk, 0, acc);
      mma_sw<16>(rn, part ? wvr : wkr, 0, acc);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int c = 8 * jj + 2 * t;
        float2 bb = make_float2(0.f, 0.f);
        if (part) {
          bb = *reinterpret_cast<const float2*>(bvr + c);
          if (keyed) {
            const float2 b2 = *reinterpret_cast<const float2*>(bv + c);
            bb.x += b2.x;
            bb.y += b2.y;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (dst[h])
            *reinterpret_cast<float2*>(dst[h] + part * kCD + c) =
                make_float2(acc[jj][2 * h] + bb.x, acc[jj][2 * h + 1] + bb.y);
      }
    }
    __syncwarp();  // the operand tiles are rewritten next
  }
}

struct ColSmem {
  bf16* slot;              // [kSlots, D, D] the weight ring
  float *xs, *q, *agg;     // [kCR, D] running rows, queries, aggregates
  bf16* dn;                // [kCR, D] LN_dst(x), rounded (swizzled)
  bf16 *xa, *hh;           // [kCR, D], [4, kCR, D] epilogue operands
  float* t1;               // [kCR, D] epilogue scratch
  uint8_t* kidx;           // [kCWarps, kMaxKeys] valid keys of a row
};

__device__ ColSmem col_carve(unsigned char* p) {
  ColSmem s;
  s.slot = reinterpret_cast<bf16*>(p);
  p += (size_t)kSlots * kTileBytes;
  s.xs = reinterpret_cast<float*>(p);
  s.q = s.xs + kRowF;
  s.agg = s.q + kRowF;
  s.t1 = s.agg + kRowF;
  s.dn = reinterpret_cast<bf16*>(s.t1 + kRowF);
  s.xa = s.dn + kRowF;
  s.hh = s.xa + kRowF;
  s.kidx = reinterpret_cast<uint8_t*>(s.hh + 4 * kRowF);
  return s;
}

// The weight ring: the kernel's tiles in order of use, each one bulk copy
// by thread 0 that completes on its slot's mbarrier; a slot is refilled
// once the block released the tile in it.
struct Ring {
  const bf16* tiles;   // [3L, kSubTiles, D, D]
  bf16* slot;
  uint64_t* bar;       // [kSlots]
  int l, aa, n;        // layer; agent-agent kernel's sequence; its length
  int issued, acquired, released;
};

__device__ __forceinline__ const bf16* ring_src(const Ring& r, int i) {
  int j, t;
  if (r.aa) {
    j = 3 * r.l + 2;
    t = T_GA + i;
  } else if (i < 2 * (1 + kEpiTiles)) {
    const int k = i % (1 + kEpiTiles);
    j = 3 * r.l + i / (1 + kEpiTiles);
    t = k == 0 ? T_Q : T_GA + k - 1;
  } else {
    const int k = i - 2 * (1 + kEpiTiles);
    j = 3 * r.l + 2;
    t = k == 0 ? T_Q : k == 1 ? T_K : T_V;
  }
  return r.tiles + ((size_t)j * kSubTiles + t) * kTileElems;
}

__device__ void ring_top_up(Ring& r) {
  while (r.issued < r.released + kSlots && r.issued < r.n) {
    if (threadIdx.x == 0) {
      const int st = r.issued % kSlots;
      fence_proxy_async();
      mbar_expect_tx(r.bar + st, kTileBytes);
      bulk_g2s(r.slot + (size_t)st * kTileElems, ring_src(r, r.issued),
               kTileBytes, r.bar + st);
    }
    ++r.issued;
  }
}

__device__ const bf16* ring_acquire(Ring& r) {
  ring_top_up(r);
  const int i = r.acquired++;
  mbar_wait(r.bar + i % kSlots, (i / kSlots) & 1);
  return r.slot + (size_t)(i % kSlots) * kTileElems;
}

// Every thread is done with the n oldest acquired tiles.
__device__ void ring_release(Ring& r, int n) {
  __syncthreads();
  r.released += n;
  ring_top_up(r);
}

// dst = bf16(LayerNorm(src) * s + b) for the tile's rows, one warp per row.
__device__ void ln_rows(const float* src, bf16* dst, const float* s,
                        const float* b) {
  for (int row = threadIdx.x >> 5; row < kCR; row += kCWarps) {
    float v[4];
    load4(src + row * kCD, v);
    ln4(v, s, b);
    store4(dst, row, v);
  }
  __syncthreads();
}

// The online softmax state of one query row over some of its valid keys,
// in one warp: each lane owns four columns, so a quad holds a head.
struct AttState {
  float m, den;
  float4 acc;
};

// Folds the valid keys' batches of eight i0 = first, first + stride, ...
// (i0 < n) into st: kv the pair kernel's rows of the query ([i][0] = k,
// [i][1] = v of its i-th valid key), ksh / vsh (agent-agent: each key
// row's shared k and v, added; kidx its valid keys) or null.
__device__ void attend_part(const float* kv, const uint8_t* kidx, int n,
                            int first, int stride, const float* ksh,
                            const float* vsh, const float* q, AttState& st) {
  const int c = 4 * (threadIdx.x & 31);
  const float4 qv = *reinterpret_cast<const float4*>(q + c);
  const float scale = 1.f / sqrtf((float)kCHd);
  for (int i0 = first; i0 < n; i0 += stride) {
    float4 kk[8], vv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      kk[u] = vv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i0 + u < n) {
        const float* row = kv + (size_t)(i0 + u) * 2 * kCD + c;
        kk[u] = *reinterpret_cast<const float4*>(row);
        vv[u] = *reinterpret_cast<const float4*>(row + kCD);
        if (ksh) {
          const size_t o = (size_t)kidx[i0 + u] * kCD + c;
          const float4 a = *reinterpret_cast<const float4*>(ksh + o);
          const float4 b = *reinterpret_cast<const float4*>(vsh + o);
          kk[u] = make_float4(a.x + kk[u].x, a.y + kk[u].y, a.z + kk[u].z,
                              a.w + kk[u].w);
          vv[u] = make_float4(b.x + vv[u].x, b.y + vv[u].y, b.z + vv[u].z,
                              b.w + vv[u].w);
        }
      }
    }
    float s[8], mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float d = fmaf(kk[u].w, qv.w, fmaf(kk[u].z, qv.z,
                fmaf(kk[u].y, qv.y, kk[u].x * qv.x)));
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      s[u] = i0 + u < n ? d * scale : -INFINITY;
      mx = fmaxf(mx, s[u]);
    }
    const float mn = fmaxf(st.m, mx);
    const float al = expf(st.m - mn);  // 0 on the first keys
    st.den *= al;
    st.acc = make_float4(st.acc.x * al, st.acc.y * al, st.acc.z * al,
                         st.acc.w * al);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float pu = i0 + u < n ? expf(s[u] - mn) : 0.f;
      st.den += pu;
      st.acc = make_float4(fmaf(pu, vv[u].x, st.acc.x),
                           fmaf(pu, vv[u].y, st.acc.y),
                           fmaf(pu, vv[u].z, st.acc.z),
                           fmaf(pu, vv[u].w, st.acc.w));
    }
    st.m = mn;
  }
}

__device__ __forceinline__ void store_agg(const AttState& st, float* agg) {
  const float dd = fmaxf(st.den, 1e-30f);
  *reinterpret_cast<float4*>(agg + 4 * (threadIdx.x & 31)) = make_float4(
      st.acc.x / dd, st.acc.y / dd, st.acc.z / dd, st.acc.w / dd);
}

// agg[D] = the masked softmax attention of q over the valid keys of one
// query row (the temporal or map sublayer), by one warp. No valid key:
// agg = 0.
__device__ void warp_attend(const float* kv, const uint8_t* mask, int N,
                            const float* q, float* agg, uint8_t* kidx) {
  const int n = warp_compact(mask, N, kidx);
  AttState st{-INFINITY, 0.f, make_float4(0.f, 0.f, 0.f, 0.f)};
  attend_part(kv, kidx, n, 0, 8, nullptr, nullptr, q, st);
  store_agg(st, agg);
  __syncwarp();
}

// dn = bf16(LN_dst(x)); q = dn w_q + b_q (one tile of the ring).
__device__ void col_query(const Sub& u, const ColSmem& s, Ring& ring) {
  ln_rows(s.xs, s.dn, vec(u, LND_S, kCD), vec(u, LND_B, kCD));
  const Bias2 bq = bias2(vec(u, BQ, kCD));
  const bf16* wq = ring_acquire(ring);
  float acc[2][4];
  zero(acc);
  mma_rows(s.dn, wq, acc);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int row, col;
      acc_rc(j, e, row, col);
      s.q[row * kCD + col] = acc[j][e] + bq.v[j][e & 1];
    }
  ring_release(ring, 1);
}

// The attention of sublayer 3l + kind (temporal or map) for the tile's
// rows: warp w takes rows w and w + 8; rows at or above the occupancy
// bound, and past the tile, aggregate to zero without reading a key.
__device__ void col_pairs(const Params& p, const ColSmem& s, int l, int kind,
                          int a0, int nr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nlive = live_rows(p);
  const int N = kind == 0 ? p.W : p.K;
  const uint8_t* mask = kind == 0 ? p.t_mask : p.pl_mask;
  for (int rr = warp; rr < kCR; rr += kCWarps) {
    const int a = a0 + rr;
    if (rr < nr && a < nlive)
      warp_attend(pair_rows_of(p, l, kind, a), mask + (size_t)a * N, N,
                  s.q + rr * kCD, s.agg + rr * kCD, s.kidx + warp * kMaxKeys);
    else
      for (int c = lane; c < kCD; c += 32) s.agg[rr * kCD + c] = 0.f;
  }
  __syncthreads();
}

// Layer l, agent-agent attention of query row blockIdx.x: each of the
// eight warps folds every eighth batch of eight valid keys, their states
// merged in a fixed order; the aggregate goes to scratch AGG (rows at or
// above the occupancy bound: zero, no key read).
__global__ void __launch_bounds__(kCThreads) aa_attend_kernel(Params p0,
                                                              int l) {
  const Params p = at_lane<bf16>(p0, blockIdx.y);
  __shared__ uint8_t kidx[kMaxKeys];
  __shared__ float sm[kCWarps][32], sden[kCWarps][32];
  __shared__ float4 sacc[kCWarps][32];
  __shared__ int sn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a = blockIdx.x, A = p.A;
  const size_t AD = (size_t)A * kCD;
  if (warp == 0)
    sn = a < live_rows(p) ? warp_compact(p.aa_mask + (size_t)a * A, A, kidx)
                          : 0;
  __syncthreads();
  const int n = sn;
  AttState st{-INFINITY, 0.f, make_float4(0.f, 0.f, 0.f, 0.f)};
  if (n > 0)
    attend_part(pair_rows_of(p, l, 2, a), kidx, n, 8 * warp, 8 * kCWarps,
                p.scratch + KSH * AD, p.scratch + VSH * AD,
                p.scratch + QAA * AD + (size_t)a * kCD, st);
  sm[warp][lane] = st.m;
  sden[warp][lane] = st.den;
  sacc[warp][lane] = st.acc;
  __syncthreads();
  if (warp != 0) return;
  float* agg = p.scratch + AGG * AD + (size_t)a * kCD;
  if (n == 0) {
    *reinterpret_cast<float4*>(agg + 4 * lane) =
        make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  float M = sm[0][lane];
  for (int w = 1; w < kCWarps; ++w) M = fmaxf(M, sm[w][lane]);
  AttState out{M, 0.f, make_float4(0.f, 0.f, 0.f, 0.f)};
  for (int w = 0; w < kCWarps; ++w) {
    const float f = expf(sm[w][lane] - M);  // 0 for a warp without keys
    const float4 x = sacc[w][lane];
    out.den = fmaf(sden[w][lane], f, out.den);
    out.acc = make_float4(fmaf(x.x, f, out.acc.x), fmaf(x.y, f, out.acc.y),
                          fmaf(x.z, f, out.acc.z), fmaf(x.w, f, out.acc.w));
  }
  store_agg(out, agg);
}

// The gated update and FFN of sublayer u for the tile's rows:
// g = sigmoid((agg wga + dn wgd) + bg); agg += g (dn ws + bs - agg);
// x += postnorm(agg wo + bo); x += ff_postnorm(ff_1(relu(ff_0(ff_prenorm(x))))).
__device__ void col_epilogue(const Sub& u, const ColSmem& s, Ring& ring) {
  bf16 *xa = s.xa, *hh = s.hh;
  float* t1 = s.t1;
  for (int i = threadIdx.x; i < kRowF; i += blockDim.x)
    xa[swz(i / kCD, i % kCD)] = __float2bfloat16(s.agg[i]);
  __syncthreads();
  const Bias2 bg = bias2(vec(u, BG, kCD)), bs = bias2(vec(u, BS, kCD));
  const bf16* wga = ring_acquire(ring);
  const bf16* wgd = ring_acquire(ring);
  const bf16* ws = ring_acquire(ring);
  float a1[2][4], a3[2][4];
  zero(a1);
  zero(a3);
  mma_rows(xa, wga, a1);
  mma_rows(s.dn, wgd, a1);
  mma_rows(s.dn, ws, a3);
  ring_release(ring, 3);  // every warp has read xa
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int row, col;
      acc_rc(j, e, row, col);
      const float g = sigmoid(a1[j][e] + bg.v[j][e & 1]);
      const float ag = s.agg[row * kCD + col];
      xa[swz(row, col)] =
          __float2bfloat16(ag + g * ((a3[j][e] + bs.v[j][e & 1]) - ag));
    }
  __syncthreads();
  const Bias2 bo = bias2(vec(u, BO, kCD));
  const bf16* wo = ring_acquire(ring);
  zero(a1);
  mma_rows(xa, wo, a1);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int row, col;
      acc_rc(j, e, row, col);
      t1[row * kCD + col] = a1[j][e] + bo.v[j][e & 1];
    }
  ring_release(ring, 1);
  // x += postnorm(t1); xa = bf16(ff_prenorm(x))
  for (int row = threadIdx.x >> 5; row < kCR; row += kCWarps) {
    float v[4], x[4];
    load4(t1 + row * kCD, v);
    ln4(v, vec(u, POST_S, kCD), vec(u, POST_B, kCD));
    load4(s.xs + row * kCD, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] += v[i];
    *reinterpret_cast<float4*>(s.xs + row * kCD + 4 * (threadIdx.x & 31)) =
        make_float4(x[0], x[1], x[2], x[3]);
    ln4(x, vec(u, FFP_S, kCD), vec(u, FFP_B, kCD));
    store4(xa, row, x);
  }
  __syncthreads();
  const float* bf0 = vec(u, BF0, 4 * kCD);
  for (int qd = 0; qd < 4; ++qd) {
    const Bias2 b0 = bias2(bf0 + qd * kCD);
    const bf16* w0 = ring_acquire(ring);
    zero(a1);
    mma_rows(xa, w0, a1);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int row, col;
        acc_rc(j, e, row, col);
        hh[qd * kRowF + swz(row, col)] =
            __float2bfloat16(fmaxf(a1[j][e] + b0.v[j][e & 1], 0.f));
      }
    ring_release(ring, 1);
  }
  const Bias2 b1 = bias2(vec(u, BF1, kCD));
  zero(a1);
  for (int qd = 0; qd < 4; ++qd) {
    mma_rows(hh + qd * kRowF, ring_acquire(ring), a1);
    ring_release(ring, 1);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int row, col;
      acc_rc(j, e, row, col);
      t1[row * kCD + col] = a1[j][e] + b1.v[j][e & 1];
    }
  __syncthreads();
  for (int row = threadIdx.x >> 5; row < kCR; row += kCWarps) {
    float v[4], x[4];
    load4(t1 + row * kCD, v);
    ln4(v, vec(u, FFQ_S, kCD), vec(u, FFQ_B, kCD));
    load4(s.xs + row * kCD, x);
    *reinterpret_cast<float4*>(s.xs + row * kCD + 4 * (threadIdx.x & 31)) =
        make_float4(x[0] + v[0], x[1] + v[1], x[2] + v[2], x[3] + v[3]);
  }
  __syncthreads();
}

// Layer l, rows [16 blockIdx.x, +16): the temporal and map sublayers, then
// the agent-agent sublayer's prologue, handed over through `scratch`.
__global__ void __launch_bounds__(kCThreads, 1) row_kernel_bf16(Params p0,
                                                                int l) {
  extern __shared__ __align__(128) unsigned char smem_c[];
  const Params p = at_lane<bf16>(p0, blockIdx.y);
  __shared__ uint64_t bars[kSlots];
  const ColSmem s = col_carve(smem_c);
  const int A = p.A, a0 = blockIdx.x * kCR, nr = min(kCR, A - a0);
  const int tid = threadIdx.x, bd = blockDim.x;
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) mbar_init(bars + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  Ring ring{static_cast<const bf16*>(p.tiles), s.slot, bars, l, 0, kRowSeq,
            0, 0, 0};
  ring_top_up(ring);
  const float* x_in = l == 0 ? p.x0 : p.out + layer_rows(p, l - 1) * kCD;
  for (int i = tid; i < kRowF; i += bd)
    s.xs[i] = i / kCD < nr ? x_in[(size_t)a0 * kCD + i] : 0.f;
  __syncthreads();
  for (int kind = 0; kind < 2; ++kind) {
    const Sub u = sub(p, 3 * l + kind);
    col_query(u, s, ring);
    col_pairs(p, s, l, kind, a0, nr);
    col_epilogue(u, s, ring);
  }
  // agent-agent prologue: the query, and each row as a key: k = sk w_k,
  // v = sk w_v + b_v with sk = bf16(LN_src(x))
  const Sub u = sub(p, 3 * l + 2);
  col_query(u, s, ring);
  ln_rows(s.xs, s.xa, vec(u, LNS_S, kCD), vec(u, LNS_B, kCD));
  const size_t AD = (size_t)A * kCD;
  float* sc = p.scratch + (size_t)a0 * kCD;
  const Bias2 bvv = bias2(vec(u, BV, kCD));
  for (int m = 0; m < 2; ++m) {
    const bf16* w = ring_acquire(ring);
    float acc[2][4];
    zero(acc);
    mma_rows(s.xa, w, acc);
    float* dst = sc + (m == 0 ? KSH : VSH) * AD;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int row, col;
        acc_rc(j, e, row, col);
        if (row < nr)
          dst[row * kCD + col] =
              m == 0 ? acc[j][e] : acc[j][e] + bvv.v[j][e & 1];
      }
    ring_release(ring, 1);
  }
  for (int i = tid; i < nr * kCD; i += bd) {
    sc[XMID * AD + i] = s.xs[i];
    sc[DNAA * AD + i] = __bfloat162float(s.dn[swz(i / kCD, i % kCD)]);
    sc[QAA * AD + i] = s.q[i];
  }
}

// Layer l, rows [16 blockIdx.x, +16): the agent-agent sublayer's epilogue
// on aa_attend_kernel's aggregates, and the layer's rows.
__global__ void __launch_bounds__(kCThreads, 1) aa_kernel_bf16(Params p0,
                                                               int l) {
  extern __shared__ __align__(128) unsigned char smem_c[];
  const Params p = at_lane<bf16>(p0, blockIdx.y);
  __shared__ uint64_t bars[kSlots];
  const ColSmem s = col_carve(smem_c);
  const int A = p.A, a0 = blockIdx.x * kCR, nr = min(kCR, A - a0);
  const int tid = threadIdx.x, bd = blockDim.x;
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) mbar_init(bars + i, 1);
    fence_barrier_init();
  }
  __syncthreads();
  Ring ring{static_cast<const bf16*>(p.tiles), s.slot, bars, l, 1, kAaSeq,
            0, 0, 0};
  ring_top_up(ring);
  const size_t AD = (size_t)A * kCD;
  const float* sc = p.scratch + (size_t)a0 * kCD;
  for (int i = tid; i < kRowF; i += bd) {
    const bool in = i / kCD < nr;
    s.xs[i] = in ? sc[XMID * AD + i] : 0.f;
    s.agg[i] = in ? sc[AGG * AD + i] : 0.f;
    s.dn[swz(i / kCD, i % kCD)] =
        __float2bfloat16(in ? sc[DNAA * AD + i] : 0.f);
  }
  __syncthreads();
  col_epilogue(sub(p, 3 * l + 2), s, ring);
  float* out = p.out + (layer_rows(p, l) + a0) * kCD;
  for (int i = tid; i < nr * kCD; i += bd) out[i] = s.xs[i];
}

int launch_bf16(Params& p, cudaStream_t stream) {
  if (p.D != kCD || p.Hd != kCHd || p.H != kCH || !p.tiles ||
      max(p.A, max(p.W, p.K)) > kMaxKeys)
    return (int)cudaErrorInvalidValue;
  static size_t done_p = 0, done_r = 0, done_a = 0;
  cudaError_t err = allow_smem(pair_kernel, kPairSmem, done_p);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(row_kernel_bf16, kColSmem, done_r);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(aa_kernel_bf16, kColSmem, done_a);
  if (err != cudaSuccess) return (int)err;
  pair_kernel<<<dim3(p.L * pair_blocks(p.A), p.B), kCThreads, kPairSmem,
                stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.A + kCR - 1) / kCR, p.B);
  for (int l = 0; l < p.L; ++l) {
    row_kernel_bf16<<<grid, kCThreads, kColSmem, stream>>>(p, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    aa_attend_kernel<<<dim3(p.A, p.B), kCThreads, 0, stream>>>(p, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    aa_kernel_bf16<<<grid, kCThreads, kColSmem, stream>>>(p, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (keys, relations and packed matrices;
// D = 128 with 8 heads of 16, column_kernel.py::kernel_accepts). ptrs: host
// array of kNumArgs device pointers. tiles: bf16, the pack's column_tiles
// (null for fp32). Over B lanes (Params): n_rows a device int per lane or
// null; scratch fp32, column_kernel.py::scratch_floats per lane. The width
// limits hold per lane. Returns a cudaError_t; 0 on successful launches.
extern "C" int infgen_motion_column_lanes(
    int dtype, const float* x0, const void* key_stack, const void* r_t,
    const uint8_t* t_mask, const void* pl_keys, const void* r_pl,
    const uint8_t* pl_mask, const void* r_aa, const uint8_t* aa_mask,
    const int* n_rows, const uint64_t* ptrs, const void* tiles, float* out,
    float* scratch, int L, int A, int W, int K, int D, int H, int Hd, int B,
    void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.x0 = x0;
  p.key_stack = key_stack;
  p.r_t = r_t;
  p.t_mask = t_mask;
  p.pl_keys = pl_keys;
  p.r_pl = r_pl;
  p.pl_mask = pl_mask;
  p.r_aa = r_aa;
  p.aa_mask = aa_mask;
  p.n_rows = n_rows;
  for (int i = 0; i < kNumArgs; ++i)
    p.w[i] = reinterpret_cast<const void*>(ptrs[i]);
  p.tiles = tiles;
  p.out = out;
  p.scratch = scratch;
  p.L = L;
  p.B = B;
  p.A = A;
  p.W = W;
  p.K = K;
  p.D = D;
  p.H = H;
  p.Hd = Hd;
  p.lane_scratch = dtype == 1
                       ? (size_t)6 * A * D + (size_t)L * pair_layer(A, W, K)
                       : (size_t)5 * A * D;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch_bf16(p, s);
  return (int)cudaErrorInvalidValue;
}

// The call without a lane axis (one lane; n_rows [1] or null).
extern "C" int infgen_motion_column(
    int dtype, const float* x0, const void* key_stack, const void* r_t,
    const uint8_t* t_mask, const void* pl_keys, const void* r_pl,
    const uint8_t* pl_mask, const void* r_aa, const uint8_t* aa_mask,
    const int* n_rows, const uint64_t* ptrs, const void* tiles, float* out,
    float* scratch, int L, int A, int W, int K, int D, int H, int Hd,
    void* stream) {
  return infgen_motion_column_lanes(dtype, x0, key_stack, r_t, t_mask,
                                    pl_keys, r_pl, pl_mask, r_aa, aa_mask,
                                    n_rows, ptrs, tiles, out, scratch, L, A,
                                    W, K, D, H, Hd, 1, stream);
}
