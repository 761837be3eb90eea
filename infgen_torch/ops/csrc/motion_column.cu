// The whole trunk column of one token step on Hopper: L layers x (temporal,
// map, agent-agent) DenseAttention forwards with relation-biased K/V, the
// gated update and the FFN, for every agent row.
//
// Replaces the TPU kernel infgen_tpu/ops/column_kernel.py::
// motion_column_kernel. On the TPU the grid runs the layers in order on one
// core with the running column in VMEM; here blocks run in parallel and
// every agent-agent sublayer reads all rows' current features as keys, a
// grid-wide dependency. So a column is 2L launches in order on one stream:
// per layer a row kernel (one block per agent row: the temporal and map
// sublayers, which only read the row's own keys, then the agent-agent
// sublayer's per-row prologue: its query and the row's shared key and
// value) and an agent-agent kernel (one block per row: attention over the
// other rows' shared keys, biased by the pair relation, and the epilogue).
// The running column stays fp32 in shared memory within a launch and in
// global memory between launches; row l of the output is layer l's result.
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
// with every row and key live, one column is about 4.6 G multiply-adds,
// most of them the agent-agent relation projections (A^2 pairs x 2 D^2 per
// layer), and must move about 18 MB in bf16 (r_aa 4.2 MB, the key stack
// 2.4 MB, weights about 10 MB): 9 us of bf16 tensor-core arithmetic against
// 5 us of HBM traffic, so operations bound it. With the rollout's masks only
// the valid pairs count, and both figures shrink with the occupancy.
//
// Design, and what it leaves on the table. Each block gathers its row's
// valid keys in ascending order, and projects them in tiles of kTile rows
// held in shared memory (LayerNorm, then the key / value and relation
// matmuls with one thread per output column and row group, so each weight
// read from L2 serves several keys); scores and values of all valid keys
// stay in shared memory for an exact two-pass softmax. Products run on the
// CUDA cores in fp32, not the tensor cores, and each block re-reads the
// layer's weights from L2: wgmma tiles over pairs and a persistent
// cooperative grid are the work of a later change.

#include "common.cuh"

namespace {

// The packed arrays, in the order of the pointer array that
// column_kernel.py::_layouts lays out (sublayer j = 3l + kind).
enum Arg {
  WQ, WK, WV, WKR, WVR, WGA, WGD, WS, WO, WF0, WF1,
  LND_S, LND_B, LNS_S, LNS_B, LNR_S, LNR_B, BQ, BV, BVR, BG, BS, BO, POST_S,
  POST_B, FFP_S, FFP_B, BF0, BF1, FFQ_S, FFQ_B,
  kNumArgs
};

// per-layer hand-over from the row kernel to the agent-agent kernel
enum Scratch { XMID, DNAA, QAA, KSH, VSH };

constexpr int kTile = 16;  // keys projected per pass

struct Params {
  const float* x0;         // [A, D]
  const void* key_stack;   // [L, A, W, D] T
  const void* r_t;         // [A, W, D] T
  const uint8_t* t_mask;   // [A, W]
  const void* pl_keys;     // [A, K, D] T
  const void* r_pl;        // [A, K, D] T
  const uint8_t* pl_mask;  // [A, K]
  const void* r_aa;        // [A, A, D] T
  const uint8_t* aa_mask;  // [A, A]
  const int* n_rows;       // [1] or null (every row)
  const void* w[kNumArgs];
  float* out;              // [L, A, D]
  float* scratch;          // [5, A, D]
  int L, A, W, K, D, H, Hd, nmax;
};

struct Smem {
  float *x, *dnr, *q, *agg, *t1, *t2, *t3, *h, *xr, *part, *red, *den, *sc,
      *vall, *sn, *rn, *kt;
  int *idx, *scan;
};

size_t smem_floats(int D, int H, int nmax) {
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

template <typename T>
__device__ __forceinline__ const T* mat(const Params& p, Arg a, int j,
                                        size_t per) {
  return static_cast<const T*>(p.w[a]) + (size_t)j * per;
}

__device__ __forceinline__ const float* vec(const Params& p, Arg a, int j,
                                            int per) {
  return static_cast<const float*>(p.w[a]) + (size_t)j * per;
}

__device__ __forceinline__ bool live_row(const Params& p, int a) {
  return a < (p.n_rows ? *p.n_rows : p.A);
}

// agg = masked-softmax attention of q over the N keys of sublayer j: key
// row k is LN(keys[k]) projected by to_k / to_v (or, with keys null, the
// shared ksh[k] / vsh[k] of the agent-agent sublayer), plus the relation
// terms LN(rel[k]) w_kr and LN(rel[k]) w_vr + b_vr. Only keys with
// mask[k] are read; no valid key gives agg = 0.
template <typename T>
__device__ void attend_row(const Params& p, int j, const T* keys,
                           const T* rel, const uint8_t* mask, int N,
                           const float* ksh, const float* vsh, const Smem& s) {
  const int D = p.D, H = p.H, Hd = p.Hd, tid = threadIdx.x, bd = blockDim.x;
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
    rows_ln<T, true>(s.rn, D, s.rn, D, m, D, vec(p, LNR_S, j, D),
                     vec(p, LNR_B, j, D));
    rows_mm<T>(s.rn, D, m, D, mat<T>(p, WKR, j, DD), D, nullptr, s.kt, D,
               false);
    rows_mm<T>(s.rn, D, m, D, mat<T>(p, WVR, j, DD), D, vec(p, BVR, j, D), vt,
               D, false);
    if (keys) {
      // k = LN(key) wk + kr; v = (LN(key) wv + bv) + vr
      rows_ln<T, true>(s.sn, D, s.sn, D, m, D, vec(p, LNS_S, j, D),
                       vec(p, LNS_B, j, D));
      rows_mm<T>(s.sn, D, m, D, mat<T>(p, WK, j, DD), D, nullptr, s.kt, D,
                 true);
      rows_mm<T>(s.sn, D, m, D, mat<T>(p, WV, j, DD), D, vec(p, BV, j, D),
                 vt, D, true);
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

// The query side of sublayer j for this block's row: dnr = LN(x) rounded,
// q = dnr wq + bq.
template <typename T>
__device__ void query(const Params& p, int j, const Smem& s) {
  const int D = p.D;
  layer_norm(s.x, s.t1, vec(p, LND_S, j, D), vec(p, LND_B, j, D), D, s.red);
  round_vec<T>(s.t1, s.dnr, D);
  matvec<T>(s.dnr, D, mat<T>(p, WQ, j, (size_t)D * D), D, vec(p, BQ, j, D),
            s.q, s.part);
}

// The gated update and FFN of sublayer j for this block's row:
// g = sigmoid((agg wga + dnr wgd) + bg); agg += g (dnr ws + bs - agg);
// x += postnorm(agg wo + bo);
// x += ff_postnorm(ff_1(relu(ff_0(ff_prenorm(x))))).
template <typename T>
__device__ void epilogue(const Params& p, int j, const Smem& s) {
  const int D = p.D, tid = threadIdx.x, bd = blockDim.x;
  const size_t DD = (size_t)D * D;
  round_vec<T>(s.agg, s.xr, D);
  matvec<T>(s.xr, D, mat<T>(p, WGA, j, DD), D, nullptr, s.t1, s.part);
  matvec<T>(s.dnr, D, mat<T>(p, WGD, j, DD), D, nullptr, s.t2, s.part);
  matvec<T>(s.dnr, D, mat<T>(p, WS, j, DD), D, vec(p, BS, j, D), s.t3,
            s.part);
  const float* bg = vec(p, BG, j, D);
  for (int i = tid; i < D; i += bd) {
    const float g = sigmoid((s.t1[i] + s.t2[i]) + bg[i]);
    s.agg[i] = s.agg[i] + g * (s.t3[i] - s.agg[i]);
  }
  __syncthreads();
  round_vec<T>(s.agg, s.xr, D);
  matvec<T>(s.xr, D, mat<T>(p, WO, j, DD), D, vec(p, BO, j, D), s.t1, s.part);
  layer_norm(s.t1, s.t2, vec(p, POST_S, j, D), vec(p, POST_B, j, D), D,
             s.red);
  for (int i = tid; i < D; i += bd) s.x[i] += s.t2[i];
  __syncthreads();
  layer_norm(s.x, s.t1, vec(p, FFP_S, j, D), vec(p, FFP_B, j, D), D, s.red);
  round_vec<T>(s.t1, s.xr, D);
  matvec<T>(s.xr, D, mat<T>(p, WF0, j, 4 * DD), 4 * D,
            vec(p, BF0, j, 4 * D), s.h, s.part);
  for (int i = tid; i < 4 * D; i += bd)
    s.xr[i] = round_to<T>(fmaxf(s.h[i], 0.f));
  __syncthreads();
  matvec<T>(s.xr, 4 * D, mat<T>(p, WF1, j, 4 * DD), D, vec(p, BF1, j, D),
            s.t1, s.part);
  layer_norm(s.t1, s.t2, vec(p, FFQ_S, j, D), vec(p, FFQ_B, j, D), D, s.red);
  for (int i = tid; i < D; i += bd) s.x[i] += s.t2[i];
  __syncthreads();
}

__device__ void zero(float* v, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) v[i] = 0.f;
  __syncthreads();
}

// Layer l, row blockIdx.x: the temporal and map sublayers, then the
// agent-agent sublayer's prologue, handed over through `scratch`.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) row_kernel(Params p, int l) {
  extern __shared__ float smem[];
  const Smem s = carve(smem, p.D, p.H, p.nmax);
  const int a = blockIdx.x, A = p.A, D = p.D, tid = threadIdx.x;
  const int bd = blockDim.x;
  const size_t DD = (size_t)D * D;
  const bool live = live_row(p, a);
  const float* x_in = l == 0 ? p.x0 + (size_t)a * D
                             : p.out + ((size_t)(l - 1) * A + a) * D;
  for (int i = tid; i < D; i += bd) s.x[i] = x_in[i];
  __syncthreads();

  // temporal: the row's own W-column key window
  int j = 3 * l;
  query<T>(p, j, s);
  if (live)
    attend_row<T>(p, j,
                  static_cast<const T*>(p.key_stack) +
                      ((size_t)l * A + a) * p.W * D,
                  static_cast<const T*>(p.r_t) + (size_t)a * p.W * D,
                  p.t_mask + (size_t)a * p.W, p.W, nullptr, nullptr, s);
  else
    zero(s.agg, D);
  epilogue<T>(p, j, s);

  // map: the row's K nearest map tokens
  j = 3 * l + 1;
  query<T>(p, j, s);
  if (live)
    attend_row<T>(p, j, static_cast<const T*>(p.pl_keys) + (size_t)a * p.K * D,
                  static_cast<const T*>(p.r_pl) + (size_t)a * p.K * D,
                  p.pl_mask + (size_t)a * p.K, p.K, nullptr, nullptr, s);
  else
    zero(s.agg, D);
  epilogue<T>(p, j, s);

  // agent-agent prologue: query, and this row as a key: k = LN(x) wk,
  // v = LN(x) wv + bv
  j = 3 * l + 2;
  query<T>(p, j, s);
  layer_norm(s.x, s.t1, vec(p, LNS_S, j, D), vec(p, LNS_B, j, D), D, s.red);
  round_vec<T>(s.t1, s.xr, D);
  matvec<T>(s.xr, D, mat<T>(p, WK, j, DD), D, nullptr, s.t2, s.part);
  matvec<T>(s.xr, D, mat<T>(p, WV, j, DD), D, vec(p, BV, j, D), s.t3, s.part);
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
__global__ void __launch_bounds__(kThreads, 1) aa_kernel(Params p, int l) {
  extern __shared__ float smem[];
  const Smem s = carve(smem, p.D, p.H, p.nmax);
  const int a = blockIdx.x, A = p.A, D = p.D, tid = threadIdx.x;
  const int bd = blockDim.x, j = 3 * l + 2;
  const size_t AD = (size_t)A * D;
  const float* sc = p.scratch + (size_t)a * D;
  for (int i = tid; i < D; i += bd) {
    s.x[i] = sc[XMID * AD + i];
    s.dnr[i] = sc[DNAA * AD + i];
    s.q[i] = sc[QAA * AD + i];
  }
  __syncthreads();
  if (live_row(p, a))
    attend_row<T>(p, j, nullptr,
                  static_cast<const T*>(p.r_aa) + (size_t)a * A * D,
                  p.aa_mask + (size_t)a * A, A, p.scratch + KSH * AD,
                  p.scratch + VSH * AD, s);
  else
    zero(s.agg, D);
  epilogue<T>(p, j, s);
  float* out = p.out + ((size_t)l * A + a) * D;
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
  for (int l = 0; l < p.L; ++l) {
    row_kernel<T><<<p.A, kThreads, bytes, stream>>>(p, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    aa_kernel<T><<<p.A, kThreads, bytes, stream>>>(p, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (keys, relations and packed matrices).
// ptrs: host array of kNumArgs device pointers. n_rows: device int or null.
// scratch: fp32 [5, A, D]. Returns a cudaError_t; 0 on successful launches.
extern "C" int infgen_motion_column(
    int dtype, const float* x0, const void* key_stack, const void* r_t,
    const uint8_t* t_mask, const void* pl_keys, const void* r_pl,
    const uint8_t* pl_mask, const void* r_aa, const uint8_t* aa_mask,
    const int* n_rows, const uint64_t* ptrs, float* out, float* scratch,
    int L, int A, int W, int K, int D, int H, int Hd, void* stream) {
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
  p.out = out;
  p.scratch = scratch;
  p.L = L;
  p.A = A;
  p.W = W;
  p.K = K;
  p.D = D;
  p.H = H;
  p.Hd = Hd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
