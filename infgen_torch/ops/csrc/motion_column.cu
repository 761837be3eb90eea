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
// cooperative grid are the work of a later change. The per-row device code
// (query, attention, epilogue) is dense_row.cuh's, shared with
// fused_block.cu.

#include "dense_row.cuh"

namespace {

// per-layer hand-over from the row kernel to the agent-agent kernel
enum Scratch { XMID, DNAA, QAA, KSH, VSH };

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

__device__ __forceinline__ Sub sub(const Params& p, int j) {
  return Sub{p.w, j, p.D, p.H, p.Hd};
}

__device__ __forceinline__ bool live_row(const Params& p, int a) {
  return a < (p.n_rows ? *p.n_rows : p.A);
}

// Layer l, row blockIdx.x: the temporal and map sublayers, then the
// agent-agent sublayer's prologue, handed over through `scratch`.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) row_kernel(Params p, int l) {
  extern __shared__ float smem[];
  const Smem s = carve(smem, p.D, p.H, p.nmax);
  const int a = blockIdx.x, A = p.A, D = p.D, tid = threadIdx.x;
  const int bd = blockDim.x;
  const bool live = live_row(p, a);
  const float* x_in = l == 0 ? p.x0 + (size_t)a * D
                             : p.out + ((size_t)(l - 1) * A + a) * D;
  for (int i = tid; i < D; i += bd) s.x[i] = x_in[i];
  __syncthreads();

  // temporal: the row's own W-column key window
  Sub u = sub(p, 3 * l);
  row_query<T>(u, s);
  if (live)
    row_attend<T, T>(u,
                     static_cast<const T*>(p.key_stack) +
                         ((size_t)l * A + a) * p.W * D,
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
__global__ void __launch_bounds__(kThreads, 1) aa_kernel(Params p, int l) {
  extern __shared__ float smem[];
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
