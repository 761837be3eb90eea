// Masked attention with relation-biased keys and values on Hopper:
//   out[b, q] = sum_k p[b,q,k,h] drop[b,q,k,h] (v[b,k] + r[b,q,k] W_vr)
// over the valid keys, with p = softmax_k(q . (k[b,k] + r[b,q,k] W_kr) /
// sqrt(d)) per head h; a query with no valid key gives 0. Everything fp32.
//
// Replaces the TPU kernel infgen_tpu/ops/pallas_attention.py::
// r_biased_attention (the forward of r_biased_attention_trainable too). Its
// point is that the per-pair bias tensors r W_kr and r W_vr ([B, Q, K, HD],
// the largest intermediates of the trunk) never reach device memory: each
// pair's relation row is projected on chip and used at once.
//
// Bound. The rollout's agent-agent call (B = 1, Q = K = 128, Dr = HD = 128,
// 8x16 heads) is 0.54 G multiply-adds when every pair is valid, all but 1%
// of it the two relation projections (2 Dr HD per pair), against 8.4 MB of
// fp32 relations to read: 16 us of fp32 arithmetic at 67 TFLOP/s against
// 2.5 us of HBM traffic, so operations bound it. Only valid pairs count.
//
// Design. One block per (b, query row). W_kr and W_vr sit in shared memory
// (2 Dr HD floats, 128 KB at the rollout's widths), loaded once per block.
// The row's valid keys are compacted in order and streamed in tiles of
// kTile: their relation rows are loaded, projected against the two
// matrices in shared memory, added to the keys' k and v rows, scored, and
// folded into an fp32 online softmax (running max, undropped denominator,
// dropped accumulator per head, rescaled by exp(m_old - m_new) at each
// tile), so any number of keys fits. Masked keys are never read. Products
// run on the CUDA cores in fp32; tensor-core tiles over the pairs are the
// work of a later change.

#include "common.cuh"

namespace {

constexpr int kTile = 16;  // keys per pass

struct Params {
  const float *q, *k, *v, *r, *wkr, *wvr, *drop;  // drop may be null
  const uint8_t* mask;
  float* out;
  int B, Q, K, HD, Dr, H, Hd;
};

// Floats of shared memory (ints for the compaction counted as floats).
inline size_t smem_floats(int K, int HD, int Dr, int H) {
  return (size_t)2 * Dr * HD + 2 * HD + 3 * H + kTile * H + kTile * Dr +
         (size_t)2 * kTile * HD + K + kThreads / 32 + 1;
}

__global__ void __launch_bounds__(kThreads, 1) rba_kernel(Params p) {
  extern __shared__ float smem[];
  const int HD = p.HD, Dr = p.Dr, H = p.H, Hd = p.Hd, K = p.K;
  const int tid = threadIdx.x, bd = blockDim.x;
  const int row = blockIdx.x, b = row / p.Q;
  float* wk = smem;                       // [Dr, HD]
  float* wv = wk + (size_t)Dr * HD;       // [Dr, HD]
  float* q = wv + (size_t)Dr * HD;        // [HD]
  float* acc = q + HD;                    // [HD] dropped, unnormalised sum
  float* mrun = acc + HD;                 // [H] running max
  float* den = mrun + H;                  // [H] undropped denominator
  float* corr = den + H;                  // [H] this tile's rescale
  float* sc = corr + H;                   // [kTile, H] scores, then weights
  float* rt = sc + kTile * H;             // [kTile, Dr]
  float* kt = rt + kTile * Dr;            // [kTile, HD]
  float* vt = kt + kTile * HD;            // [kTile, HD]
  int* idx = reinterpret_cast<int*>(vt + kTile * HD);  // [K]
  int* scan = idx + K;                    // [blockDim / 32 + 1]

  for (int i = tid; i < Dr * HD; i += bd) {
    wk[i] = p.wkr[i];
    wv[i] = p.wvr[i];
  }
  for (int i = tid; i < HD; i += bd) {
    q[i] = p.q[(size_t)row * HD + i];
    acc[i] = 0.f;
  }
  for (int h = tid; h < H; h += bd) {
    mrun[h] = -INFINITY;
    den[h] = 0.f;
  }
  __syncthreads();

  const float scale = 1.f / sqrtf((float)Hd);
  const float* kb = p.k + (size_t)b * K * HD;
  const float* vb = p.v + (size_t)b * K * HD;
  const float* rrow = p.r + (size_t)row * K * Dr;
  const float* drow = p.drop ? p.drop + (size_t)row * K * H : nullptr;
  const int n = compact(p.mask + (size_t)row * K, K, idx, scan);
  const int warp = tid >> 5, lane = tid & 31, nw = bd >> 5;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int m = min(kTile, n - t0);
    for (int i = tid; i < m * Dr; i += bd)
      rt[i] = rrow[(size_t)idx[t0 + i / Dr] * Dr + i % Dr];
    __syncthreads();
    // k_eff = k + r W_kr, v_eff = v + r W_vr for the tile's keys
    rows_mm<float>(rt, Dr, m, Dr, wk, HD, nullptr, kt, HD, false);
    rows_mm<float>(rt, Dr, m, Dr, wv, HD, nullptr, vt, HD, false);
    for (int i = tid; i < m * HD; i += bd) {
      const size_t o = (size_t)idx[t0 + i / HD] * HD + i % HD;
      kt[i] += kb[o];
      vt[i] += vb[o];
    }
    __syncthreads();
    for (int i = tid; i < m * H; i += bd) {
      const int r = i / H, h = i % H;
      float s = 0.f;
      for (int d = 0; d < Hd; ++d)
        s = fmaf(q[h * Hd + d], kt[r * HD + h * Hd + d], s);
      sc[i] = s * scale;
    }
    __syncthreads();
    // online softmax per head: one warp each
    for (int h = warp; h < H; h += nw) {
      float mx = -INFINITY;
      for (int r = lane; r < m; r += 32) mx = fmaxf(mx, sc[r * H + h]);
      const float m_new = fmaxf(mrun[h], warp_max(mx));
      float sum = 0.f;
      for (int r = lane; r < m; r += 32) {
        const float e = expf(sc[r * H + h] - m_new);
        sum += e;
        sc[r * H + h] =
            drow ? e * drow[(size_t)idx[t0 + r] * H + h] : e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(mrun[h] - m_new);
        den[h] = den[h] * c + sum;
        corr[h] = c;
        mrun[h] = m_new;
      }
    }
    __syncthreads();
    for (int d = tid; d < HD; d += bd) {
      const int h = d / Hd;
      float a = acc[d] * corr[h];
      for (int r = 0; r < m; ++r) a = fmaf(sc[r * H + h], vt[r * HD + d], a);
      acc[d] = a;
    }
    __syncthreads();
  }
  for (int d = tid; d < HD; d += bd)
    p.out[(size_t)row * HD + d] = acc[d] / fmaxf(den[d / Hd], 1e-30f);
}

}  // namespace

// dtype: 0 = float32 (the only type; kept for the common entry-point
// shape). drop: [B, Q, K, H] or null. Returns a cudaError_t; 0 on a
// successful launch.
extern "C" int infgen_r_biased_attention(
    int dtype, const float* q, const float* k, const float* v, const float* r,
    const float* w_kr, const float* w_vr, const uint8_t* mask,
    const float* drop, float* out, int B, int Q, int K, int HD, int Dr, int H,
    void* stream) {
  if (dtype != 0 || HD % H) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.r = r;
  p.wkr = w_kr;
  p.wvr = w_vr;
  p.drop = drop;
  p.mask = mask;
  p.out = out;
  p.B = B;
  p.Q = Q;
  p.K = K;
  p.HD = HD;
  p.Dr = Dr;
  p.H = H;
  p.Hd = HD / H;
  const size_t bytes = smem_floats(K, HD, Dr, H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rba_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  rba_kernel<<<B * Q, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}
