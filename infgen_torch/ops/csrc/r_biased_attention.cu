// Masked attention with relation-biased keys and values on Hopper:
//   out[b, q] = sum_k p[b,q,k,h] drop[b,q,k,h] (v[b,k] + r[b,q,k] W_vr)
// over the valid keys, with p = softmax_k(q . (k[b,k] + r[b,q,k] W_kr) /
// sqrt(d)) per head h; a query with no valid key gives 0. Everything fp32.
//
// Replaces the TPU kernel infgen_tpu/ops/pallas_attention.py::
// r_biased_attention (the forward of r_biased_attention_trainable too). Its
// point is that the per-pair bias tensors r W_kr and r W_vr ([B, Q, K, HD],
// the largest intermediates of the trunk) never reach device memory.
//
// Reassociation. Per query row and head h, ur_h = W_kr[:, h] q_h ([Dr]), so
// a pair's score is q_h . k_h + r . ur_h; and the value side, summed over
// the keys with the dropped softmax weights w, is
//   sum w v_h + (sum w r) W_vr[:, h],
// so only the per-head weighted sums of the relation rows (H x Dr per row)
// are kept and projected through W_vr once per query row. A pair costs
// 2 H Dr + 2 HD multiply-adds instead of 2 Dr HD + 2 HD (16x fewer at the
// rollout's H = 8, Dr = HD = 128), plus 2 Dr HD per query row.
//
// Bound. The rollout's agent-agent call (B = 1, Q = K = 128, Dr = HD = 128,
// 8x16 heads, about half the pairs valid) then needs about 35 M
// multiply-adds (1 us of fp32 arithmetic at 67 TFLOP/s) against about 4.5 MB
// to read, almost all of it the valid pairs' fp32 relation rows (1.3 us at
// 3.35 TB/s): bytes bound it (chip_smoke.py::rba_cost_least).
//
// Design. A block of 256 threads owns kRows = 1 query row (two and four
// rows per block, which read W_kr and W_vr once for several rows, were
// slower on an H100: PERF.md) and reads the weights straight into
// registers: the prologue computes ur (one thread per (Dr row, head), its
// Hd weights loaded together), the epilogue projects the relation sums
// (threads over output columns, weights read coalesced). The row's valid
// keys are compacted in order and taken in tiles of kKT = 32: the tile's
// relation, key and value rows are copied to shared memory with cp.async
// into one of two buffers while the other tile computes (threads that
// read key and value rows from L2 one at a time waited on each load:
// 0.084 ms per call, PERF.md). Per tile: eight threads per key compute its
// H scores (the relation term against ur, the key term against q); a warp
// per head keeps the online softmax (running max, undropped denominator)
// and writes the dropped weights; every thread keeps a few of the H x Dr
// relation sums and of the HD value sums in registers, rescaled per tile.
// Masked keys are never read.

#include "common.cuh"

namespace {

constexpr int kRbaThreads = 256;
constexpr int kRows = 1;      // query rows per block
constexpr int kKT = 32;       // keys per tile (one per lane)
constexpr int kMaxH = 16;
constexpr int kMaxR = 8;      // relation sums per thread: H Dr <= 8 x 256
constexpr int kMaxV = 2;      // value sums per thread: HD <= 2 x 256

struct Params {
  const float *q, *k, *v, *r, *wkr, *wvr, *drop;  // drop may be null
  const uint8_t* mask;
  float* out;
  int B, Q, K, HD, Dr, H, Hd;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Floats of shared memory of one block (ints counted as floats); rba_carve
// lays it out, pallas_attention.py::smem_bytes mirrors it.
__host__ __device__ inline size_t rba_floats(int K, int HD, int Dr, int H) {
  const int Hp = round4(H), G = kRbaThreads >= HD ? kRbaThreads / HD : 1;
  return (size_t)kRows * HD + (size_t)kRows * Dr * Hp +
         (size_t)kRows * H * Dr + (size_t)kRows * HD + round4(kRows * H) +
         (size_t)2 * kKT * (Dr + 2 * HD) + (size_t)kKT * Hp + 2 * kMaxH +
         (size_t)G * kRows * HD + (size_t)kRows * round4(K) +
         kRbaThreads / 32 + 1;
}

struct RbaSmem {
  float *q, *urt, *accr, *accv, *den, *rt, *kt, *vt, *pt, *mx, *alph, *part;
  int *idx, *scan;
};

__device__ RbaSmem rba_carve(float* p, int K, int HD, int Dr, int H) {
  const int Hp = round4(H), G = kRbaThreads >= HD ? kRbaThreads / HD : 1;
  RbaSmem s;
  s.q = p;    p += kRows * HD;                 // [R, HD] queries
  s.urt = p;  p += (size_t)kRows * Dr * Hp;    // [R, Dr, Hp] ur, d-major
  s.accr = p; p += (size_t)kRows * H * Dr;     // [R, H, Dr] sum w r
  s.accv = p; p += kRows * HD;                 // [R, HD] sum w v
  s.den = p;  p += round4(kRows * H);          // [R, H] denominators
  s.rt = p;   p += (size_t)2 * kKT * Dr;       // [2, kKT, Dr] relation tiles
  s.kt = p;   p += (size_t)2 * kKT * HD;       // [2, kKT, HD] their keys
  s.vt = p;   p += (size_t)2 * kKT * HD;       // [2, kKT, HD] and values
  s.pt = p;   p += kKT * Hp;                   // [kKT, Hp] scores, weights
  s.mx = p;   p += kMaxH;                      // running max per head
  s.alph = p; p += kMaxH;                      // this tile's rescale
  s.part = p; p += (size_t)G * kRows * HD;     // the epilogue's k groups
  s.idx = reinterpret_cast<int*>(p);           // [R, round4(K)] valid keys
  s.scan = s.idx + kRows * round4(K);
  return s;
}

__global__ void __launch_bounds__(kRbaThreads, 1) rba_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int HD = p.HD, Dr = p.Dr, H = p.H, Hd = p.Hd, K = p.K;
  const int Hp = round4(H), K4 = round4(K);
  const int tid = threadIdx.x, bd = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = bd >> 5;
  const RbaSmem s = rba_carve(smem, K, HD, Dr, H);
  const int row0 = blockIdx.x * kRows;
  const int nr = min(kRows, p.B * p.Q - row0);

  for (int i = tid; i < kRows * HD; i += bd) {
    const int r = i / HD;
    s.q[i] = r < nr ? p.q[(size_t)row0 * HD + i] : 0.f;
    s.accv[i] = 0.f;
  }
  for (int i = tid; i < kRows * H * Dr; i += bd) s.accr[i] = 0.f;
  for (int i = tid; i < kRows * H; i += bd) s.den[i] = 0.f;
  int n[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    n[r] = r < nr ? compact(p.mask + (size_t)(row0 + r) * K, K,
                            s.idx + r * K4, s.scan)
                  : 0;  // compact syncs: q and the zeroed sums are visible

  // a tile of valid keys: cp.async of their relation, key and value rows
  // into one of two buffers
  const int cpr = Dr / 4, cpk = HD / 4;
  auto issue = [&](int r, int t0, int buf) {
    const int m = min(kKT, n[r] - t0);
    const int* ix = s.idx + r * K4 + t0;
    const int row = row0 + r, b = row / p.Q;
    const float* rrow = p.r + (size_t)row * K * Dr;
    float* dst = s.rt + (size_t)buf * kKT * Dr;
    for (int i = tid; i < m * cpr; i += bd) {
      const int kk = i / cpr, ch = i % cpr;
      cp_async16(dst + (size_t)kk * Dr + 4 * ch,
                 rrow + (size_t)ix[kk] * Dr + 4 * ch);
    }
    const size_t kv = (size_t)b * K * HD;
    for (int i = tid; i < 2 * m * cpk; i += bd) {
      const int half = i / (m * cpk), kk = (i / cpk) % m, ch = i % cpk;
      float* d = (half ? s.vt : s.kt) + ((size_t)buf * kKT + kk) * HD;
      cp_async16(d + 4 * ch,
                 (half ? p.v : p.k) + kv + (size_t)ix[kk] * HD + 4 * ch);
    }
    cp_commit();
  };
  // the next tile after (r, t0), or r = kRows when none
  auto next = [&](int& r, int& t0) {
    t0 += kKT;
    while (r < kRows && t0 >= n[r]) {
      ++r;
      t0 = 0;
    }
  };
  int r = 0, t0 = -kKT, buf = 0;
  next(r, t0);
  if (r < kRows) issue(r, t0, 0);  // lands during the prologue

  // prologue: urt[r, j, h] = sum_d W_kr[j, h Hd + d] q[r, h Hd + d]
  for (int e = tid; e < Dr * H; e += bd) {
    const int j = e / H, h = e % H;
    const float* w = p.wkr + (size_t)j * HD + h * Hd;
    float acc[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0.f;
#pragma unroll 16
    for (int d = 0; d < Hd; ++d) {
      const float wv = __ldg(w + d);
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        acc[rr] = fmaf(wv, s.q[rr * HD + h * Hd + d], acc[rr]);
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
      s.urt[((size_t)rr * Dr + j) * Hp + h] = acc[rr];
  }
  __syncthreads();

  const float scale = 1.f / sqrtf((float)Hd);
  const int HDr = H * Dr;
  float accr[kMaxR], accv[kMaxV];
  while (r < kRows) {
    const int m = min(kKT, n[r] - t0);
    const int* ix = s.idx + r * K4 + t0;
    const int row = row0 + r, b = row / p.Q;
    const float* rt = s.rt + (size_t)buf * kKT * Dr;
    const float* kt = s.kt + (size_t)buf * kKT * HD;
    const float* vt = s.vt + (size_t)buf * kKT * HD;
    if (t0 == 0) {  // a new row: reset the running state
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) accr[i] = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxV; ++i) accv[i] = 0.f;
      if (tid < H) s.mx[tid] = -INFINITY;
    }
    cp_wait<0>();
    __syncthreads();  // this tile landed; the other buffer is free
    int nr_ = r, nt = t0;
    next(nr_, nt);
    if (nr_ < kRows) issue(nr_, nt, buf ^ 1);  // lands while this computes
    // 1. scores: eight threads per key, each a stride-8 share of d
    {
      const float* urt = s.urt + (size_t)r * Dr * Hp;
      const float* qr = s.q + r * HD;
      const int kk = tid >> 3, dp = tid & 7;
      float sc[kMaxH];
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) sc[h] = 0.f;
      if (kk < m) {
        const float* rr = rt + (size_t)kk * Dr;
        for (int d = dp; d < Dr; d += 8) {
          const float x = rr[d];
          const float* u = urt + (size_t)d * Hp;
          if ((H & 3) == 0) {
#pragma unroll
            for (int h = 0; h < kMaxH; h += 4) {
              if (h < H) {
                const float4 u4 = *reinterpret_cast<const float4*>(u + h);
                sc[h] = fmaf(x, u4.x, sc[h]);
                sc[h + 1] = fmaf(x, u4.y, sc[h + 1]);
                sc[h + 2] = fmaf(x, u4.z, sc[h + 2]);
                sc[h + 3] = fmaf(x, u4.w, sc[h + 3]);
              }
            }
          } else {
#pragma unroll
            for (int h = 0; h < kMaxH; ++h)
              if (h < H) sc[h] = fmaf(x, u[h], sc[h]);
          }
        }
        const float* kr = kt + (size_t)kk * HD;
#pragma unroll
        for (int h = 0; h < kMaxH; ++h)
          if (h < H)
            for (int d = h * Hd + dp; d < (h + 1) * Hd; d += 8)
              sc[h] = fmaf(qr[d], kr[d], sc[h]);
      }
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) {
        if (h < H) {
          float v = sc[h];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          sc[h] = v;
        }
      }
      if (kk < m && dp == 0)
#pragma unroll
        for (int h = 0; h < kMaxH; ++h)
          if (h < H) s.pt[kk * Hp + h] = sc[h] * scale;
    }
    __syncthreads();
    // 2. online softmax, one warp per head, one key per lane; the weights
    // written back are dropped, the denominator is not
    for (int h = warp; h < H; h += nw) {
      const float v = lane < m ? s.pt[lane * Hp + h] : -INFINITY;
      const float mo = s.mx[h];
      const float mn = fmaxf(mo, warp_max(v));
      const float e = lane < m ? expf(v - mn) : 0.f;
      if (lane < m)
        s.pt[lane * Hp + h] =
            p.drop ? e * p.drop[((size_t)row * K + ix[lane]) * H + h] : e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float al = expf(mo - mn);  // 0 on the row's first tile
        s.alph[h] = al;
        s.mx[h] = mn;
        s.den[r * H + h] = s.den[r * H + h] * al + sum;
      }
    }
    __syncthreads();
    // 3. the weighted sums: relation rows per head (H Dr), values (HD)
#pragma unroll
    for (int i = 0; i < kMaxR; ++i) {
      const int e = tid + i * bd;
      if (e < HDr) {
        const int h = e / Dr, j = e % Dr;
        float a = accr[i] * s.alph[h];
        for (int kk = 0; kk < m; ++kk)
          a = fmaf(s.pt[kk * Hp + h], rt[(size_t)kk * Dr + j], a);
        accr[i] = a;
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxV; ++i) {
      const int c = tid + i * bd;
      if (c < HD) {
        const int h = c / Hd;
        float a = accv[i] * s.alph[h];
        for (int kk = 0; kk < m; ++kk)
          a = fmaf(s.pt[kk * Hp + h], vt[(size_t)kk * HD + c], a);
        accv[i] = a;
      }
    }
    if (nr_ != r) {  // the row's last tile: keep its sums
#pragma unroll
      for (int i = 0; i < kMaxR; ++i)
        if (tid + i * bd < HDr) s.accr[(size_t)r * HDr + tid + i * bd] = accr[i];
#pragma unroll
      for (int i = 0; i < kMaxV; ++i)
        if (tid + i * bd < HD) s.accv[r * HD + tid + i * bd] = accv[i];
    }
    __syncthreads();  // the tile's weights and buffer are reused next
    r = nr_;
    t0 = nt;
    buf ^= 1;
  }
  __syncthreads();

  // epilogue: out = (accv + accr[h] W_vr[:, c]) / den[h]; groups of threads
  // split j, their sums added in a fixed order
  const int G = bd >= HD ? bd / HD : 1;
  for (int i = tid; i < G * HD; i += bd) {
    const int c = i % HD, g = i / HD, h = c / Hd;
    const int j0 = g * Dr / G, j1 = (g + 1) * Dr / G;
    float acc[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) acc[rr] = 0.f;
#pragma unroll 16
    for (int j = j0; j < j1; ++j) {
      const float w = __ldg(p.wvr + (size_t)j * HD + c);
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        acc[rr] = fmaf(s.accr[((size_t)rr * H + h) * Dr + j], w, acc[rr]);
    }
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr)
      s.part[((size_t)g * kRows + rr) * HD + c] = acc[rr];
  }
  __syncthreads();
  for (int i = tid; i < nr * HD; i += bd) {
    const int rr = i / HD, c = i % HD;
    float a = s.accv[i];
    for (int g = 0; g < G; ++g) a += s.part[((size_t)g * kRows + rr) * HD + c];
    p.out[(size_t)row0 * HD + i] = a / fmaxf(s.den[rr * H + c / Hd], 1e-30f);
  }
}

}  // namespace

// dtype: 0 = float32 (the only type; kept for the common entry-point
// shape). drop: [B, Q, K, H] or null. The widths must pass
// pallas_attention.py::kernel_accepts (H <= 16, H Dr <= 2048, HD <= 512,
// 4 | Dr, 4 | HD, H | HD). Returns a cudaError_t; 0 on a successful launch.
extern "C" int infgen_r_biased_attention(
    int dtype, const float* q, const float* k, const float* v, const float* r,
    const float* w_kr, const float* w_vr, const uint8_t* mask,
    const float* drop, float* out, int B, int Q, int K, int HD, int Dr, int H,
    void* stream) {
  if (dtype != 0 || HD % H || H > kMaxH || H * Dr > kMaxR * kRbaThreads ||
      HD > kMaxV * kRbaThreads || Dr % 4 || HD % 4)
    return (int)cudaErrorInvalidValue;
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
  const size_t bytes = rba_floats(K, HD, Dr, H) * sizeof(float);
  static size_t allowed = 0;
  const cudaError_t err = allow_smem(rba_kernel, bytes, allowed);
  if (err != cudaSuccess) return (int)err;
  rba_kernel<<<(B * Q + kRows - 1) / kRows, kRbaThreads, bytes,
               static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
