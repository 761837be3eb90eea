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
// fp32 with no operand rounding and no tensor cores, the output written in
// In's type.
//
// Bound. The agent-agent call of the flagship rollout (Q = K = 128, D = 128,
// 8x16 heads) in the direct form is about 0.57 G multiply-adds when every
// pair is valid, almost all of it the relation projections (each pair's r
// row through w_kr and w_vr, 2 D^2). The reassociated form below needs
// 2 H D multiply-adds per valid pair for each of the key and relation
// terms instead (16x fewer than 2 D^2 at D = 128, H = 8), plus 2 D^2 per
// query row for each. chip_smoke.py's bound (fused_cost_least) takes each
// term in the cheaper form (self keys: projected once, direct): 0.073 G
// for the all-valid agent call, 2.2 us at the 67 TFLOP/s fp32 peak, and
// 0.054 G (1.6 us) at the rollout's half-valid mask, above the 1.0 us
// its 3.3 MB of bf16 inputs and fp32 weights take to read; the temporal
// and map calls' bounds are 1.2 and 1.1 us.
//
// Design.
//   - Reassociation. With u_h = W_k[:, h] q_h and ur_h = W_kr[:, h] q_h
//     (per query row and head, [D] each), a pair's score is
//     LN(key) . u_h + LN(r) . ur_h, and its value term, summed over the
//     keys with the softmax weights p, is
//     (sum p LN(key)) W_v[:, h] + (sum p LN(r)) W_vr[:, h] + (b_v + b_vr) sum p.
//     So nothing is projected per pair: a pair costs two LayerNorms, the
//     two dot products per head and the two weighted sums, and the key
//     projection of shared and self keys disappears (one launch). u and ur
//     come from head-blocked copies of W_k and W_kr ([Hd, H D], packed by
//     ops/fused_block.py) as one row-tile product each.
//   - Query-row tiles. A block of 256 threads owns kRows = 2 query rows.
//     Every row-wise product (q, u, ur, the value projections, the gates,
//     the out-projection, the FFN) is a [2, n_in] x [n_in, n_out] fp32
//     register tile: each thread holds two columns x 2 rows of sums, and
//     groups of threads split k with their sums added in a fixed order.
//   - Weight stream. The block's eleven matrices (1.1 MB at D = 128) stream
//     once per block from L2, in use order, as 16 KB chunks through a
//     four-stage ring, each chunk one bulk copy (TMA) on an mbarrier: three
//     chunks are in flight ahead of the one in use, across matrix
//     boundaries and across the pair phase.
// What sets its time (on an H100, PERF.md): the eleven weight products,
// each chunk of weights arriving slower than a copy loop alone moves it;
// the pair phase is the smaller part even for the agent-agent call.
// Thread-issued cp.async copies were slower; a cluster of four CTAs that
// each streamed a quarter of the columns and exchanged rows through
// distributed shared memory was slower still, and sharing chunks by
// multicast did not stream faster in a test of the stream alone.
//   - Pairs. Each query row's valid keys are compacted and taken in tiles
//     of 32, one row after another: the tile's raw relation rows (and,
//     with per-query keys, key rows) are copied to shared memory with
//     cp.async while the previous tile computes, then LayerNormed one warp
//     per row; eight threads per key compute its H scores; a warp per head
//     keeps an online softmax (running max and denominator); 2 D threads
//     keep the per-head weighted sums of LN(key) and LN(r) in registers,
//     rescaled per tile. With shared or self keys LN(key) is computed once
//     per block for all K keys.
//
// Lanes. A batched rollout runs one scenario per lane: x [B, Q, D], keys
// [B, Q, K, D] (per query) or [B, K, D] (shared), r [B, Q, K, D], mask
// [B, Q, K], out [B, Q, D], one launch of (tiles per lane, B) blocks. A
// block reads its own lane's rows and keys, so self-attention attends
// within the lane's rows only; the weights are shared. The single call is
// the launch with B = 1, and every lane computes what its single call
// computes, bit for bit.

#include "dense_row.cuh"

namespace {

constexpr int kFbThreads = 256;
constexpr int kRows = 2;       // query rows per block
constexpr int kKT = 32;        // keys per pair tile (one per lane)
constexpr int kMaxH = 16;
constexpr int kMaxD = 128;
constexpr int kStage = 4096;   // floats per ring stage
constexpr int kStages = 4;     // ring stages: three chunks in flight
constexpr int kMaxIt = 2;      // column pairs per thread in tile_mm
constexpr int kMats = 11;      // matrices a block streams, in use order

// Head-blocked key projections, after dense_row.cuh's arrays in the pointer
// array (fused_block.py::pack_fused_block): wkh[j, h D + d] = W_k[d, h Hd + j].
enum HeadArg { WKH = kNumArgs, WKRH, kNumFbArgs };

struct Params {
  const void* x;       // [B, Q, D] In
  const void* src;     // [B, Q, K, D] (per query) or [B, K, D] (shared) In;
                       // null: self-attention over x
  const void* r;       // [B, Q, K, D] In
  const uint8_t* mask; // [B, Q, K]
  const void* w[kNumFbArgs];
  void* out;           // [B, Q, D] In
  int B, Q, K, D, H, Hd, per_query;
};

// p's arrays moved to lane b's rows (elements of In, `es` bytes each).
__device__ __forceinline__ void to_lane(Params& p, size_t b, size_t es) {
  const size_t qd = (size_t)p.Q * p.D, qkd = (size_t)p.Q * p.K * p.D;
  p.x = static_cast<const char*>(p.x) + b * qd * es;
  if (p.src != nullptr)
    p.src = static_cast<const char*>(p.src) +
            b * (p.per_query ? qkd : (size_t)p.K * p.D) * es;
  p.r = static_cast<const char*>(p.r) + b * qkd * es;
  p.mask += b * p.Q * p.K;
  p.out = static_cast<char*>(p.out) + b * qd * es;
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Floats of the raw (input-typed) staging of a pair tile: relation rows, and
// key rows with per-query keys.
__host__ __device__ inline int raw_floats(int D, bool shared, int in_bytes) {
  return (shared ? 1 : 2) * kKT * D * in_bytes / 4;
}

// Shared memory of one block, in floats (fb_carve lays it out).
inline size_t fb_floats(int D, int H, int K, bool shared, int in_bytes) {
  const int RD = kRows * D, RHD = kRows * H * D, ld = D + 8;
  const int pair = ((shared ? K : kKT) + kKT) * ld + kKT * H + 2 * kMaxH +
                   raw_floats(D, shared, in_bytes) + kRows * round4(K) +
                   kFbThreads / 32 + 1;
  return (size_t)11 * RD + 4 * RHD + round4(kRows * H) +
         2 * kRows * kFbThreads + kStages * kStage + pair;
}

struct FbSmem {
  float *xs, *dn, *q, *ag, *t1, *t2, *t3, *hb, *ukt, *urt, *sagg, *tagg,
      *den, *part, *ring, *sn, *rn, *pt, *mx, *alph, *raw;
  int *idx, *scan;
};

__device__ FbSmem fb_carve(float* p, int D, int H, int K, bool shared,
                           int in_bytes) {
  const int RD = kRows * D, RHD = kRows * H * D, ld = D + 8;
  FbSmem s;
  s.xs = p;  p += RD;       // [R, D] running rows
  s.dn = p;  p += RD;       // [R, D] LN_dst(x)
  s.q = p;   p += RD;       // [R, D]
  s.ag = p;  p += RD;       // [R, D] aggregate
  s.t1 = p;  p += RD;
  s.t2 = p;  p += RD;
  s.t3 = p;  p += RD;
  s.hb = p;  p += 4 * RD;   // [R, 4D] FFN hidden
  s.ukt = p; p += RHD;      // [R, D, H] u, d-major
  s.urt = p; p += RHD;      // [R, D, H] ur, d-major
  s.sagg = p; p += RHD;     // [R, H, D] sum p LN(key); u as computed
  s.tagg = p; p += RHD;     // [R, H, D] sum p LN(r); ur as computed
  s.den = p; p += round4(kRows * H);  // [R, H] softmax denominators
  s.part = p; p += 2 * kRows * kFbThreads;  // tile_mm's k-group sums
  s.ring = p; p += kStages * kStage;         // the weight stream's ring
  s.sn = p;  p += (shared ? K : kKT) * ld;  // LN(key) rows
  s.rn = p;  p += kKT * ld;                  // LN(r) rows of a tile
  s.pt = p;  p += kKT * H;                   // scores, then weights
  s.mx = p;  p += kMaxH;                     // running max per head
  s.alph = p; p += kMaxH;                    // this tile's rescale
  s.raw = p; p += raw_floats(D, shared, in_bytes);  // [1 or 2, kKT, D] In
  s.idx = reinterpret_cast<int*>(p);         // [kRows, K] valid keys
  s.scan = s.idx + kRows * round4(K);
  return s;
}

__device__ __forceinline__ const float* arg(const Params& p, int a) {
  return static_cast<const float*>(p.w[a]);
}

// The block's weights as one stream of chunks through a ring of kStages
// shared-memory stages: the matrices in the order the block uses them, each
// [n_in, n_out] fp32 cut into chunks of kc rows (kStage floats at most),
// each chunk one bulk copy (TMA) by thread 0 that completes on its stage's
// mbarrier. Up to kStages - 1 chunks are in flight ahead of the one in use,
// across matrix boundaries and across the pair phase, whose shared memory
// is apart.
struct MatSpec {
  const float* w;
  int n_in, n_out, kc, nch;
};

struct WStream {
  const MatSpec* spec;
  float* ring;
  uint64_t* bar;       // [kStages] mbarriers, one per stage
  int lm, lc;          // the next chunk to load: matrix, chunk of it
  int issued, used;    // chunks loaded / consumed so far
};

// Every thread runs the bookkeeping; thread 0 issues the copies. A stage is
// refilled only after the block released its previous chunk.
__device__ void ws_top_up(WStream& s) {
  while (s.issued < s.used + kStages && s.lm < kMats) {
    const MatSpec& m = s.spec[s.lm];
    if (threadIdx.x == 0) {
      const int st = s.issued % kStages;
      const uint32_t bytes = m.kc * m.n_out * sizeof(float);
      fence_proxy_async();
      mbar_expect_tx(s.bar + st, bytes);
      bulk_g2s(s.ring + st * kStage, m.w + (size_t)s.lc * m.kc * m.n_out,
               bytes, s.bar + st);
    }
    ++s.issued;
    if (++s.lc == m.nch) {
      s.lc = 0;
      ++s.lm;
    }
  }
}

// The next chunk, landed (each thread waits on the stage's barrier).
__device__ const float* ws_acquire(WStream& s) {
  ws_top_up(s);
  mbar_wait(s.bar + s.used % kStages, (s.used / kStages) & 1);
  return s.ring + (s.used % kStages) * kStage;
}

__device__ void ws_release(WStream& s) {
  __syncthreads();  // the stage is refilled at a later top-up
  ++s.used;
}

__device__ MatSpec mat_spec(const float* w, int n_in, int n_out) {
  const int kc = min(n_in, kStage / n_out);
  return MatSpec{w, n_in, n_out, kc, n_in / kc};
}

// Y[r, c] = sum_k X(r, c, k) W[k, c] + bias[c] for r < kRows, c < n_out,
// k < n_in (bias may be null); with `accumulate`, Y += that instead.
// X(r, c, k) = X[r ldx + (c / hd) hs + k]: hs = 0 is a plain row tile,
// hs > 0 gives each head of hd columns its own input vector of the row.
// W [n_in, n_out] is the stream's next matrix; a thread holds a column
// pair x kRows sums (two pairs when n_out > 2 blockDim) over its k group's
// rows of each chunk; the groups' sums are added in `part` in a fixed
// order. Needs n_out a power of two of at most 2 kMaxIt blockDim (a
// thread's column pairs fit in acc), chunks of at least 4 rows
// (kStage / n_out >= 4, n_in >= 4), n_in a multiple of the chunk,
// 4 | ldx, hs, and X 16-byte aligned; fused_block.py::kernel_accepts
// refuses the widths that break these.
__device__ void tile_mm(const float* X, int ldx, int hs, int hd, WStream& st,
                        int n_in, int n_out, const float* bias, float* Y,
                        int ldy, bool accumulate, float* part) {
  const int tid = threadIdx.x, bd = blockDim.x;
  const int pairs = n_out >> 1;
  const int kc = min(n_in, kStage / n_out);
  const int G = pairs >= bd ? 1 : min(bd / pairs, kc / 4);
  const int sub = kc / G, nch = n_in / kc;
  const int nit = pairs > bd ? pairs / bd : 1;
  const int g = pairs >= bd ? 0 : tid / pairs;
  const bool active = g < G;
  int cp[kMaxIt], xo[kMaxIt];
#pragma unroll
  for (int u = 0; u < kMaxIt; ++u) {
    cp[u] = pairs >= bd ? tid + u * bd : tid % pairs;
    xo[u] = (2 * cp[u] / hd) * hs;
  }
  float acc[kMaxIt][kRows][2];
#pragma unroll
  for (int u = 0; u < kMaxIt; ++u)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[u][r][0] = acc[u][r][1] = 0.f;

  for (int i = 0; i < nch; ++i) {
    const float* ws = ws_acquire(st);
    if (active) {
      const int kl = g * sub, kg = i * kc + kl;
      for (int kk = 0; kk < sub; kk += 4) {
#pragma unroll
        for (int u = 0; u < kMaxIt; ++u) {
          if (u < nit) {
            float4 xv[kRows];
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              xv[r] = *reinterpret_cast<const float4*>(X + r * ldx + xo[u] +
                                                      kg + kk);
            const float* wp = ws + (size_t)(kl + kk) * n_out + 2 * cp[u];
            const float2 w0 = *reinterpret_cast<const float2*>(wp);
            const float2 w1 = *reinterpret_cast<const float2*>(wp + n_out);
            const float2 w2 =
                *reinterpret_cast<const float2*>(wp + 2 * n_out);
            const float2 w3 =
                *reinterpret_cast<const float2*>(wp + 3 * n_out);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              float a0 = acc[u][r][0], a1 = acc[u][r][1];
              a0 = fmaf(xv[r].x, w0.x, a0);
              a1 = fmaf(xv[r].x, w0.y, a1);
              a0 = fmaf(xv[r].y, w1.x, a0);
              a1 = fmaf(xv[r].y, w1.y, a1);
              a0 = fmaf(xv[r].z, w2.x, a0);
              a1 = fmaf(xv[r].z, w2.y, a1);
              a0 = fmaf(xv[r].w, w3.x, a0);
              a1 = fmaf(xv[r].w, w3.y, a1);
              acc[u][r][0] = a0;
              acc[u][r][1] = a1;
            }
          }
        }
      }
    }
    ws_release(st);
  }
  if (G == 1) {
#pragma unroll
    for (int u = 0; u < kMaxIt; ++u) {
      if (u >= nit || !active) continue;  // idle threads when pairs < bd
      const int c = 2 * cp[u];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[u][r][e] + (bias ? bias[c + e] : 0.f);
          float* dst = Y + r * ldy + c + e;
          *dst = accumulate ? *dst + v : v;
        }
    }
  } else {
    if (active) {
      const int c = 2 * cp[0];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        part[(g * kRows + r) * n_out + c] = acc[0][r][0];
        part[(g * kRows + r) * n_out + c + 1] = acc[0][r][1];
      }
    }
    __syncthreads();
    for (int i = tid; i < kRows * n_out; i += bd) {
      const int r = i / n_out, c = i % n_out;
      float v = 0.f;
      for (int gg = 0; gg < G; ++gg) v += part[(gg * kRows + r) * n_out + c];
      v += bias ? bias[c] : 0.f;
      float* dst = Y + r * ldy + c;
      *dst = accumulate ? *dst + v : v;
    }
  }
  __syncthreads();
}

// dst[0..D) = LayerNorm(src) * s + b by one warp (two-pass fp32).
template <typename In>
__device__ void ln_warp(const In* src, float* dst, int D, const float* s,
                        const float* b) {
  const int lane = threadIdx.x & 31;
  float v[kMaxD / 32];
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) {
    const int d = lane + 32 * i;
    v[i] = d < D ? to_f(src[d]) : 0.f;
    acc += v[i];
  }
  const float mean = warp_sum(acc) / D;
  acc = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) {
    const int d = lane + 32 * i;
    const float e = d < D ? v[i] - mean : 0.f;
    acc += e * e;
  }
  const float rs = rsqrtf(warp_sum(acc) / D + kLnEps);
#pragma unroll
  for (int i = 0; i < kMaxD / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < D) dst[d] = (v[i] - mean) * rs * s[d] + b[d];
  }
}

// The attention of the block's query rows r < nr over their valid keys:
// fills sagg[r], tagg[r] (per-head weighted sums of LN(key) and LN(r)) and
// den[r] (per-head softmax denominators; 0 when no key is valid). The
// rows' valid keys are taken in tiles of kKT, one row after another; each
// tile's raw input rows are copied to shared memory (cp.async) while the
// previous tile computes (its raw rows are consumed by the LayerNorms
// first), so a tile waits on L2 at most once.
template <typename In>
__device__ void attend_rows(const Params& p, const FbSmem& s, int a0,
                            int nr) {
  const int D = p.D, H = p.H, K = p.K, tid = threadIdx.x, bd = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = bd >> 5, ld = D + 8;
  const int K4 = round4(K);
  const bool perq = p.per_query != 0;
  const float scale = 1.f / sqrtf((float)p.Hd);
  const In* rel = static_cast<const In*>(p.r);
  const In* keys = perq ? static_cast<const In*>(p.src) : nullptr;
  int n[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    n[r] = r < nr ? compact(p.mask + (size_t)(a0 + r) * K, K,
                            s.idx + r * K4, s.scan)
                  : 0;
  for (int i = tid; i < kRows * H; i += bd) s.den[i] = 0.f;
  // raw staging: a tile's relation rows, then its key rows
  const int per = 16 / (int)sizeof(In), cpr = D / per;
  In* raw = reinterpret_cast<In*>(s.raw);
  auto issue = [&](int r, int t0) {
    const int m = min(kKT, n[r] - t0);
    const int* ix = s.idx + r * K4 + t0;
    const size_t base = (size_t)(a0 + r) * K;
    In* dst = raw;
    for (int i = tid; i < (perq ? 2 : 1) * m * cpr; i += bd) {
      const int row = i / cpr, ch = i % cpr;
      const int k = row % m;
      const In* src = (row < m ? rel : keys) + (base + ix[k]) * D;
      cp_async16(dst + (size_t)(row < m ? k : kKT + k) * D + ch * per,
                 src + ch * per);
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
  int r = 0, t0 = -kKT;
  next(r, t0);
  if (r < kRows) issue(r, t0);
  const bool aggr = tid < 2 * D;
  const int half = tid / D, dcol = tid % D;
  float acc[kMaxH];
  while (r < kRows) {
    const int m = min(kKT, n[r] - t0);
    const int* ix = s.idx + r * K4 + t0;
    if (t0 == 0) {  // a new row: reset the running state
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) acc[h] = 0.f;
      if (tid < H) s.mx[tid] = -INFINITY;
    }
    cp_wait<0>();
    __syncthreads();
    // 1. LN(r) (and LN(key) per query) of the tile, from the staged rows
    for (int i = warp; i < (perq ? 2 : 1) * m; i += nw) {
      if (i < m)
        ln_warp(raw + (size_t)i * D, s.rn + i * ld, D, arg(p, LNR_S),
                arg(p, LNR_B));
      else
        ln_warp(raw + (size_t)(kKT + i - m) * D, s.sn + (i - m) * ld, D,
                arg(p, LNS_S), arg(p, LNS_B));
    }
    __syncthreads();
    int nr_ = r, nt = t0;
    next(nr_, nt);
    if (nr_ < kRows) issue(nr_, nt);  // lands while this tile computes
    // 2. scores: eight threads per key, each a stride-8 share of d
    {
      const float* ukt = s.ukt + (size_t)r * D * H;
      const float* urt = s.urt + (size_t)r * D * H;
      const int k = tid >> 3, dp = tid & 7;
      float sc[kMaxH];
#pragma unroll
      for (int h = 0; h < kMaxH; ++h) sc[h] = 0.f;
      if (k < m) {
        const float* snr = s.sn + (perq ? k : ix[k]) * ld;
        const float* rnr = s.rn + k * ld;
        for (int d = dp; d < D; d += 8) {
          const float x0 = snr[d], x1 = rnr[d];
          const float* u0 = ukt + d * H;
          const float* u1 = urt + d * H;
          if ((H & 3) == 0) {
#pragma unroll
            for (int h = 0; h < kMaxH; h += 4) {
              if (h < H) {
                const float4 a4 = *reinterpret_cast<const float4*>(u0 + h);
                const float4 b4 = *reinterpret_cast<const float4*>(u1 + h);
                sc[h] = fmaf(x0, a4.x, fmaf(x1, b4.x, sc[h]));
                sc[h + 1] = fmaf(x0, a4.y, fmaf(x1, b4.y, sc[h + 1]));
                sc[h + 2] = fmaf(x0, a4.z, fmaf(x1, b4.z, sc[h + 2]));
                sc[h + 3] = fmaf(x0, a4.w, fmaf(x1, b4.w, sc[h + 3]));
              }
            }
          } else {
#pragma unroll
            for (int h = 0; h < kMaxH; ++h)
              if (h < H) sc[h] = fmaf(x0, u0[h], fmaf(x1, u1[h], sc[h]));
          }
        }
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
      if (k < m && dp == 0)
#pragma unroll
        for (int h = 0; h < kMaxH; ++h)
          if (h < H) s.pt[k * H + h] = sc[h] * scale;
    }
    __syncthreads();
    // 3. online softmax, one warp per head, one key per lane
    for (int h = warp; h < H; h += nw) {
      const float v = lane < m ? s.pt[lane * H + h] : -INFINITY;
      const float mo = s.mx[h];
      const float mn = fmaxf(mo, warp_max(v));
      const float e = lane < m ? expf(v - mn) : 0.f;
      if (lane < m) s.pt[lane * H + h] = e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float al = expf(mo - mn);  // 0 on the row's first tile
        s.alph[h] = al;
        s.mx[h] = mn;
        s.den[r * H + h] = s.den[r * H + h] * al + sum;
      }
    }
    __syncthreads();
    // 4. weighted sums of LN(key) (half 0) and LN(r) (half 1), four keys
    // at a time
    if (aggr) {
#pragma unroll
      for (int h = 0; h < kMaxH; ++h)
        if (h < H) acc[h] *= s.alph[h];
      const float* col = half ? s.rn + dcol : s.sn + dcol;
      for (int k0 = 0; k0 < m; k0 += 4) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = min(k0 + u, m - 1);
          v[u] = k0 + u < m ? col[(half || perq ? k : ix[k]) * ld] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* pk = s.pt + min(k0 + u, m - 1) * H;
#pragma unroll
          for (int h = 0; h < kMaxH; ++h)
            if (h < H) acc[h] = fmaf(pk[h], v[u], acc[h]);
        }
      }
    }
    const bool row_end = nr_ != r;
    if (row_end && aggr) {
      float* out = (half ? s.tagg : s.sagg) + (size_t)r * H * D + dcol;
#pragma unroll
      for (int h = 0; h < kMaxH; ++h)
        if (h < H) out[h * D] = acc[h];
    }
    __syncthreads();  // the tile's rows and weights are overwritten next
    r = nr_;
    t0 = nt;
  }
  // rows without a valid key (and past the last row) aggregate to zero
  for (int i = tid; i < kRows * H * D; i += bd) {
    const int rr = i / (H * D);
    if (n[rr] == 0) {
      s.sagg[i] = 0.f;
      s.tagg[i] = 0.f;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16(v);
}

template <typename In>
__global__ void __launch_bounds__(kFbThreads, 1) fused_block_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  to_lane(p, blockIdx.y, sizeof(In));
  const int D = p.D, H = p.H, Hd = p.Hd, K = p.K, HD = H * D;
  const int tid = threadIdx.x, bd = blockDim.x, warp = tid >> 5;
  const int nw = bd >> 5, RD = kRows * D;
  const bool shared = !p.per_query;
  const FbSmem s = fb_carve(smem, D, H, K, shared, sizeof(In));
  const int a0 = blockIdx.x * kRows, nr = min(kRows, p.Q - a0);
  __shared__ MatSpec spec[kMats];
  __shared__ uint64_t bars[kStages];
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + i, 1);
    fence_barrier_init();
    const int nin[kMats] = {D, Hd, Hd, D, D, D, D, D, D, D, 4 * D};
    const int nout[kMats] = {D, HD, HD, D, D, D, D, D, D, 4 * D, D};
    const int args[kMats] = {WQ, WKH, WKRH, WV, WVR, WGA, WGD, WS, WO, WF0,
                             WF1};
    for (int m = 0; m < kMats; ++m)
      spec[m] = mat_spec(arg(p, args[m]), nin[m], nout[m]);
  }
  __syncthreads();
  WStream st{spec, s.ring, bars, 0, 0, 0, 0};
  ws_top_up(st);  // the first chunks load while the rows are read
  const In* x = static_cast<const In*>(p.x);
  for (int i = tid; i < RD; i += bd) {
    const int r = i / D;
    s.xs[i] = r < nr ? to_f(x[(size_t)(a0 + r) * D + i % D]) : 0.f;
  }
  __syncthreads();
  // query side: q, and u / ur per head (into sagg / tagg, then d-major)
  rows_ln<float, false>(s.xs, D, s.dn, D, kRows, D, arg(p, LND_S),
                        arg(p, LND_B));
  tile_mm(s.dn, D, 0, 1, st, D, D, arg(p, BQ), s.q, D, false, s.part);
  tile_mm(s.q, D, Hd, D, st, Hd, HD, nullptr, s.sagg, HD, false, s.part);
  tile_mm(s.q, D, Hd, D, st, Hd, HD, nullptr, s.tagg, HD, false, s.part);
  for (int i = tid; i < kRows * HD; i += bd) {
    const int r = i / HD, h = (i % HD) / D, d = i % D;
    s.ukt[((size_t)r * D + d) * H + h] = s.sagg[i];
    s.urt[((size_t)r * D + d) * H + h] = s.tagg[i];
  }
  if (shared) {  // LN(key) of every shared key, once per block, kKT
                 // rows at a time through the staging buffer
    const In* rows = static_cast<const In*>(p.src ? p.src : p.x);
    In* raw = reinterpret_cast<In*>(s.raw);
    const int per = 16 / (int)sizeof(In), cpr = D / per;
    for (int k0 = 0; k0 < K; k0 += kKT) {
      const int m = min(kKT, K - k0);
      for (int i = tid; i < m * cpr; i += bd)
        cp_async16(raw + (size_t)i * per,
                   rows + (size_t)(k0 + i / cpr) * D + (i % cpr) * per);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      for (int k = warp; k < m; k += nw)
        ln_warp(raw + (size_t)k * D, s.sn + (k0 + k) * (D + 8), D,
                arg(p, LNS_S), arg(p, LNS_B));
      __syncthreads();
    }
  }
  __syncthreads();
  attend_rows<In>(p, s, a0, nr);
  // agg = (sagg W_v + tagg W_vr + (b_v + b_vr) den) / den, per head
  tile_mm(s.sagg, HD, D, Hd, st, D, D, nullptr, s.ag, D, false, s.part);
  tile_mm(s.tagg, HD, D, Hd, st, D, D, nullptr, s.ag, D, true, s.part);
  const float *bv = arg(p, BV), *bvr = arg(p, BVR);
  for (int i = tid; i < RD; i += bd) {
    const int r = i / D, c = i % D;
    const float dn = s.den[r * H + c / Hd];
    s.ag[i] = (s.ag[i] + (bv[c] + bvr[c]) * dn) / fmaxf(dn, 1e-30f);
  }
  __syncthreads();
  // g = sigmoid(agg wga + dn wgd + bg); agg += g (dn ws + bs - agg)
  tile_mm(s.ag, D, 0, 1, st, D, D, nullptr, s.t1, D, false, s.part);
  tile_mm(s.dn, D, 0, 1, st, D, D, nullptr, s.t1, D, true, s.part);
  tile_mm(s.dn, D, 0, 1, st, D, D, arg(p, BS), s.t3, D, false, s.part);
  const float* bg = arg(p, BG);
  for (int i = tid; i < RD; i += bd) {
    const float g = sigmoid(s.t1[i] + bg[i % D]);
    s.ag[i] = s.ag[i] + g * (s.t3[i] - s.ag[i]);
  }
  __syncthreads();
  // x += postnorm(agg wo + bo); x += ff_postnorm(ff_1(relu(ff_0(...))))
  tile_mm(s.ag, D, 0, 1, st, D, D, arg(p, BO), s.t1, D, false, s.part);
  rows_ln<float, false>(s.t1, D, s.t2, D, kRows, D, arg(p, POST_S),
                        arg(p, POST_B));
  for (int i = tid; i < RD; i += bd) s.xs[i] += s.t2[i];
  __syncthreads();
  rows_ln<float, false>(s.xs, D, s.t1, D, kRows, D, arg(p, FFP_S),
                        arg(p, FFP_B));
  tile_mm(s.t1, D, 0, 1, st, D, 4 * D, arg(p, BF0), s.hb, 4 * D,
          false, s.part);
  for (int i = tid; i < 4 * RD; i += bd) s.hb[i] = fmaxf(s.hb[i], 0.f);
  __syncthreads();
  tile_mm(s.hb, 4 * D, 0, 1, st, 4 * D, D, arg(p, BF1), s.t1, D,
          false, s.part);
  rows_ln<float, false>(s.t1, D, s.t2, D, kRows, D, arg(p, FFQ_S),
                        arg(p, FFQ_B));
  In* out = static_cast<In*>(p.out);
  for (int i = tid; i < nr * D; i += bd)
    store(s.xs[i] + s.t2[i], out + (size_t)a0 * D + i);
}

template <typename In>
int launch(Params& p, cudaStream_t stream) {
  const size_t bytes =
      fb_floats(p.D, p.H, p.K, !p.per_query, sizeof(In)) * sizeof(float);
  static size_t allowed = 0;
  const cudaError_t err = allow_smem(fused_block_kernel<In>, bytes, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Q + kRows - 1) / kRows, p.B);
  fused_block_kernel<In><<<grid, kFbThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of shared memory one block needs (the wrapper checks them).
extern "C" int infgen_fused_block_smem(int dtype, int D, int H, int K,
                                       int per_query) {
  return (int)(fb_floats(D, H, K, !per_query, dtype == 1 ? 2 : 4) *
               sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16 (x, x_src, r and the output; the weights
// are fp32). B lanes of Q rows each (B = 1: one call's [Q, ...] arrays).
// x_src: null for self-attention. per_query: x_src is [B, Q, K, D], else
// [B, K, D]. ptrs: host array of kNumFbArgs device pointers (one sublayer's
// pack and its head-blocked key projections). Returns a cudaError_t; 0 on
// a successful launch.
extern "C" int infgen_fused_block(int dtype, const void* x, const void* x_src,
                                  const void* r, const uint8_t* mask,
                                  const uint64_t* ptrs, void* out, int B,
                                  int Q, int K, int D, int H, int Hd,
                                  int per_query, void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  Params p;
  p.B = B;
  p.x = x;
  p.src = x_src;
  p.r = r;
  p.mask = mask;
  for (int i = 0; i < kNumFbArgs; ++i)
    p.w[i] = reinterpret_cast<const void*>(ptrs[i]);
  p.out = out;
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
