// The per-insert heading/offset refine on Hopper: L layers x (map attention,
// agent attention) over the inserted agent's R-row neighbourhood, then the
// heading-bin and offset heads, in one launch.
//
// Replaces the TPU kernel infgen_tpu/ops/refine_kernel.py::refine_kernel.
// Row 0 is the inserted agent and the only row that attends; rows 1.. are
// its agent neighbours (zero rows past the real ones), whose features
// evolve by the zero-aggregate closed form and serve as row 0's agent keys.
// As on the TPU, row 0's aggregate is scattered into an otherwise zero
// [R, D] aggregate and one gated-update / FFN epilogue runs over all rows
// (agg == 0 is the closed form). Map key k and its relation sit in row k of
// pl_keys / r_pl. The TPU's head selector and 128-lane output padding are
// gone: the outputs are the angle_size heading logits and the two offset
// values before tanh.
//
// Bound. At the flagship shapes (D=128, 8x16 heads, L=3, R=32, 120 heading
// bins) in bf16 one pass must read its weights, 16 D^2 per sublayer (to_q,
// to_k, to_v, w_kr, w_vr, to_g 2, to_s, to_out, ff 8) times 6 plus the heads:
// about 3.3 MB, and 50 KB of inputs: about 1 us at 3.35 TB/s. Its
// arithmetic with every row live is about 50 M multiply-adds (0.1 us at the
// bf16 tensor-core peak): bytes bound it.
//
// Design. One block of 512 threads; the R x D working set (features,
// normalised rows, K, V, the aggregate, the 4D FFN hidden) stays in shared
// memory (about 171 KB at the flagship shapes). Every matrix product is a
// row tile times a weight matrix, one thread per (output column, row
// group), so each weight is read once per pass and serves eight rows. One
// SM does the whole pass, so the weights stream at one SM's L2 bandwidth,
// far from the HBM bound: splitting the columns over a cluster is the work
// of a later change.

#include "common.cuh"

namespace {

// The packed arrays, in the order of the pointer array that
// refine_kernel.py::_layouts lays out (sublayer j = 2i + s).
enum Arg {
  WQ, WK, WV, WKR, WVR, WG, WS, WO, WF0, WF1, WH0, WH_HEAD, WH_OFF,
  LNQ_S, LNQ_B, LNS_S, LNS_B, LNR_S, LNR_B, BQ, BV, BVR, BG, BS, BO, POST_S,
  POST_B, FFP_S, FFP_B, BF0, BF1, FFQ_S, FFQ_B, BH0, LNH_S, LNH_B, BH_HEAD,
  BH_OFF,
  kNumArgs
};

struct Ptrs {
  const void* p[kNumArgs];
};

struct Params {
  const float* x_sub;      // [R, D]
  const void* pl_keys;     // [R, D] T
  const void* r_pl;        // [R, D] T
  const uint8_t* mask_pl;  // [R]
  const void* r_aa;        // [R, D] T
  const uint8_t* mask_a;   // [R]
  Ptrs w;
  float* out_head;         // [angle_size]
  float* out_off;          // [2]
  int L, R, D, H, Hd, angle_size;
};

size_t smem_floats(int R, int D, int H) {
  return (size_t)6 * R * D + (size_t)4 * R * D + (size_t)8 * D + kThreads +
         32 + (size_t)R * H + H;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) refine_kernel(Params p) {
  extern __shared__ float smem[];
  const int R = p.R, D = p.D, H = p.H, Hd = p.Hd;
  const int tid = threadIdx.x, bd = blockDim.x, RD = R * D;
  float* x = smem;             // [R, D] features
  float* dn = x + RD;          // [R, D] LN(x) query side, rounded
  float* a1 = dn + RD;         // [R, D] scratch
  float* a2 = a1 + RD;         // [R, D]
  float* a3 = a2 + RD;         // [R, D]
  float* a4 = a3 + RD;         // [R, D]
  float* h4 = a4 + RD;         // [R, 4D] FFN hidden
  float* q = h4 + 4 * RD;      // [D]
  float* agg0 = q + D;         // [D]
  float* v1 = agg0 + D;        // [D]
  float* v2 = v1 + D;          // [D]
  float* xr = v2 + D;          // [4D]
  float* part = xr + 4 * D;    // [blockDim]
  float* red = part + bd;      // [32]
  float* sc = red + 32;        // [R, H]
  float* ssum = sc + R * H;    // [H]
  auto M = [&](Arg a, int j, size_t per) {
    return static_cast<const T*>(p.w.p[a]) + (size_t)j * per;
  };
  auto V = [&](Arg a, int j, int per) {
    return static_cast<const float*>(p.w.p[a]) + (size_t)j * per;
  };
  const size_t DD = (size_t)D * D;

  for (int i = tid; i < RD; i += bd) x[i] = p.x_sub[i];
  __syncthreads();

  for (int j = 0; j < 2 * p.L; ++j) {
    const bool map = j % 2 == 0;
    rows_ln<T, true>(x, D, dn, D, R, D, V(LNQ_S, j, D), V(LNQ_B, j, D));
    // source rows (map keys, or the rows themselves) and relations
    const T* src = static_cast<const T*>(p.pl_keys);
    const T* rel = static_cast<const T*>(map ? p.r_pl : p.r_aa);
    for (int i = tid; i < RD; i += bd) {
      a1[i] = map ? to_f(src[i]) : x[i];
      a2[i] = to_f(rel[i]);
    }
    __syncthreads();
    rows_ln<T, true>(a1, D, a1, D, R, D, V(LNS_S, j, D), V(LNS_B, j, D));
    rows_ln<T, true>(a2, D, a2, D, R, D, V(LNR_S, j, D), V(LNR_B, j, D));
    // K = src_n wk + rn wkr; V = ((src_n wv + bv) + rn wvr) + bvr
    rows_mm<T>(a1, D, R, D, M(WK, j, DD), D, nullptr, a3, D, false);
    rows_mm<T>(a2, D, R, D, M(WKR, j, DD), D, nullptr, a3, D, true);
    rows_mm<T>(a1, D, R, D, M(WV, j, DD), D, V(BV, j, D), a4, D, false);
    rows_mm<T>(a2, D, R, D, M(WVR, j, DD), D, nullptr, a4, D, true);
    const float* bvr = V(BVR, j, D);
    for (int i = tid; i < RD; i += bd) a4[i] += bvr[i % D];
    __syncthreads();
    // row 0's query and its masked softmax over the R keys
    matvec<T>(dn, D, M(WQ, j, DD), D, V(BQ, j, D), q, part);
    const uint8_t* mask = map ? p.mask_pl : p.mask_a;
    const float scale = rsqrtf((float)Hd);
    for (int i = tid; i < R * H; i += bd) {
      const int r = i / H, h = i % H;
      float acc = 0.f;
      for (int d = 0; d < Hd; ++d)
        acc = fmaf(a3[r * D + h * Hd + d], q[h * Hd + d], acc);
      sc[i] = mask[r] ? acc * scale : -INFINITY;
    }
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31, nw = bd >> 5;
    for (int h = warp; h < H; h += nw) {
      float mx = -INFINITY;
      for (int r = lane; r < R; r += 32) mx = fmaxf(mx, sc[r * H + h]);
      mx = warp_max(mx);
      float s = 0.f;
      for (int r = lane; r < R; r += 32) {
        const float e = mask[r] ? expf(sc[r * H + h] - mx) : 0.f;
        sc[r * H + h] = e;
        s += e;
      }
      s = warp_sum(s);
      if (lane == 0) ssum[h] = fmaxf(s, 1e-30f);
    }
    __syncthreads();
    for (int d = tid; d < D; d += bd) {
      const int h = d / Hd;
      float acc = 0.f;
      for (int r = 0; r < R; ++r)
        if (mask[r]) acc = fmaf(sc[r * H + h] / ssum[h], a4[r * D + d], acc);
      agg0[d] = acc;
    }
    __syncthreads();
    // agg = row 0's aggregate, zero elsewhere (a1 fp32, a2 rounded)
    for (int i = tid; i < RD; i += bd) {
      a1[i] = i < D ? agg0[i] : 0.f;
      a2[i] = round_to<T>(a1[i]);
    }
    __syncthreads();
    // g = sigmoid((agg wg[:D] + dst_n wg[D:]) + bg); s = dst_n ws + bs
    rows_mm<T>(a2, D, R, D, M(WG, j, 2 * DD), D, nullptr, a3, D, false);
    rows_mm<T>(dn, D, R, D, M(WG, j, 2 * DD) + DD, D, nullptr, a3, D, true);
    rows_mm<T>(dn, D, R, D, M(WS, j, DD), D, V(BS, j, D), a4, D, false);
    const float* bg = V(BG, j, D);
    for (int i = tid; i < RD; i += bd) {
      const float g = sigmoid(a3[i] + bg[i % D]);
      a1[i] = a1[i] + g * (a4[i] - a1[i]);
      a2[i] = round_to<T>(a1[i]);
    }
    __syncthreads();
    // x = x + postnorm(to_out(agg))
    rows_mm<T>(a2, D, R, D, M(WO, j, DD), D, V(BO, j, D), a3, D, false);
    rows_ln<T, false>(a3, D, a3, D, R, D, V(POST_S, j, D), V(POST_B, j, D));
    for (int i = tid; i < RD; i += bd) x[i] += a3[i];
    __syncthreads();
    // x = x + ff_postnorm(ff_1(relu(ff_0(ff_prenorm(x)))))
    rows_ln<T, true>(x, D, a2, D, R, D, V(FFP_S, j, D), V(FFP_B, j, D));
    rows_mm<T>(a2, D, R, D, M(WF0, j, 4 * DD), 4 * D, V(BF0, j, 4 * D), h4,
               4 * D, false);
    for (int i = tid; i < 4 * RD; i += bd)
      h4[i] = round_to<T>(fmaxf(h4[i], 0.f));
    __syncthreads();
    rows_mm<T>(h4, 4 * D, R, 4 * D, M(WF1, j, 4 * DD), D, V(BF1, j, D), a3,
               D, false);
    rows_ln<T, false>(a3, D, a3, D, R, D, V(FFQ_S, j, D), V(FFQ_B, j, D));
    for (int i = tid; i < RD; i += bd) x[i] += a3[i];
    __syncthreads();
  }

  // heads on row 0: MLPLayer = dense -> LayerNorm -> relu -> dense
  for (int hi = 0; hi < 2; ++hi) {
    round_vec<T>(x, xr, D);
    matvec<T>(xr, D, M(WH0, hi, DD), D, V(BH0, hi, D), v1, part);
    layer_norm(v1, v2, V(LNH_S, hi, D), V(LNH_B, hi, D), D, red);
    for (int i = tid; i < D; i += bd) xr[i] = round_to<T>(fmaxf(v2[i], 0.f));
    __syncthreads();
    if (hi == 0)
      matvec<T>(xr, D, M(WH_HEAD, 0, 0), p.angle_size, V(BH_HEAD, 0, 0),
                p.out_head, part);
    else
      matvec<T>(xr, D, M(WH_OFF, 0, 0), 2, V(BH_OFF, 0, 0), p.out_off,
                part);
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.R, p.D, p.H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      refine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  refine_kernel<T><<<1, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (pl_keys, r_pl, r_aa and the packed
// matrices). ptrs: host array of kNumArgs device pointers. Returns a
// cudaError_t; 0 on a successful launch.
extern "C" int infgen_refine(int dtype, const float* x_sub,
                             const void* pl_keys, const void* r_pl,
                             const uint8_t* mask_pl, const void* r_aa,
                             const uint8_t* mask_a, const uint64_t* ptrs,
                             float* out_head, float* out_off, int L, int R,
                             int D, int H, int Hd, int angle_size,
                             void* stream) {
  Params p;
  p.x_sub = x_sub;
  p.pl_keys = pl_keys;
  p.r_pl = r_pl;
  p.mask_pl = mask_pl;
  p.r_aa = r_aa;
  p.mask_a = mask_a;
  for (int i = 0; i < kNumArgs; ++i)
    p.w.p[i] = reinterpret_cast<const void*>(ptrs[i]);
  p.out_head = out_head;
  p.out_off = out_off;
  p.L = L;
  p.R = R;
  p.D = D;
  p.H = H;
  p.Hd = Hd;
  p.angle_size = angle_size;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
