"""Per-insert heading/offset refine as one CUDA kernel (port of
infgen_tpu/ops/refine_kernel.py::refine_kernel; the CUDA source is
csrc/refine.cu, whose header states its bound and design).

  pack_refine_params  the 2L refine sublayers' (trunk layers 0..L-1 in the
                      order j = 2i + s: s=0 map pt2a_i, s=1 agent a2a_i) and
                      the two heads' parameters: matrices in the compute
                      dtype, vectors fp32
  refine_reference    the same math in plain PyTorch (the CPU path, and what
                      the kernel is held against on the card)
  refine_kernel       the wrapper: launches the kernel on CUDA tensors, takes
                      the plain version for CPU tensors, raises otherwise

The inserted agent is row 0 of an R-row neighbourhood; only it attends. The
other rows take the zero-aggregate closed form, which is the shared gated
update with agg == 0, and serve as row 0's agent keys. Outputs: the heading
logits [angle_size] and the two offset values before tanh. The TPU version's
128-lane output padding and head selector are gone.
"""

from dataclasses import dataclass
from typing import Dict, Tuple

import ctypes
import torch
import torch.nn.functional as F

from infgen_torch.ops.seed_kernel import (_DTYPE_CODE, _check, _flat, _ln,
                                          _ptr_array)

_HEADS = ("seed_heading_rel_token_predict_head", "seed_offset_xy_predict_head")


@dataclass
class RefinePack:
    weights: torch.Tensor          # flat, compute dtype
    vectors: torch.Tensor          # flat, fp32
    w: Dict[str, torch.Tensor]     # views into `weights`
    v: Dict[str, torch.Tensor]     # views into `vectors`
    ptrs: ctypes.Array             # data_ptr of each view, layout order
    L: int
    D: int
    angle_size: int

    @property
    def dtype(self):
        return self.weights.dtype


def _layouts(L: int, D: int, angle_size: int):
    """(name, shape) of each packed array, in the order of the pointer
    array that csrc/refine.cu reads (its `Arg` enum)."""
    J = 2 * L
    mats = [(n, (J, D, D)) for n in ("wq", "wk", "wv", "wkr", "wvr")]
    mats += [("wg", (J, 2 * D, D)), ("ws", (J, D, D)), ("wo", (J, D, D)),
             ("wf0", (J, D, 4 * D)), ("wf1", (J, 4 * D, D)),
             ("wh0", (2, D, D)), ("wh_head", (D, angle_size)),
             ("wh_off", (D, 2))]
    vecs = [(n, (J, D)) for n in ("lnq_s", "lnq_b", "lns_s", "lns_b",
                                  "lnr_s", "lnr_b", "bq", "bv", "bvr", "bg",
                                  "bs", "bo", "post_s", "post_b", "ffp_s",
                                  "ffp_b")]
    vecs += [("bf0", (J, 4 * D))]
    vecs += [(n, (J, D)) for n in ("bf1", "ffq_s", "ffq_b")]
    vecs += [(n, (2, D)) for n in ("bh0", "lnh_s", "lnh_b")]
    vecs += [("bh_head", (angle_size,)), ("bh_off", (2,))]
    return mats, vecs


@torch.no_grad()
def pack_refine_params(decoder, L: int, angle_size: int,
                       dtype=None) -> RefinePack:
    """Stack the refine sublayers (j = 2i + s) and the heading / offset
    heads of an AgentDecoder. Matrices go to the compute dtype (`dtype`,
    None = fp32) in [in, out] layout; LayerNorm parameters and biases stay
    fp32. The query LayerNorm is prenorm_dst for the map layers (bipartite)
    and prenorm_src for the agent layers."""
    dtype = dtype or torch.float32
    subs = []
    for i in range(L):
        subs += [getattr(decoder, f"pt2a_{i}"), getattr(decoder, f"a2a_{i}")]
    st = lambda get: torch.stack([get(p, j) for j, p in enumerate(subs)])
    lnq = lambda p, j: p.prenorm_dst if j % 2 == 0 else p.prenorm_src
    parts = dict(
        wq=st(lambda p, j: p.to_q.weight.T), bq=st(lambda p, j: p.to_q.bias),
        wk=st(lambda p, j: p.to_k.weight.T),
        wv=st(lambda p, j: p.to_v.weight.T), bv=st(lambda p, j: p.to_v.bias),
        wkr=st(lambda p, j: p.w_kr), wvr=st(lambda p, j: p.w_vr),
        bvr=st(lambda p, j: p.b_vr),
        wg=st(lambda p, j: p.to_g.weight.T), bg=st(lambda p, j: p.to_g.bias),
        ws=st(lambda p, j: p.to_s.weight.T), bs=st(lambda p, j: p.to_s.bias),
        wo=st(lambda p, j: p.to_out.weight.T),
        bo=st(lambda p, j: p.to_out.bias),
        wf0=st(lambda p, j: p.ff_0.weight.T), bf0=st(lambda p, j: p.ff_0.bias),
        wf1=st(lambda p, j: p.ff_1.weight.T), bf1=st(lambda p, j: p.ff_1.bias),
        lnq_s=st(lambda p, j: lnq(p, j).weight),
        lnq_b=st(lambda p, j: lnq(p, j).bias),
        lns_s=st(lambda p, j: p.prenorm_src.weight),
        lns_b=st(lambda p, j: p.prenorm_src.bias),
        lnr_s=st(lambda p, j: p.prenorm_r.weight),
        lnr_b=st(lambda p, j: p.prenorm_r.bias),
        post_s=st(lambda p, j: p.postnorm.weight),
        post_b=st(lambda p, j: p.postnorm.bias),
        ffp_s=st(lambda p, j: p.ff_prenorm.weight),
        ffp_b=st(lambda p, j: p.ff_prenorm.bias),
        ffq_s=st(lambda p, j: p.ff_postnorm.weight),
        ffq_b=st(lambda p, j: p.ff_postnorm.bias),
    )
    hs = [getattr(decoder, h) for h in _HEADS]
    D = hs[0].Dense_0.weight.shape[1]
    parts["wh0"] = torch.stack([h.Dense_0.weight.T for h in hs])
    parts["bh0"] = torch.stack([h.Dense_0.bias for h in hs])
    parts["lnh_s"] = torch.stack([h.LayerNorm_0.weight for h in hs])
    parts["lnh_b"] = torch.stack([h.LayerNorm_0.bias for h in hs])
    parts["wh_head"], parts["bh_head"] = hs[0].Dense_1.weight.T, \
        hs[0].Dense_1.bias
    parts["wh_off"], parts["bh_off"] = hs[1].Dense_1.weight.T, \
        hs[1].Dense_1.bias
    mats, vecs = _layouts(L, D, angle_size)
    device = parts["wq"].device
    weights, w = _flat(parts, mats, dtype, device)
    vectors, v = _flat(parts, vecs, torch.float32, device)
    return RefinePack(weights, vectors, w, v, _ptr_array({**w, **v},
                                                         mats + vecs),
                      L, D, angle_size)


def refine_reference(pack: RefinePack, x_sub, pl_keys, r_pl, mask_pl, r_aa,
                     mask_a, num_heads: int, head_dim: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch refine pass, the kernel's math: matmul inputs rounded
    to the compute dtype, products and sums in fp32; fp32 LayerNorm (eps
    1e-6) and softmax; an all-masked key set aggregates to zero."""
    f32, cdt = torch.float32, pack.dtype
    w, v = pack.w, pack.v
    H, Hd, D = num_heads, head_dim, pack.D
    scale = Hd ** -0.5

    def mm(a, m):
        return a.to(cdt).to(f32) @ m.to(f32)

    x = x_sub.to(f32)
    R = x.shape[0]
    plk, rpl, raa = pl_keys.to(f32), r_pl.to(f32), r_aa.to(f32)
    row0 = (torch.arange(R, device=x.device) == 0)[:, None]
    for j in range(2 * pack.L):
        s = j % 2
        dst_n = _ln(x, v["lnq_s"][j], v["lnq_b"][j])
        src, r, m = (plk, rpl, mask_pl) if s == 0 else (x, raa, mask_a)
        rn = _ln(r, v["lnr_s"][j], v["lnr_b"][j])
        src_n = _ln(src, v["lns_s"][j], v["lns_b"][j])
        K = mm(src_n, w["wk"][j]) + mm(rn, w["wkr"][j])
        V = mm(src_n, w["wv"][j]) + v["bv"][j] + mm(rn, w["wvr"][j]) \
            + v["bvr"][j]
        q = mm(dst_n[0], w["wq"][j]) + v["bq"][j]
        maskf = m.to(f32)
        scores = (K * q).reshape(R, H, Hd).sum(-1) * scale \
            + (maskf[:, None] - 1.0) * 1e9
        mx = scores.max(0, keepdim=True).values
        e = torch.exp(scores - mx) * maskf[:, None]
        attn = e / torch.clamp(e.sum(0, keepdim=True), min=1e-30)
        agg0 = (attn[:, :, None] * V.reshape(R, H, Hd)).sum(0).reshape(-1)
        # zero aggregate everywhere but row 0: the shared epilogue with
        # agg == 0 is the zero-aggregate closed form
        agg = torch.where(row0, agg0[None], 0.0)
        g = torch.sigmoid(mm(agg, w["wg"][j][:D]) + mm(dst_n, w["wg"][j][D:])
                          + v["bg"][j])
        agg = agg + g * (mm(dst_n, w["ws"][j]) + v["bs"][j] - agg)
        x1 = x + _ln(mm(agg, w["wo"][j]) + v["bo"][j], v["post_s"][j],
                     v["post_b"][j])
        h = _ln(x1, v["ffp_s"][j], v["ffp_b"][j])
        h = F.relu(mm(h, w["wf0"][j]) + v["bf0"][j])
        h = mm(h, w["wf1"][j]) + v["bf1"][j]
        x = x1 + _ln(h, v["ffq_s"][j], v["ffq_b"][j])

    outs = []
    for hi, (wn, bn) in enumerate((("wh_head", "bh_head"),
                                   ("wh_off", "bh_off"))):
        h = mm(x[0], w["wh0"][hi]) + v["bh0"][hi]
        h = F.relu(_ln(h, v["lnh_s"][hi], v["lnh_b"][hi]))
        outs.append(mm(h, w[wn]) + v[bn])
    return outs[0], outs[1]


def refine_kernel(pack: RefinePack, x_sub, pl_keys, r_pl, mask_pl, r_aa,
                  mask_a, num_heads: int, head_dim: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One refine pass. x_sub [R, D] fp32 (row 0 the inserted agent, rows
    past the real neighbourhood zero); pl_keys / r_pl [R, D] (map key k
    and its relation), r_aa [R, D] (agent key row k's relation; rows 0 and
    padding masked) in the pack's compute dtype; mask_pl / mask_a [R] bool.
    Returns (heading logits [angle_size], offset [2] before tanh), fp32.
    CUDA tensors launch csrc/refine.cu on the current stream (counted in
    `refine_kernel.launches`); CPU tensors take refine_reference."""
    dev = x_sub.device
    if dev.type == "cpu":
        return refine_reference(pack, x_sub, pl_keys, r_pl, mask_pl, r_aa,
                                mask_a, num_heads, head_dim)
    if dev.type != "cuda":
        raise ValueError(f"refine_kernel: unsupported device {dev}")
    D, Ah, cdt = pack.D, pack.angle_size, pack.dtype
    R = x_sub.shape[0]
    if cdt not in _DTYPE_CODE:
        raise ValueError(f"refine_kernel: compute dtype {cdt} unsupported")
    if num_heads * head_dim != D or D > 512 or R > 64:
        raise ValueError("refine_kernel needs num_heads * head_dim == D <= "
                         "512 and at most 64 rows")
    _check("x_sub", x_sub, torch.float32, (R, D), dev)
    for name, t in (("pl_keys", pl_keys), ("r_pl", r_pl), ("r_aa", r_aa)):
        _check(name, t, cdt, (R, D), dev)
    _check("mask_pl", mask_pl, torch.bool, (R,), dev)
    _check("mask_a", mask_a, torch.bool, (R,), dev)
    _check("weights", pack.weights, cdt, pack.weights.shape, dev)
    _check("vectors", pack.vectors, torch.float32, pack.vectors.shape, dev)

    from infgen_torch.ops.build import library
    lib = library()
    head = torch.empty((Ah,), dtype=torch.float32, device=dev)
    off = torch.empty((2,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.infgen_refine(
        _DTYPE_CODE[cdt], x_sub.data_ptr(), pl_keys.data_ptr(),
        r_pl.data_ptr(), mask_pl.data_ptr(), r_aa.data_ptr(),
        mask_a.data_ptr(), ctypes.addressof(pack.ptrs), head.data_ptr(),
        off.data_ptr(), pack.L, R, D, num_heads, head_dim, Ah, stream)
    if err != 0:
        raise RuntimeError(f"refine kernel launch failed: cudaError {err}")
    refine_kernel.launches += 1
    return head, off


refine_kernel.launches = 0
