"""Per-insert heading/offset refine as one CUDA kernel (port of
infgen_tpu/ops/refine_kernel.py::refine_kernel; the CUDA source is
csrc/refine.cu, whose header states its bound and design).

  pack_refine_params  the 2L refine sublayers' (trunk layers 0..L-1 in the
                      order j = 2i + s: s=0 map pt2a_i, s=1 agent a2a_i) and
                      the two heads' parameters: matrices in the compute
                      dtype, vectors fp32, and refine_tiles, the per-CTA
                      weight stages the kernel streams
  kernel_accepts      the widths the kernel takes
  refine_reference    the same math in plain PyTorch (the CPU path, and what
                      the kernel is held against on the card), sublayer by
                      sublayer (refine_sublayer) and then the heads
                      (refine_heads)
  refine_kernel       the wrapper: launches the kernel on CUDA tensors, takes
                      the plain version for CPU tensors, raises otherwise;
                      optionally also returns x after every sublayer (a
                      stage-wise check reads it). Both take a leading lane
                      axis (a batched rollout's scenarios, one insert each)
                      and a lane mask

The inserted agent is row 0 of an R-row neighbourhood; only it attends. The
other rows take the zero-aggregate closed form, which is the shared gated
update with agg == 0, and serve as row 0's agent keys. Outputs: the heading
logits [angle_size] and the two offset values before tanh. The TPU version's
128-lane output padding and head selector are gone.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import ctypes
import torch
import torch.nn.functional as F

from infgen_torch.ops.seed_kernel import (_DTYPE_CODE, SMEM_LIMIT, _check,
                                          _flat, _ln, _views, ptr_array)

_HEADS = ("seed_heading_rel_token_predict_head", "seed_offset_xy_predict_head")
# the kernel's split (csrc/refine.cu): one CTA per head of SLICE columns, a
# cluster of 2..MAX_CLUSTER CTAs, at most MAX_ROWS rows (two m16 tiles)
SLICE, MAX_CLUSTER, MAX_ROWS = 16, 8, 32
_SMEM_OK = set()   # (dtype, L, D, angle_size) whose shared memory fits


@dataclass
class RefinePack:
    weights: torch.Tensor          # flat, compute dtype
    vectors: torch.Tensor          # flat, fp32
    w: Dict[str, torch.Tensor]     # views into `weights`
    v: Dict[str, torch.Tensor]     # views into `vectors`
    L: int
    D: int
    angle_size: int
    tiles: Optional[torch.Tensor] = None   # refine_tiles (kernel widths)

    @property
    def dtype(self):
        return self.weights.dtype

    @classmethod
    def of(cls, weights, vectors, tiles, L: int, D: int,
           angle_size: int) -> "RefinePack":
        """The pack over the buffers that pack_refine_params made (or their
        counterparts in a traced program): the views are rebuilt."""
        mats, vecs = _layouts(L, D, angle_size)
        return cls(weights, vectors, _views(weights, mats),
                   _views(vectors, vecs), L, D, angle_size, tiles)

    def views(self) -> List[torch.Tensor]:
        """Every matrix's view, then every vector's, in layout order."""
        return [*self.w.values(), *self.v.values()]

    @property
    def ptrs(self) -> ctypes.Array:
        """data_ptr of each vector, in the order of the pointer array that
        csrc/refine.cu reads (its `Arg` enum)."""
        return ptr_array(self.v.values())


def _layouts(L: int, D: int, angle_size: int):
    """(name, shape) of each packed array: the matrices (read by the plain
    version and refine_tiles) and the vectors, in the order of the pointer
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


def kernel_accepts(dtype, D: int, num_heads: int, head_dim: int,
                   rows: int) -> bool:
    """Whether csrc/refine.cu takes these widths: fp32 or bf16, heads of
    SLICE = 16 columns (one CTA each), 2 to 8 of them (D = 32 .. 128), and
    at most 32 rows."""
    return (dtype in (torch.float32, torch.bfloat16) and head_dim == SLICE
            and num_heads * head_dim == D
            and 2 <= num_heads <= MAX_CLUSTER and 1 <= rows <= MAX_ROWS)


def tile_layout(L: int, D: int, angle_size: int, dtype) -> Dict[str, int]:
    """The per-CTA weight stages of csrc/refine.cu (its TileLayout): rows
    of W^T padded by 16 bytes (`ld` for D, `ld4` for 4D elements); per CTA
    4L + 1 stages of `slot` elements: per sublayer an A stage (8 blocks of
    16 rows) and a B stage (to_out 16, ff_0 64 rows of ld; ff_1 16 rows of
    ld4), then the heads (2 x 16 rows, nh heading and no offset rows; ch
    and co of them are this CTA's columns)."""
    kc = D // SLICE
    pad = 16 // torch.empty((), dtype=dtype).element_size()
    ld, ld4 = D + pad, 4 * D + pad
    ch, co = -(-angle_size // kc), -(-2 // kc)
    nh, no = -(-ch // 8) * 8, -(-co // 8) * 8
    a = 8 * SLICE * ld
    b = 5 * SLICE * ld + SLICE * ld4
    h = (2 * SLICE + nh + no) * ld
    return dict(kc=kc, ld=ld, ld4=ld4, ch=ch, co=co, nh=nh, no=no, a=a, b=b,
                h=h, slot=max(a, b, h), stages=4 * L + 1)


def _heads_of(m: torch.Tensor, kc: int, per: int) -> torch.Tensor:
    """[D, n] output columns -> [kc, per, D]: CTA c's columns [c per,
    c per + per) as rows, zero past n."""
    D, n = m.shape
    return F.pad(m, (0, kc * per - n)).T.reshape(kc, per, D)


@torch.no_grad()
def refine_tiles(w: Dict[str, torch.Tensor], L: int, D: int,
                 angle_size: int) -> torch.Tensor:
    """The kernel's weights, [kc, 4L + 1, slot] in the pack's dtype (see
    tile_layout): CTA c's column slice of every product as rows of W^T,
    each row padded to ld (ld4 for ff_1). A stage j: to_q, to_k, w_kr,
    to_v, w_vr, to_g's dst_n half and to_s at columns [16c, 16c + 16), then
    to_g's aggregate-half rows [16c, 16c + 16) (every column); B stage j:
    to_out's columns, ff_0's columns [64c, 64c + 64), ff_1's columns; the
    heads: both Dense_0's columns, then CTA c's heading-bin and offset
    columns. `w` holds the pack's matrices."""
    lay = tile_layout(L, D, angle_size, w["wq"].dtype)
    kc, ld, ld4, slot = lay["kc"], lay["ld"], lay["ld4"], lay["slot"]
    J = 2 * L
    cols = lambda m: m.transpose(-1, -2).reshape(J, kc, -1, m.shape[-2])
    rows = lambda t, width: F.pad(t, (0, width - t.shape[-1])).reshape(
        *t.shape[:2], -1)
    wg = w["wg"]
    a = torch.cat([cols(w[n]) for n in ("wq", "wk", "wkr", "wv", "wvr")]
                  + [cols(wg[:, D:]), cols(w["ws"]),
                     wg[:, :D].reshape(J, kc, SLICE, D)], 2)  # [J, kc, 128, D]
    b = torch.cat([rows(cols(w["wo"]), ld), rows(cols(w["wf0"]), ld),
                   rows(cols(w["wf1"]), ld4)], 2)
    heads = torch.cat([w["wh0"].transpose(-1, -2).reshape(2, kc, SLICE, D)
                       .transpose(0, 1).reshape(kc, 2 * SLICE, D),
                       F.pad(_heads_of(w["wh_head"], kc, lay["ch"]),
                             (0, 0, 0, lay["nh"] - lay["ch"])),
                       F.pad(_heads_of(w["wh_off"], kc, lay["co"]),
                             (0, 0, 0, lay["no"] - lay["co"]))], 1)
    out = torch.zeros((kc, lay["stages"], slot), dtype=w["wq"].dtype,
                      device=w["wq"].device)
    out[:, 0:2 * J:2, :lay["a"]] = rows(a, ld).transpose(0, 1)
    out[:, 1:2 * J:2, :lay["b"]] = b.transpose(0, 1)
    out[:, 2 * J, :lay["h"]] = F.pad(heads, (0, ld - D)).reshape(kc, -1)
    return out


@torch.no_grad()
def pack_refine_params(decoder, L: int, angle_size: int,
                       dtype=None) -> RefinePack:
    """Stack the refine sublayers (j = 2i + s) and the heading / offset
    heads of an AgentDecoder. Matrices go to the compute dtype (`dtype`,
    None = fp32) in [in, out] layout; LayerNorm parameters and biases stay
    fp32. The query LayerNorm is prenorm_dst for the map layers (bipartite)
    and prenorm_src for the agent layers. At widths of 16-column heads that
    the kernel takes (2 to 8 heads) the pack also holds refine_tiles."""
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
    tiles = refine_tiles(w, L, D, angle_size) \
        if D % SLICE == 0 and 2 <= D // SLICE <= MAX_CLUSTER else None
    return RefinePack(weights, vectors, w, v, L, D, angle_size, tiles)


def _mm(pack, a, m):
    """a @ m with a rounded to the compute dtype, products and sums fp32."""
    return a.to(pack.dtype).to(torch.float32) @ m.to(torch.float32)


def refine_sublayer(pack: RefinePack, j: int, x, pl_keys, r_pl, mask_pl,
                    r_aa, mask_a, num_heads: int, head_dim: int):
    """Sublayer j of the pass on features x [R, D] fp32 (refine_reference's
    step): row 0 attends to the map keys (j even) or to the rows of x (j
    odd); every row takes the gated update and FFN epilogue, rows but 0
    with a zero aggregate. Returns the new x."""
    f32 = torch.float32
    w, v, D = pack.w, pack.v, pack.D
    R = x.shape[0]
    H, Hd = num_heads, head_dim
    row0 = (torch.arange(R, device=x.device) == 0)[:, None]
    mm = lambda a, m: _mm(pack, a, m)
    dst_n = _ln(x, v["lnq_s"][j], v["lnq_b"][j])
    src, r, m = (pl_keys.to(f32), r_pl.to(f32), mask_pl) if j % 2 == 0 \
        else (x, r_aa.to(f32), mask_a)
    rn = _ln(r, v["lnr_s"][j], v["lnr_b"][j])
    src_n = _ln(src, v["lns_s"][j], v["lns_b"][j])
    K = mm(src_n, w["wk"][j]) + mm(rn, w["wkr"][j])
    V = mm(src_n, w["wv"][j]) + v["bv"][j] + mm(rn, w["wvr"][j]) \
        + v["bvr"][j]
    q = mm(dst_n[0], w["wq"][j]) + v["bq"][j]
    maskf = m.to(f32)
    scores = (K * q).reshape(R, H, Hd).sum(-1) * Hd ** -0.5 \
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
    return x1 + _ln(h, v["ffq_s"][j], v["ffq_b"][j])


def refine_heads(pack: RefinePack, x0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The heading-bin and offset heads on row 0's features x0 [D]:
    MLPLayer = dense -> LayerNorm -> relu -> dense."""
    w, v = pack.w, pack.v
    outs = []
    for hi, (wn, bn) in enumerate((("wh_head", "bh_head"),
                                   ("wh_off", "bh_off"))):
        h = _mm(pack, x0, w["wh0"][hi]) + v["bh0"][hi]
        h = F.relu(_ln(h, v["lnh_s"][hi], v["lnh_b"][hi]))
        outs.append(_mm(pack, h, w[wn]) + v[bn])
    return outs[0], outs[1]


def _sublayers(pack: RefinePack, x_sub, *args):
    """x after each sublayer of the plain pass, a list of [R, D] fp32."""
    xs = [x_sub.to(torch.float32)]
    for j in range(2 * pack.L):
        xs.append(refine_sublayer(pack, j, xs[-1], *args))
    return xs[1:]


def _lanes_of(pack: RefinePack, x_sub, args, lanes, trace: bool):
    """The plain pass of each lane ([B, R, ...] inputs): (head [B, angle],
    offset [B, 2]) and with `trace` [B, 2L, R, D]; a lane that `lanes`
    switches off gives zeros, as the kernel's masked-off clusters do."""
    B = x_sub.shape[0]
    on = [True] * B if lanes is None else lanes.tolist()
    outs = []
    for b in range(B):
        xs = _sublayers(pack, x_sub[b], *(a[b] for a in args[:5]), *args[5:])
        out = (*refine_heads(pack, xs[-1][0]), torch.stack(xs))
        outs.append(out if on[b] else tuple(torch.zeros_like(t)
                                            for t in out))
    stacked = tuple(torch.stack(parts) for parts in zip(*outs))
    return stacked if trace else stacked[:2]


def refine_reference(pack: RefinePack, x_sub, pl_keys, r_pl, mask_pl, r_aa,
                     mask_a, num_heads: int, head_dim: int, lanes=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch refine pass, the kernel's math: matmul inputs rounded
    to the compute dtype, products and sums in fp32; fp32 LayerNorm (eps
    1e-6) and softmax; an all-masked key set aggregates to zero. With a
    lane axis (every input [B, R, ...]) each lane is evaluated as a call of
    its own would evaluate it, into head [B, angle] and offset [B, 2]; a
    lane that `lanes` [B] bool switches off gives zeros."""
    args = (pl_keys, r_pl, mask_pl, r_aa, mask_a, num_heads, head_dim)
    if x_sub.dim() == 3:
        return _lanes_of(pack, x_sub, args, lanes, False)
    x = _sublayers(pack, x_sub, *args)[-1]
    return refine_heads(pack, x[0])


def refine_kernel(pack: RefinePack, x_sub, pl_keys, r_pl, mask_pl, r_aa,
                  mask_a, num_heads: int, head_dim: int, trace: bool = False,
                  lanes=None):
    """One refine pass. x_sub [R, D] fp32 (row 0 the inserted agent, rows
    past the real neighbourhood zero); pl_keys / r_pl [R, D] (map key k
    and its relation), r_aa [R, D] (agent key row k's relation; rows 0 and
    padding masked) in the pack's compute dtype; mask_pl / mask_a [R] bool.
    Returns (heading logits [angle_size], offset [2] before tanh), fp32,
    and with `trace` also x after each sublayer, [2L, R, D] fp32 (the
    kernel computes only row 0 of the last one). Runs the registered op
    `infgen::refine`: CUDA tensors launch csrc/refine.cu on the current
    stream (counted in `refine_kernel.launches`); CPU tensors take the
    plain version (refine_reference). The kernel takes the widths of
    kernel_accepts; others raise.

    Lanes: every input [B, R, ...] refines every lane's insert in one
    launch, one cluster per lane, into head [B, angle_size], offset [B, 2]
    (and trace [B, 2L, R, D]); `lanes` [B] bool switches lanes off (their
    outputs are zeros). One launch counts once, whatever B."""
    if x_sub.device.type not in ("cpu", "cuda"):
        raise ValueError(f"refine_kernel: unsupported device {x_sub.device}")
    if lanes is not None and x_sub.dim() != 3:
        raise ValueError("refine_kernel: a lane mask needs a lane axis")
    head, off, tr = torch.ops.infgen.refine(
        pack.views(), pack.tiles, x_sub, pl_keys, r_pl, mask_pl, r_aa,
        mask_a, pack.L, pack.angle_size, num_heads, head_dim, trace, lanes)
    return (head, off, tr) if trace else (head, off)


def _op_pack(views, tiles, L, D, angle_size) -> RefinePack:
    """The RefinePack of an op's arguments (its flat buffers are not
    needed)."""
    mats, vecs = _layouts(L, D, angle_size)
    names = [n for n, _ in mats + vecs]
    return RefinePack(views[0], views[len(mats)],
                      dict(zip(names[:len(mats)], views[:len(mats)])),
                      dict(zip(names[len(mats):], views[len(mats):])), L, D,
                      angle_size, tiles)


@torch.library.custom_op("infgen::refine", mutates_args=(),
                         device_types="cpu")
def _refine_op(views: List[torch.Tensor], tiles: Optional[torch.Tensor],
               x_sub: torch.Tensor, pl_keys: torch.Tensor, r_pl: torch.Tensor,
               mask_pl: torch.Tensor, r_aa: torch.Tensor,
               mask_a: torch.Tensor, L: int, angle_size: int, num_heads: int,
               head_dim: int, trace: bool, lanes: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    pack = _op_pack(views, tiles, L, x_sub.shape[-1], angle_size)
    args = (pl_keys, r_pl, mask_pl, r_aa, mask_a, num_heads, head_dim)
    if x_sub.dim() == 3:
        out = _lanes_of(pack, x_sub, args, lanes, True)
    else:
        xs = _sublayers(pack, x_sub, *args)
        out = (*refine_heads(pack, xs[-1][0]), torch.stack(xs))
    tr = out[2] if trace else x_sub.new_empty((0,))
    return out[0].contiguous(), out[1].contiguous(), tr.contiguous()


@_refine_op.register_fake
def _(views, tiles, x_sub, pl_keys, r_pl, mask_pl, r_aa, mask_a, L,
      angle_size, num_heads, head_dim, trace, lanes):
    lead = tuple(x_sub.shape[:-2])
    R, D = x_sub.shape[-2:]
    f32 = dict(dtype=torch.float32)
    tr = x_sub.new_empty((*lead, 2 * L, R, D), **f32) if trace \
        else x_sub.new_empty((0,), **f32)
    return (x_sub.new_empty((*lead, angle_size), **f32),
            x_sub.new_empty((*lead, 2), **f32), tr)


@_refine_op.register_kernel("cuda")
def _(views, tiles, x_sub, pl_keys, r_pl, mask_pl, r_aa, mask_a, L,
      angle_size, num_heads, head_dim, trace, lanes):
    dev = x_sub.device
    batched = x_sub.dim() == 3
    D, cdt = x_sub.shape[-1], views[0].dtype
    lead = tuple(x_sub.shape[:1]) if batched else ()
    R = x_sub.shape[-2]
    if not kernel_accepts(cdt, D, num_heads, head_dim, R):
        raise ValueError(
            "refine_kernel takes fp32 or bf16, 2 to 8 heads of 16 columns "
            f"(num_heads * head_dim == D) and at most 32 rows, got {cdt}, "
            f"D={D}, {num_heads} heads of {head_dim}, {R} rows")
    _check("x_sub", x_sub, torch.float32, (*lead, R, D), dev)
    for name, t in (("pl_keys", pl_keys), ("r_pl", r_pl), ("r_aa", r_aa)):
        _check(name, t, cdt, (*lead, R, D), dev)
    _check("mask_pl", mask_pl, torch.bool, (*lead, R), dev)
    _check("mask_a", mask_a, torch.bool, (*lead, R), dev)
    if lanes is not None:
        _check("lanes", lanes, torch.bool, lead, dev)
    mats, vecs = _layouts(L, D, angle_size)
    if len(views) != len(mats) + len(vecs):
        raise ValueError(f"refine_kernel: {len(views)} views, expected "
                         f"{len(mats) + len(vecs)}")
    for (name, shape), t in zip(vecs, views[len(mats):]):
        _check(name, t, torch.float32, shape, dev)
    lay = tile_layout(L, D, angle_size, cdt)
    _check("tiles", tiles, cdt, (lay["kc"], lay["stages"], lay["slot"]), dev)
    from infgen_torch.ops.build import library
    shape = (_DTYPE_CODE[cdt], L, D, angle_size)
    if shape not in _SMEM_OK:
        smem = library().infgen_refine_smem(*shape)
        if smem > SMEM_LIMIT:
            raise ValueError(f"refine_kernel: {smem} B of shared memory "
                             "exceed the 227 KB a block can use")
        _SMEM_OK.add(shape)
    f32 = dict(dtype=torch.float32, device=dev)
    head = torch.empty((*lead, angle_size), **f32)
    off = torch.empty((*lead, 2), **f32)
    tr = torch.zeros((*lead, 2 * L, R, D), **f32) if trace \
        else torch.empty((0,), **f32)
    err = library().infgen_refine(
        _DTYPE_CODE[cdt], x_sub.data_ptr(), pl_keys.data_ptr(),
        r_pl.data_ptr(), mask_pl.data_ptr(), r_aa.data_ptr(),
        mask_a.data_ptr(), ctypes.addressof(ptr_array(views[len(mats):])),
        tiles.data_ptr(), head.data_ptr(), off.data_ptr(),
        tr.data_ptr() if trace else 0,
        0 if lanes is None else lanes.data_ptr(), lead[0] if lead else 1,
        L, R, D, num_heads, head_dim, angle_size,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"refine kernel launch failed: cudaError {err}")
    refine_kernel.launches += 1
    return head, off, tr


refine_kernel.launches = 0
