"""One insertion-seed evaluation: the seed stack + heads as one CUDA kernel
(port of infgen_tpu/ops/seed_kernel.py::seed_eval_kernel and
::seed_eval_full_kernel; the CUDA sources are csrc/seed_eval.cu and
csrc/seed_eval_full.cu, whose headers state their bounds and designs).

  pack_seed_params   the 3L sublayers' and 4 heads' parameters in two flat
                     buffers: matrices in the compute dtype, vectors fp32
  seed_eval_reference  the same math in plain PyTorch (the CPU path, and
                     what the kernel is held against on the card)
  seed_eval_kernel   the wrapper: launches the kernel on CUDA tensors, takes
                     the plain version for CPU tensors, raises otherwise.
                     Both take a leading lane axis (a batched rollout's
                     scenarios, one evaluation each) and a lane mask

  pack_seed_params_full / seed_eval_full_reference / seed_eval_full_kernel
                     the same with the per-step precompute folded in: the
                     occupancy MLP (fp32) and occ2sa values, the map K/V
                     (rollout-invariant k0 / v0 plus the geometry terms) and
                     the agent rows' zero-aggregate key chain and K/V, all
                     from raw inputs; with the same lane axis and lane mask

Outputs: small [3, 4] fp32 (rows state / type / shape; leading 2 / 3 / 3
columns meaningful) and pos [G] fp32 grid-cell logits. The TPU version's
padding (small heads to D, the grid head to a multiple of 128) and its
head-selector matrix are gone.
"""

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

SMALL_COLS = 4
_HEADS = ("seed_state_predict_head", "seed_type_predict_head",
          "seed_shape_predict_head", "seed_pos_rel_token_predict_head")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_OK = set()        # seed_eval shapes whose shared memory fits
_FULL_SMEM_OK = set()   # seed_eval_full shapes whose shared memory fits
SMEM_LIMIT = 232448     # bytes of shared memory a block can use


@dataclass
class SeedPack:
    weights: torch.Tensor          # flat, compute dtype
    vectors: torch.Tensor          # flat, fp32
    w: Dict[str, torch.Tensor]     # views into `weights`
    v: Dict[str, torch.Tensor]     # views into `vectors`
    L: int
    D: int
    G: int

    @property
    def dtype(self):
        return self.weights.dtype

    @classmethod
    def of(cls, weights, vectors, L: int, D: int, G: int) -> "SeedPack":
        """The pack over two flat buffers that pack_seed_params made (or
        their counterparts in a traced program): the views are rebuilt."""
        mats, vecs = _layouts(L, D, G)
        return cls(weights, vectors, _views(weights, mats),
                   _views(vectors, vecs), L, D, G)


def _layouts(L: int, D: int, G: int):
    """(name, shape) of each packed array, in buffer order. The order is
    shared with csrc/common.cuh::seed_weights. The query projection is packed only for
    the 2L sublayers that attend (k = 2i + s - 1): occ2sa never uses it."""
    J = 3 * L
    mats = [("wq", (2 * L, D, D)), ("wg", (J, 2 * D, D)), ("ws", (J, D, D)),
            ("wo", (J, D, D)), ("wf0", (J, D, 4 * D)), ("wf1", (J, 4 * D, D)),
            ("wh0", (4, D, D)), ("wsm", (3, D, SMALL_COLS)), ("wpos", (D, G))]
    vecs = [(n, (J, D)) for n in ("lnq_s", "lnq_b")]
    vecs += [("bq", (2 * L, D))]
    vecs += [(n, (J, D)) for n in ("bg", "bs", "bo",
                                   "post_s", "post_b", "ffp_s", "ffp_b")]
    vecs += [("bf0", (J, 4 * D))]
    vecs += [(n, (J, D)) for n in ("bf1", "ffq_s", "ffq_b")]
    vecs += [(n, (4, D)) for n in ("bh0", "lnh_s", "lnh_b")]
    vecs += [("bsm", (3, SMALL_COLS)), ("bpos", (G,))]
    return mats, vecs


def _views(buf, layout) -> Dict[str, torch.Tensor]:
    """{name: view of `buf`} for each (name, shape) of `layout`, packed in
    order from offset 0."""
    views, off = {}, 0
    for name, shape in layout:
        k = torch.Size(shape).numel()
        views[name] = buf[off:off + k].view(shape)
        off += k
    return views


def _flat(parts, layout, dtype, device):
    n = sum(torch.Size(s).numel() for _, s in layout)
    buf = torch.empty(n, dtype=dtype, device=device)
    views = _views(buf, layout)
    for name, view in views.items():
        view.copy_(parts[name])
    return buf, views


_PTRS = {}


def ptr_array(tensors) -> ctypes.Array:
    """A ctypes array of the tensors' data_ptrs (0 for None), as a kernel's
    pointer argument reads it; made once per distinct set of pointers and
    kept, so that a launch with the same buffers adds no allocation."""
    key = tuple(0 if t is None else t.data_ptr() for t in tensors)
    arr = _PTRS.get(key)
    if arr is None:
        if len(_PTRS) >= 256:
            _PTRS.clear()
        arr = _PTRS[key] = (ctypes.c_uint64 * len(key))(*key)
    return arr


@torch.no_grad()
def pack_seed_params(decoder, L: int, grid_size: int, dtype=None) -> SeedPack:
    """Stack the 3L seed sublayers (j = 3i + s; s=0 occ2sa, 1 pt2sa, 2 a2sa)
    and the 4 seed heads of an AgentDecoder into the kernel's buffers.
    Matrices go to the compute dtype (`dtype`, None = fp32) in [in, out]
    layout; LayerNorm parameters and biases stay fp32."""
    dtype = dtype or torch.float32
    subs = []
    for i in range(L):
        subs += [getattr(decoder, f"occ2sa_{i}"), getattr(decoder, f"pt2sa_{i}"),
                 getattr(decoder, f"a2sa_{i}")]
    st = lambda get: torch.stack([get(p, j) for j, p in enumerate(subs)])
    attending = [p for j, p in enumerate(subs) if j % 3 != 0]
    lnq = lambda p, j: p.prenorm_dst if j % 3 != 2 else p.prenorm_src
    parts = dict(
        wq=torch.stack([p.to_q.weight.T for p in attending]),
        bq=torch.stack([p.to_q.bias for p in attending]),
        wg=st(lambda p, j: p.to_g.weight.T),
        ws=st(lambda p, j: p.to_s.weight.T), wo=st(lambda p, j: p.to_out.weight.T),
        wf0=st(lambda p, j: p.ff_0.weight.T), wf1=st(lambda p, j: p.ff_1.weight.T),
        lnq_s=st(lambda p, j: lnq(p, j).weight), lnq_b=st(lambda p, j: lnq(p, j).bias),
        bg=st(lambda p, j: p.to_g.bias),
        bs=st(lambda p, j: p.to_s.bias), bo=st(lambda p, j: p.to_out.bias),
        post_s=st(lambda p, j: p.postnorm.weight),
        post_b=st(lambda p, j: p.postnorm.bias),
        ffp_s=st(lambda p, j: p.ff_prenorm.weight),
        ffp_b=st(lambda p, j: p.ff_prenorm.bias),
        bf0=st(lambda p, j: p.ff_0.bias), bf1=st(lambda p, j: p.ff_1.bias),
        ffq_s=st(lambda p, j: p.ff_postnorm.weight),
        ffq_b=st(lambda p, j: p.ff_postnorm.bias),
    )
    hs = [getattr(decoder, h) for h in _HEADS]
    D = hs[0].Dense_0.weight.shape[1]
    parts["wh0"] = torch.stack([h.Dense_0.weight.T for h in hs])
    parts["bh0"] = torch.stack([h.Dense_0.bias for h in hs])
    parts["lnh_s"] = torch.stack([h.LayerNorm_0.weight for h in hs])
    parts["lnh_b"] = torch.stack([h.LayerNorm_0.bias for h in hs])
    parts["wsm"] = torch.stack([
        F.pad(h.Dense_1.weight.T, (0, SMALL_COLS - h.Dense_1.weight.shape[0]))
        for h in hs[:3]])
    parts["bsm"] = torch.stack([
        F.pad(h.Dense_1.bias, (0, SMALL_COLS - h.Dense_1.bias.shape[0]))
        for h in hs[:3]])
    parts["wpos"] = hs[3].Dense_1.weight.T
    parts["bpos"] = hs[3].Dense_1.bias
    mats, vecs = _layouts(L, D, grid_size)
    device = parts["wq"].device
    weights, w = _flat(parts, mats, dtype, device)
    vectors, v = _flat(parts, vecs, torch.float32, device)
    return SeedPack(weights, vectors, w, v, L, D, grid_size)


def _ln(x, s, b):
    m = x.mean(-1, keepdim=True)
    var = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(var + 1e-6) * s + b


def seed_eval_reference(pack: SeedPack, sd0, v_occ, K_pt, V_pt, mask_pl,
                        K_a, V_a, mask_a, num_heads: int, head_dim: int,
                        round_operand=None, lanes=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch seed stack + heads, the kernel's math: matmul inputs
    rounded to the compute dtype, products and sums in fp32; fp32 LayerNorm
    (eps 1e-6) and softmax; all-masked key sets aggregate to zero.
    `round_operand(x)` replaces the rounding of each matmul input x (fp32 to
    fp32 values of the compute dtype), in call order: a study of rounding
    near-ties hooks in there.

    With a lane axis (v_occ [B, L, D], K/V [B, L, N, D], masks [B, N];
    sd0 shared) each lane is evaluated as a call of its own would evaluate
    it, into small [B, 3, 4] and pos [B, G]; a lane that `lanes` [B] bool
    switches off gives zeros, as the kernel's masked-off clusters do."""
    if v_occ.dim() == 3:
        on = [True] * v_occ.shape[0] if lanes is None else lanes.tolist()
        outs = [seed_eval_reference(pack, sd0, *(t[b] for t in (
            v_occ, K_pt, V_pt, mask_pl, K_a, V_a, mask_a)), num_heads,
            head_dim, round_operand) if on[b] else None
            for b in range(v_occ.shape[0])]
        zero = next(((torch.zeros_like(o[0]), torch.zeros_like(o[1]))
                     for o in outs if o is not None),
                    (torch.zeros((3, SMALL_COLS), device=sd0.device),
                     torch.zeros((pack.G,), device=sd0.device)))
        outs = [o or zero for o in outs]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    f32, cdt = torch.float32, pack.dtype
    w, v = pack.w, pack.v
    H, Hd = num_heads, head_dim
    scale = Hd ** -0.5
    rnd = round_operand or (lambda x: x.to(cdt).to(f32))

    def mm(x, wt):
        return rnd(x) @ wt.to(f32)

    sd = sd0.to(f32)
    for j in range(3 * pack.L):
        i, s = divmod(j, 3)
        dst_n = _ln(sd, v["lnq_s"][j], v["lnq_b"][j])
        if s == 0:
            agg = v_occ[i].to(f32)
        else:
            K, V, m = ((K_pt, V_pt, mask_pl) if s == 1 else (K_a, V_a, mask_a))
            K, V = K[i].to(f32), V[i].to(f32)
            maskf = m.to(f32)
            q = mm(dst_n, w["wq"][2 * i + s - 1]) + v["bq"][2 * i + s - 1]
            scores = (K * q).reshape(-1, H, Hd).sum(-1) * scale \
                + (maskf[:, None] - 1.0) * 1e9
            mx = scores.max(0, keepdim=True).values
            e = torch.exp(scores - mx) * maskf[:, None]
            attn = e / torch.clamp(e.sum(0, keepdim=True), min=1e-30)
            agg = (attn[:, :, None] * V.reshape(-1, H, Hd)).sum(0).reshape(-1)
        g = torch.sigmoid(mm(torch.cat([agg, dst_n]), w["wg"][j]) + v["bg"][j])
        agg = agg + g * (mm(dst_n, w["ws"][j]) + v["bs"][j] - agg)
        x = sd + _ln(mm(agg, w["wo"][j]) + v["bo"][j], v["post_s"][j],
                     v["post_b"][j])
        h = _ln(x, v["ffp_s"][j], v["ffp_b"][j])
        h = F.relu(mm(h, w["wf0"][j]) + v["bf0"][j])
        h = mm(h, w["wf1"][j]) + v["bf1"][j]
        sd = x + _ln(h, v["ffq_s"][j], v["ffq_b"][j])

    outs = []
    for hi in range(4):
        h = mm(sd, w["wh0"][hi]) + v["bh0"][hi]
        h = F.relu(_ln(h, v["lnh_s"][hi], v["lnh_b"][hi]))
        outs.append(mm(h, w["wsm"][hi]) + v["bsm"][hi] if hi < 3
                    else mm(h, w["wpos"]) + v["bpos"])
    return torch.stack(outs[:3]), outs[3]


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def seed_eval_accepts(dtype, D: int, num_heads: int, head_dim: int) -> bool:
    """Whether csrc/seed_eval.cu takes these widths (its shared memory is
    checked apart): fp32 or bf16, num_heads * head_dim == D, heads a
    multiple of 4 wide (the key loops' 4-wide loads), and column slices of
    the cluster stack's 8 CTAs of whole 16-byte pieces: D divisible by 32
    in fp32, by 64 in bf16."""
    if dtype not in _DTYPE_CODE or num_heads * head_dim != D or head_dim % 4:
        return False
    return D % (64 if dtype == torch.bfloat16 else 32) == 0


def seed_eval_kernel(pack: SeedPack, sd0, v_occ, K_pt, V_pt, mask_pl,
                     K_a, V_a, mask_a, num_heads: int, head_dim: int,
                     lanes=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One seed evaluation. sd0 [D] fp32; v_occ [L, D], K_pt / V_pt
    [L, P, D], K_a / V_a [L, A, D] in the pack's compute dtype; mask_pl [P]
    and mask_a [A] bool. Runs the registered op `infgen::seed_eval`: CUDA
    tensors launch csrc/seed_eval.cu on the current stream (counted in
    `seed_eval_kernel.launches`); CPU tensors take seed_eval_reference. The
    kernel takes the widths of seed_eval_accepts whose stack fits a block's
    shared memory; others raise.

    Lanes: v_occ [B, L, D], K/V [B, L, N, D] and masks [B, N] (sd0 shared)
    evaluate every lane in one launch, one cluster per lane, into small
    [B, 3, 4] and pos [B, G]; `lanes` [B] bool switches lanes off (their
    outputs are zeros). One launch counts once, whatever B."""
    if sd0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"seed_eval_kernel: unsupported device "
                         f"{sd0.device}")
    return torch.ops.infgen.seed_eval(
        pack.weights, pack.vectors, sd0, v_occ, K_pt, V_pt, mask_pl, K_a,
        V_a, mask_a, pack.L, pack.G, num_heads, head_dim, lanes)


@torch.library.custom_op("infgen::seed_eval", mutates_args=(),
                         device_types="cpu")
def _seed_eval_op(weights: torch.Tensor, vectors: torch.Tensor,
                  sd0: torch.Tensor, v_occ: torch.Tensor, K_pt: torch.Tensor,
                  V_pt: torch.Tensor, mask_pl: torch.Tensor,
                  K_a: torch.Tensor, V_a: torch.Tensor, mask_a: torch.Tensor,
                  L: int, G: int, num_heads: int, head_dim: int,
                  lanes: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    pack = SeedPack.of(weights, vectors, L, sd0.shape[0], G)
    small, pos = seed_eval_reference(pack, sd0, v_occ, K_pt, V_pt, mask_pl,
                                     K_a, V_a, mask_a, num_heads, head_dim,
                                     lanes=lanes)
    return small.contiguous(), pos.contiguous()


@_seed_eval_op.register_fake
def _(weights, vectors, sd0, v_occ, K_pt, V_pt, mask_pl, K_a, V_a, mask_a,
      L, G, num_heads, head_dim, lanes):
    lead = tuple(v_occ.shape[:1]) if v_occ.dim() == 3 else ()
    return (sd0.new_empty((*lead, 3, SMALL_COLS)), sd0.new_empty((*lead, G)))


@_seed_eval_op.register_kernel("cuda")
def _(weights, vectors, sd0, v_occ, K_pt, V_pt, mask_pl, K_a, V_a, mask_a,
      L, G, num_heads, head_dim, lanes):
    dev = sd0.device
    D = sd0.shape[0]
    batched = v_occ.dim() == 3
    lead = tuple(v_occ.shape[:1]) if batched else ()
    B = lead[0] if batched else 1
    P, A = K_pt.shape[-2], K_a.shape[-2]
    cdt = weights.dtype
    if not seed_eval_accepts(cdt, D, num_heads, head_dim):
        raise ValueError(
            "seed_eval_kernel takes fp32 or bf16, num_heads * head_dim == D "
            "with heads a multiple of 4 wide, and D divisible by 32 (bf16: "
            f"64), got {cdt}, D={D}, {num_heads} heads of {head_dim}")
    if lanes is not None and not batched:
        raise ValueError("seed_eval_kernel: a lane mask needs a lane axis")
    _check("sd0", sd0, torch.float32, (D,), dev)
    _check("v_occ", v_occ, cdt, (*lead, L, D), dev)
    _check("K_pt", K_pt, cdt, (*lead, L, P, D), dev)
    _check("V_pt", V_pt, cdt, (*lead, L, P, D), dev)
    _check("mask_pl", mask_pl, torch.bool, (*lead, P), dev)
    _check("K_a", K_a, cdt, (*lead, L, A, D), dev)
    _check("V_a", V_a, cdt, (*lead, L, A, D), dev)
    _check("mask_a", mask_a, torch.bool, (*lead, A), dev)
    if lanes is not None:
        _check("lanes", lanes, torch.bool, (B,), dev)
    _check("weights", weights, cdt, weights.shape, dev)
    _check("vectors", vectors, torch.float32, vectors.shape, dev)

    from infgen_torch.ops.build import library
    lib = library()
    shape = (_DTYPE_CODE[cdt], L, P, A, D, num_heads, G)
    if shape not in _SMEM_OK:
        smem = lib.infgen_seed_eval_smem(*shape)
        if smem > SMEM_LIMIT:
            raise ValueError(f"seed_eval_kernel: {smem} B of shared memory "
                             "exceed the 227 KB a block can use")
        _SMEM_OK.add(shape)
    small = torch.empty((*lead, 3, SMALL_COLS), dtype=torch.float32,
                        device=dev)
    pos = torch.empty((*lead, G), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.infgen_seed_eval_lanes(
        _DTYPE_CODE[cdt], sd0.data_ptr(), v_occ.data_ptr(), K_pt.data_ptr(),
        V_pt.data_ptr(), mask_pl.data_ptr(), K_a.data_ptr(), V_a.data_ptr(),
        mask_a.data_ptr(), weights.data_ptr(), vectors.data_ptr(),
        small.data_ptr(), pos.data_ptr(),
        0 if lanes is None else lanes.data_ptr(), B, L, P, A, D, num_heads,
        head_dim, G, stream)
    if err != 0:
        raise RuntimeError(f"seed_eval kernel launch failed: cudaError {err}")
    seed_eval_kernel.launches += 1
    return small, pos


seed_eval_kernel.launches = 0


# --------------------------------------------------------------------- #
# the full variant: per-step precompute folded into the evaluation
# --------------------------------------------------------------------- #

@dataclass
class SeedFullPack:
    base: SeedPack                 # the stack + heads, as pack_seed_params
    weights: torch.Tensor          # flat precompute matrices, compute dtype
    vectors: torch.Tensor          # flat precompute vectors + occupancy MLP
    w: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    tiles: Optional[torch.Tensor]  # bf16 packs: chain_tiles, else None

    @property
    def dtype(self):
        return self.base.dtype

    @classmethod
    def of(cls, base: SeedPack, weights, vectors, tiles) -> "SeedFullPack":
        """The pack over the flat buffers that pack_seed_params_full made
        (or their counterparts in a traced program)."""
        mats, vecs = _full_layouts(base.L, base.D, base.G)
        return cls(base, weights, vectors, _views(weights, mats),
                   _views(vectors, vecs), tiles)

    def views(self) -> List[torch.Tensor]:
        """Each precompute array's view, in the order of the pointer array
        that csrc/seed_eval_full.cu reads (its `FullArg` enum)."""
        return [*self.w.values(), *self.v.values()]

    @property
    def ptrs(self) -> ctypes.Array:
        """data_ptr of each view, layout order, then of `tiles` (0 when
        None)."""
        return ptr_array([*self.views(), self.tiles])


def _full_layouts(L: int, D: int, G: int):
    """(name, shape) of the precompute's arrays, in the order of the
    pointer array that csrc/seed_eval_full.cu reads (its `FullArg` enum).
    The occupancy MLP stays fp32: the module has no compute dtype."""
    mats = [(n, (L, D, D)) for n in ("ptr_wkr", "ptr_wvr", "sar_wkr",
                                     "sar_wvr", "ka_wk", "ka_wv", "occ_wv")]
    vecs = [(n, (L, D)) for n in (
        "ptr_lnr_s", "ptr_lnr_b", "ptr_bvr", "sar_lnr_s", "sar_lnr_b",
        "sar_bvr", "ka_lns_s", "ka_lns_b", "ka_bv", "occ_lns_s", "occ_lns_b",
        "occ_bv")]
    vecs += [("oe_w0", (G, D)), ("oe_b0", (D,)), ("oe_ln_s", (D,)),
             ("oe_ln_b", (D,)), ("oe_w1", (D, D)), ("oe_b1", (D,))]
    return mats, vecs


def n_chain_tiles(L: int) -> int:
    """Tiles of chain_tiles: 11 per zero-aggregate step (3L - 1 steps), 4
    per layer's agent K/V, 2 per layer's map K/V."""
    return 11 * (3 * L - 1) + 6 * L


def chain_tiles(base: SeedPack, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The bf16 precompute's weights as [n, D, D] tiles of W^T (tile[c, k]
    = W[k0 + k, c0 + c]), in the order csrc/seed_eval_full.cu streams them:
    per layer l the zero-aggregate steps 3l (occ2sa) and 3l + 1 (pt2sa),
    the a2sa keys' to_k, w_kr, to_v, w_vr, and (except the last layer) step
    3l + 2; then every layer's map w_kr, w_vr. A step is to_g's dst_n half,
    to_s, to_out, ff_0 in four column blocks and ff_1 in four row blocks.
    `w` holds the full pack's matrices (pack_seed_params_full)."""
    D, L, bw = base.D, base.L, base.w

    def step(j):
        out = [bw["wg"][j][D:].T, bw["ws"][j].T, bw["wo"][j].T]
        out += [bw["wf0"][j][:, c * D:(c + 1) * D].T for c in range(4)]
        return out + [bw["wf1"][j][c * D:(c + 1) * D].T for c in range(4)]

    tiles = []
    for i in range(L):
        tiles += step(3 * i) + step(3 * i + 1)
        tiles += [w["ka_wk"][i].T, w["sar_wkr"][i].T, w["ka_wv"][i].T,
                  w["sar_wvr"][i].T]
        if i + 1 < L:
            tiles += step(3 * i + 2)
    for i in range(L):
        tiles += [w["ptr_wkr"][i].T, w["ptr_wvr"][i].T]
    return torch.stack(tiles).contiguous()


@torch.no_grad()
def pack_seed_params_full(decoder, L: int, grid_size: int,
                          dtype=None) -> SeedFullPack:
    """pack_seed_params plus what the precompute reads: the pt2sa and a2sa
    geometry projections, the a2sa source K/V projections, the occ2sa value
    projections (matrices in the compute dtype) and the occupancy MLP
    `seed_agent_occ_embed` (fp32); for bf16 also the tensor-core path's
    weight tiles (chain_tiles)."""
    base = pack_seed_params(decoder, L, grid_size, dtype)
    dtype = base.dtype
    pt = [getattr(decoder, f"pt2sa_{i}") for i in range(L)]
    sa = [getattr(decoder, f"a2sa_{i}") for i in range(L)]
    oc = [getattr(decoder, f"occ2sa_{i}") for i in range(L)]
    st = lambda layers, get: torch.stack([get(p) for p in layers])
    parts = {}
    for tag, layers in (("ptr", pt), ("sar", sa)):
        parts[f"{tag}_wkr"] = st(layers, lambda p: p.w_kr)
        parts[f"{tag}_wvr"] = st(layers, lambda p: p.w_vr)
        parts[f"{tag}_bvr"] = st(layers, lambda p: p.b_vr)
        parts[f"{tag}_lnr_s"] = st(layers, lambda p: p.prenorm_r.weight)
        parts[f"{tag}_lnr_b"] = st(layers, lambda p: p.prenorm_r.bias)
    parts["ka_wk"] = st(sa, lambda p: p.to_k.weight.T)
    parts["ka_wv"] = st(sa, lambda p: p.to_v.weight.T)
    parts["ka_bv"] = st(sa, lambda p: p.to_v.bias)
    parts["ka_lns_s"] = st(sa, lambda p: p.prenorm_src.weight)
    parts["ka_lns_b"] = st(sa, lambda p: p.prenorm_src.bias)
    parts["occ_wv"] = st(oc, lambda p: p.to_v.weight.T)
    parts["occ_bv"] = st(oc, lambda p: p.to_v.bias)
    parts["occ_lns_s"] = st(oc, lambda p: p.prenorm_src.weight)
    parts["occ_lns_b"] = st(oc, lambda p: p.prenorm_src.bias)
    oe = decoder.seed_agent_occ_embed
    parts.update(oe_w0=oe.Dense_0.weight.T, oe_b0=oe.Dense_0.bias,
                 oe_ln_s=oe.LayerNorm_0.weight, oe_ln_b=oe.LayerNorm_0.bias,
                 oe_w1=oe.Dense_1.weight.T, oe_b1=oe.Dense_1.bias)
    mats, vecs = _full_layouts(L, base.D, grid_size)
    device = base.weights.device
    weights, w = _flat(parts, mats, dtype, device)
    vectors, v = _flat(parts, vecs, torch.float32, device)
    tiles = chain_tiles(base, w) if dtype == torch.bfloat16 else None
    return SeedFullPack(base, weights, vectors, w, v, tiles)


def _zero_agg(pack: SeedPack, x, j):
    """Sublayer j of the seed stack on rows with no incident edge
    (agg == 0): the key chain's step. fp32 residual carrier."""
    f32, cdt = torch.float32, pack.dtype
    w, v, D = pack.w, pack.v, pack.D
    mm = lambda a, m: a.to(cdt).to(f32) @ m.to(f32)
    dst_n = _ln(x, v["lnq_s"][j], v["lnq_b"][j])
    g = torch.sigmoid(mm(dst_n, w["wg"][j][D:]) + v["bg"][j])
    agg = g * (mm(dst_n, w["ws"][j]) + v["bs"][j])
    x = x + _ln(mm(agg, w["wo"][j]) + v["bo"][j], v["post_s"][j],
                v["post_b"][j])
    h = _ln(x, v["ffp_s"][j], v["ffp_b"][j])
    h = F.relu(mm(h, w["wf0"][j]) + v["bf0"][j])
    return x + _ln(mm(h, w["wf1"][j]) + v["bf1"][j], v["ffq_s"][j],
                   v["ffq_b"][j])


def seed_eval_full_precompute(pack: SeedFullPack, k0, v0, r_pl, agent_col,
                              r_sa, occ):
    """The per-step precompute of the full kernel, in plain PyTorch:
    (v_occ [L, D], K_pt, V_pt [L, P, D], K_a, V_a [L, A, D]), all fp32 and
    never rounded to the compute dtype (map K/V = k0 + the geometry term in
    fp32, unlike the non-full path, which rounds the sum)."""
    f32, cdt = torch.float32, pack.dtype
    w, v = pack.w, pack.v
    mm = lambda a, m: a.to(cdt).to(f32) @ m.to(f32)
    L = pack.base.L

    h = occ.to(f32) @ v["oe_w0"] + v["oe_b0"]
    h = F.relu(_ln(h, v["oe_ln_s"], v["oe_ln_b"]))
    occ_emb = h @ v["oe_w1"] + v["oe_b1"]
    v_occ = torch.stack([
        mm(_ln(occ_emb, v["occ_lns_s"][i], v["occ_lns_b"][i]), w["occ_wv"][i])
        + v["occ_bv"][i] for i in range(L)])

    rpl = r_pl.to(f32)
    K_pt, V_pt = [], []
    for i in range(L):
        rn = _ln(rpl, v["ptr_lnr_s"][i], v["ptr_lnr_b"][i])
        K_pt.append(k0[i].to(f32) + mm(rn, w["ptr_wkr"][i]))
        V_pt.append(v0[i].to(f32) + mm(rn, w["ptr_wvr"][i])
                    + v["ptr_bvr"][i])

    rsa, ag = r_sa.to(f32), agent_col.to(f32)
    K_a, V_a = [], []
    for i in range(L):
        for s in (0, 1):                                  # occ2sa, pt2sa
            ag = _zero_agg(pack.base, ag, 3 * i + s)
        # this layer's a2sa reads the chain before its own zero-agg step
        src_n = _ln(ag, v["ka_lns_s"][i], v["ka_lns_b"][i])
        rn = _ln(rsa, v["sar_lnr_s"][i], v["sar_lnr_b"][i])
        K_a.append(mm(src_n, w["ka_wk"][i]) + mm(rn, w["sar_wkr"][i]))
        V_a.append(mm(src_n, w["ka_wv"][i]) + v["ka_bv"][i]
                   + mm(rn, w["sar_wvr"][i]) + v["sar_bvr"][i])
        if i + 1 < L:               # the last layer's step is never read
            ag = _zero_agg(pack.base, ag, 3 * i + 2)
    return (v_occ, torch.stack(K_pt), torch.stack(V_pt), torch.stack(K_a),
            torch.stack(V_a))


def _full_lanes(pack: SeedFullPack, sd0, k0, v0, r_pl, mask_pl, agent_col,
                r_sa, mask_a, occ, num_heads: int, head_dim: int, lanes):
    """The plain full evaluation of each lane ([B, ...] inputs, sd0 shared):
    (small [B, 3, 4], pos [B, G], the precompute's five arrays [B, ...]),
    a lane that `lanes` switches off all zeros, as the kernel's masked-off
    lanes give (their precompute is never read)."""
    B = k0.shape[0]
    on = [True] * B if lanes is None else lanes.tolist()
    outs = []
    for b in range(B):
        pre = seed_eval_full_precompute(pack, k0[b], v0[b], r_pl[b],
                                        agent_col[b], r_sa[b], occ[b])
        out = seed_eval_reference(pack.base, sd0, pre[0], pre[1], pre[2],
                                  mask_pl[b], pre[3], pre[4], mask_a[b],
                                  num_heads, head_dim)
        if not on[b]:
            out = tuple(torch.zeros_like(t) for t in out)
            pre = tuple(torch.zeros_like(t) for t in pre)
        outs.append((*out, *pre))
    stacked = [torch.stack(parts) for parts in zip(*outs)]
    return stacked[0], stacked[1], tuple(stacked[2:])


def seed_eval_full_reference(pack: SeedFullPack, sd0, k0, v0, r_pl, mask_pl,
                             agent_col, r_sa, mask_a, occ, num_heads: int,
                             head_dim: int, lanes=None):
    """Plain-PyTorch full evaluation: the precompute, then the stack and
    heads of seed_eval_reference on its fp32 results. With a lane axis
    (k0 / v0 [B, L, P, D], the other inputs but sd0 [B, ...]) each lane as
    its own call evaluates it, into small [B, 3, 4] and pos [B, G]; a lane
    that `lanes` [B] bool switches off gives zeros."""
    if k0.dim() == 4:
        return _full_lanes(pack, sd0, k0, v0, r_pl, mask_pl, agent_col,
                           r_sa, mask_a, occ, num_heads, head_dim, lanes)[:2]
    v_occ, K_pt, V_pt, K_a, V_a = seed_eval_full_precompute(
        pack, k0, v0, r_pl, agent_col, r_sa, occ)
    return seed_eval_reference(pack.base, sd0, v_occ, K_pt, V_pt, mask_pl,
                               K_a, V_a, mask_a, num_heads, head_dim)


def seed_eval_full_kernel(pack: SeedFullPack, sd0, k0, v0, r_pl, mask_pl,
                          agent_col, r_sa, mask_a, occ, num_heads: int,
                          head_dim: int, return_precompute: bool = False,
                          lanes=None):
    """One full seed evaluation from raw inputs. sd0 [D] fp32; k0 / v0
    [L, P, D] (the rollout-invariant x_pt projections), r_pl [P, D] (map
    geometry embedding), agent_col [A, D] (the raw feature column) and r_sa
    [A, D] (agent geometry embedding) in the pack's compute dtype; mask_pl
    [P], mask_a [A] and occ [G] bool. Runs the registered op
    `infgen::seed_eval_full`: CUDA tensors launch csrc/seed_eval_full.cu
    (two kernels in order on the current stream, counted once in
    `seed_eval_full_kernel.launches`); CPU tensors take
    seed_eval_full_reference. With return_precompute, the precompute's fp32
    results (v_occ, K_pt, V_pt, K_a, V_a; the rows of masked keys are not
    computed by the kernel) come back as a third output, so that the two
    stages can be checked one at a time. The kernel takes D <= 512
    divisible by 32 in fp32, and only D = 64 or 128 in bf16 (its
    tensor-core tiles).

    Lanes: every input but sd0 with a leading lane axis B (k0 / v0
    [B, L, P, D], r_pl [B, P, D], agent_col / r_sa [B, A, D], masks [B, P]
    / [B, A], occ [B, G]) evaluates every lane in one call (one precompute
    launch over all lanes' tiles, one stack cluster per lane) into small
    [B, 3, 4] and pos [B, G]; `lanes` [B] bool switches lanes off (their
    outputs are zeros). One call counts once, whatever B."""
    if sd0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"seed_eval_full_kernel: unsupported device "
                         f"{sd0.device}")
    if lanes is not None and k0.dim() != 4:
        raise ValueError("seed_eval_full_kernel: a lane mask needs a lane "
                         "axis")
    base = pack.base
    small, pos, *pre = torch.ops.infgen.seed_eval_full(
        base.weights, base.vectors, pack.views(), pack.tiles, sd0, k0, v0,
        r_pl, mask_pl, agent_col, r_sa, mask_a, occ, base.L, base.G,
        num_heads, head_dim, lanes)
    return (small, pos, tuple(pre)) if return_precompute else (small, pos)


def _full_pack(base_weights, base_vectors, views, tiles, L, D, G):
    """The SeedFullPack of an op's arguments: the precompute's views as
    given (its flat buffers are not needed)."""
    base = SeedPack.of(base_weights, base_vectors, L, D, G)
    mats, vecs = _full_layouts(L, D, G)
    names = [n for n, _ in mats + vecs]
    w = dict(zip(names[:len(mats)], views[:len(mats)]))
    v = dict(zip(names[len(mats):], views[len(mats):]))
    return SeedFullPack(base, None, None, w, v, tiles)


@torch.library.custom_op("infgen::seed_eval_full", mutates_args=(),
                         device_types="cpu")
def _seed_eval_full_op(
        base_weights: torch.Tensor, base_vectors: torch.Tensor,
        views: List[torch.Tensor], tiles: Optional[torch.Tensor],
        sd0: torch.Tensor, k0: torch.Tensor, v0: torch.Tensor,
        r_pl: torch.Tensor, mask_pl: torch.Tensor, agent_col: torch.Tensor,
        r_sa: torch.Tensor, mask_a: torch.Tensor, occ: torch.Tensor, L: int,
        G: int, num_heads: int, head_dim: int,
        lanes: Optional[torch.Tensor]) -> Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
        torch.Tensor, torch.Tensor]:
    pack = _full_pack(base_weights, base_vectors, views, tiles, L,
                      sd0.shape[0], G)
    if k0.dim() == 4:
        small, pos, pre = _full_lanes(pack, sd0, k0, v0, r_pl, mask_pl,
                                      agent_col, r_sa, mask_a, occ,
                                      num_heads, head_dim, lanes)
    else:
        pre = seed_eval_full_precompute(pack, k0, v0, r_pl, agent_col, r_sa,
                                        occ)
        small, pos = seed_eval_reference(
            pack.base, sd0, pre[0], pre[1], pre[2], mask_pl, pre[3], pre[4],
            mask_a, num_heads, head_dim)
    return tuple(t.contiguous() for t in (small, pos, *pre))


def _full_shapes(k0, agent_col, L, D, G):
    lead = tuple(k0.shape[:1]) if k0.dim() == 4 else ()
    P, A = k0.shape[-2], agent_col.shape[-2]
    return [(*lead, 3, SMALL_COLS), (*lead, G), (*lead, L, D),
            (*lead, L, P, D), (*lead, L, P, D), (*lead, L, A, D),
            (*lead, L, A, D)]


@_seed_eval_full_op.register_fake
def _(base_weights, base_vectors, views, tiles, sd0, k0, v0, r_pl, mask_pl,
      agent_col, r_sa, mask_a, occ, L, G, num_heads, head_dim, lanes):
    return tuple(sd0.new_empty(s) for s in _full_shapes(
        k0, agent_col, L, sd0.shape[0], G))


@_seed_eval_full_op.register_kernel("cuda")
def _(base_weights, base_vectors, views, tiles, sd0, k0, v0, r_pl, mask_pl,
      agent_col, r_sa, mask_a, occ, L, G, num_heads, head_dim, lanes):
    dev = sd0.device
    D = sd0.shape[0]
    batched = k0.dim() == 4
    lead = tuple(k0.shape[:1]) if batched else ()
    P, A = k0.shape[-2], agent_col.shape[-2]
    cdt = base_weights.dtype
    if cdt not in _DTYPE_CODE:
        raise ValueError(f"seed_eval_full_kernel: compute dtype {cdt} "
                         "unsupported")
    if num_heads * head_dim != D or D > 512:
        raise ValueError("seed_eval_full_kernel needs num_heads * head_dim "
                         "== D <= 512")
    _check("sd0", sd0, torch.float32, (D,), dev)
    _check("k0", k0, cdt, (*lead, L, P, D), dev)
    _check("v0", v0, cdt, (*lead, L, P, D), dev)
    _check("r_pl", r_pl, cdt, (*lead, P, D), dev)
    _check("mask_pl", mask_pl, torch.bool, (*lead, P), dev)
    _check("agent_col", agent_col, cdt, (*lead, A, D), dev)
    _check("r_sa", r_sa, cdt, (*lead, A, D), dev)
    _check("mask_a", mask_a, torch.bool, (*lead, A), dev)
    _check("occ", occ, torch.bool, (*lead, G), dev)
    if lanes is not None:
        _check("lanes", lanes, torch.bool, lead, dev)
    _check("weights", base_weights, cdt, base_weights.shape, dev)
    _check("vectors", base_vectors, torch.float32, base_vectors.shape, dev)
    mats, vecs = _full_layouts(L, D, G)
    if len(views) != len(mats) + len(vecs):
        raise ValueError(f"seed_eval_full_kernel: {len(views)} views, "
                         f"expected {len(mats) + len(vecs)}")
    for (name, shape), t in zip(mats, views):
        _check(name, t, cdt, shape, dev)
    for (name, shape), t in zip(vecs, views[len(mats):]):
        _check(name, t, torch.float32, shape, dev)
    if cdt == torch.bfloat16:
        if D not in (64, 128):
            raise ValueError("seed_eval_full_kernel in bf16 takes D = 64 or "
                             "128 (its tensor-core tiles)")
        _check("tiles", tiles, cdt, (n_chain_tiles(L), D, D), dev)
    if D % 32:
        raise ValueError("seed_eval_full_kernel needs D divisible by 32 "
                         "(the stack's column slices)")

    from infgen_torch.ops.build import library
    shape = (_DTYPE_CODE[cdt], L, P, A, D, num_heads, G)
    if shape not in _FULL_SMEM_OK:
        smem = library().infgen_seed_eval_full_smem(*shape)
        if smem > SMEM_LIMIT:
            raise ValueError(f"seed_eval_full_kernel: {smem} B of shared "
                             "memory exceed the 227 KB a block can use")
        _FULL_SMEM_OK.add(shape)
    small, pos, pre = _launch_full(
        base_weights, base_vectors, ptr_array([*views, tiles]), sd0, k0, v0,
        r_pl, mask_pl, agent_col, r_sa, mask_a, occ, L, G, num_heads,
        head_dim, lanes=lanes)
    seed_eval_full_kernel.launches += 1
    return (small, pos, *pre)


def seed_eval_full_launch(pack: SeedFullPack, sd0, k0, v0, r_pl, mask_pl,
                          agent_col, r_sa, mask_a, occ, num_heads: int,
                          head_dim: int, stages: int = 3, pre=None,
                          lanes=None):
    """Launch csrc/seed_eval_full.cu on CUDA tensors that
    seed_eval_full_kernel has checked, without counting: stages 1 runs the
    precompute, 2 the stack on `pre` (a previous call's precompute), 3 both.
    Returns (small, pos, pre); a stage-wise timing uses it directly. With a
    lane axis every array carries it, the scratch too, and `lanes`
    switches lanes off."""
    base = pack.base
    return _launch_full(base.weights, base.vectors, pack.ptrs, sd0, k0, v0,
                        r_pl, mask_pl, agent_col, r_sa, mask_a, occ, base.L,
                        base.G, num_heads, head_dim, stages, pre, lanes)


def _launch_full(base_weights, base_vectors, ptrs, sd0, k0, v0, r_pl,
                 mask_pl, agent_col, r_sa, mask_a, occ, L: int, G: int,
                 num_heads: int, head_dim: int, stages: int = 3, pre=None,
                 lanes=None):
    from infgen_torch.ops.build import library
    lib = library()
    D = sd0.shape[0]
    lead = tuple(k0.shape[:1]) if k0.dim() == 4 else ()
    P, A = k0.shape[-2], agent_col.shape[-2]
    dev = sd0.device
    f32 = dict(dtype=torch.float32, device=dev)
    if pre is None:
        # fp32 precompute results, written by the first kernel, read by the
        # second; rows of masked keys (and masked-off lanes) are left
        # unwritten and never read
        pre = (torch.empty((*lead, L, D), **f32),
               torch.empty((*lead, L, P, D), **f32),
               torch.empty((*lead, L, P, D), **f32),
               torch.empty((*lead, L, A, D), **f32),
               torch.empty((*lead, L, A, D), **f32))
    small = torch.empty((*lead, 3, SMALL_COLS), **f32)
    pos = torch.empty((*lead, G), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.infgen_seed_eval_full(
        _DTYPE_CODE[base_weights.dtype], sd0.data_ptr(), k0.data_ptr(),
        v0.data_ptr(), r_pl.data_ptr(), mask_pl.data_ptr(),
        agent_col.data_ptr(), r_sa.data_ptr(), mask_a.data_ptr(),
        occ.data_ptr(), base_weights.data_ptr(), base_vectors.data_ptr(),
        ctypes.addressof(ptrs), *(t.data_ptr() for t in pre),
        small.data_ptr(), pos.data_ptr(),
        0 if lanes is None else lanes.data_ptr(), lead[0] if lead else 1, L,
        P, A, D, num_heads, head_dim, G, stages, stream)
    if err != 0:
        raise RuntimeError(f"seed_eval_full kernel launch failed: cudaError "
                           f"{err}")
    return small, pos, pre


seed_eval_full_kernel.launches = 0
