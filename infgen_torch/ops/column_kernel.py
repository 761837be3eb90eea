"""The whole trunk column of one token step as CUDA kernels (port of
infgen_tpu/ops/column_kernel.py::motion_column_kernel; the CUDA source is
csrc/motion_column.cu, whose header states its bound and design).

  pack_column_params       the L trunk layers' temporal, map and agent-agent
                           DenseAttention parameters, stacked per sublayer
                           j = 3l + kind (kind 0 t_attn, 1 pt2a, 2 a2a):
                           matrices in the compute dtype, vectors fp32;
                           bf16 packs also hold column_tiles, the layout
                           the kernel's tensor-core path reads
  kernel_accepts           the widths the kernel takes
  motion_column_reference  the same math in plain PyTorch (the CPU path,
                           and what the kernel is held against on the card)
  motion_column_kernel     the wrapper: launches the kernels on CUDA
                           tensors, takes the plain version for CPU tensors,
                           raises otherwise

Lanes: every array may carry a lane axis B (one scenario each, as `jax.vmap`
batches the TPU kernel): x0 [B, A, D], key_stack [L, B, A, W, D] (the
layout AgentDecoder.motion_column carries), the other inputs [B, ...],
n_rows [B], the output [L, B, A, D]. Each lane is the call on its own
arrays: its agent-agent keys are its own rows, its bound its own.

Rounding follows the TPU kernel, not the per-module path: the key and
relation inputs arrive in the compute dtype (the caller casts them once),
the running column stays fp32 through all 3L sublayers, and the caller casts
the [L, A, D] fp32 output to the compute dtype.

Occupancy bound `n_rows` (a device int32 scalar, one per lane with a lane
axis; read by the kernel, never by the host): rows at or above it must have
every key masked (inactive agent slots); their attention is skipped and
they take the zero-aggregate epilogue, which is what the full computation
gives them, bit for bit.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional

import ctypes
import torch
import torch.nn.functional as F

from infgen_torch.ops.seed_kernel import (_DTYPE_CODE, _check, _flat, _ln,
                                          _views, ptr_array)

NEG_INF = -1e30
_KINDS = (("t_attn", False), ("pt2a", True), ("a2a", False))


@dataclass
class ColumnPack:
    weights: torch.Tensor          # flat, compute dtype
    vectors: torch.Tensor          # flat, fp32
    w: Dict[str, torch.Tensor]     # views into `weights`, [3L, ...]
    v: Dict[str, torch.Tensor]     # views into `vectors`, [3L, ...]
    L: int
    D: int
    tiles: Optional[torch.Tensor] = None   # bf16 packs: column_tiles

    @property
    def dtype(self):
        return self.weights.dtype

    @classmethod
    def of(cls, weights, vectors, tiles, L: int, D: int) -> "ColumnPack":
        """The pack over the buffers that pack_column_params made (or their
        counterparts in a traced program): the views are rebuilt."""
        mats, vecs = _layouts(3 * L, D)
        return cls(weights, vectors, _views(weights, mats),
                   _views(vectors, vecs), L, D, tiles)

    def views(self) -> List[torch.Tensor]:
        """Each view, in the order of the pointer array that
        csrc/dense_row.cuh reads (its `Arg` enum)."""
        return [*self.w.values(), *self.v.values()]

    @property
    def ptrs(self) -> ctypes.Array:
        """data_ptr of each view, layout order."""
        return ptr_array(self.views())


def _layouts(J: int, D: int):
    """(name, shape) of each packed array of J stacked sublayers, in the
    order of the pointer array that csrc/dense_row.cuh reads (its `Arg`
    enum). to_g is split at row HD: `wga` takes the aggregate, `wgd` the
    normalised query."""
    mats = [(n, (J, D, D)) for n in ("wq", "wk", "wv", "wkr", "wvr", "wga",
                                     "wgd", "ws", "wo")]
    mats += [("wf0", (J, D, 4 * D)), ("wf1", (J, 4 * D, D))]
    vecs = [(n, (J, D)) for n in ("lnd_s", "lnd_b", "lns_s", "lns_b",
                                  "lnr_s", "lnr_b", "bq", "bv", "bvr", "bg",
                                  "bs", "bo", "post_s", "post_b", "ffp_s",
                                  "ffp_b")]
    vecs += [("bf0", (J, 4 * D))]
    vecs += [(n, (J, D)) for n in ("bf1", "ffq_s", "ffq_b")]
    return mats, vecs


@torch.no_grad()
def pack_sublayers(subs, dtype=None):
    """Stack DenseAttention sublayers `subs`, a list of (module, bipartite),
    in the layout of `_layouts`. Matrices go to `dtype` (None = fp32) in
    [in, out] layout; LayerNorm parameters and biases stay fp32. The query
    LayerNorm is prenorm_dst for a bipartite sublayer, prenorm_src
    otherwise. Returns (weights, vectors, w, v, D): the two flat buffers
    and their per-array views."""
    dtype = dtype or torch.float32
    st = lambda get: torch.stack([get(p, bip) for p, bip in subs])
    HD = subs[0][0].to_s.weight.shape[0]
    lnd = lambda p, bip: p.prenorm_dst if bip else p.prenorm_src
    parts = dict(
        wq=st(lambda p, b: p.to_q.weight.T), bq=st(lambda p, b: p.to_q.bias),
        wk=st(lambda p, b: p.to_k.weight.T),
        wv=st(lambda p, b: p.to_v.weight.T), bv=st(lambda p, b: p.to_v.bias),
        wkr=st(lambda p, b: p.w_kr), wvr=st(lambda p, b: p.w_vr),
        bvr=st(lambda p, b: p.b_vr),
        wga=st(lambda p, b: p.to_g.weight.T[:HD]),
        wgd=st(lambda p, b: p.to_g.weight.T[HD:]),
        bg=st(lambda p, b: p.to_g.bias),
        ws=st(lambda p, b: p.to_s.weight.T), bs=st(lambda p, b: p.to_s.bias),
        wo=st(lambda p, b: p.to_out.weight.T),
        bo=st(lambda p, b: p.to_out.bias),
        wf0=st(lambda p, b: p.ff_0.weight.T), bf0=st(lambda p, b: p.ff_0.bias),
        wf1=st(lambda p, b: p.ff_1.weight.T), bf1=st(lambda p, b: p.ff_1.bias),
        lnd_s=st(lambda p, b: lnd(p, b).weight),
        lnd_b=st(lambda p, b: lnd(p, b).bias),
        lns_s=st(lambda p, b: p.prenorm_src.weight),
        lns_b=st(lambda p, b: p.prenorm_src.bias),
        lnr_s=st(lambda p, b: p.prenorm_r.weight),
        lnr_b=st(lambda p, b: p.prenorm_r.bias),
        post_s=st(lambda p, b: p.postnorm.weight),
        post_b=st(lambda p, b: p.postnorm.bias),
        ffp_s=st(lambda p, b: p.ff_prenorm.weight),
        ffp_b=st(lambda p, b: p.ff_prenorm.bias),
        ffq_s=st(lambda p, b: p.ff_postnorm.weight),
        ffq_b=st(lambda p, b: p.ff_postnorm.bias),
    )
    D = parts["wq"].shape[1]
    if HD != D:
        raise ValueError(f"packed sublayers need num_heads * head_dim == "
                         f"hidden_dim, got {HD} != {D}")
    mats, vecs = _layouts(len(subs), D)
    device = parts["wq"].device
    weights, w = _flat(parts, mats, dtype, device)
    vectors, v = _flat(parts, vecs, torch.float32, device)
    return weights, vectors, w, v, D


def pack_column_params(decoder, L: int, dtype=None) -> ColumnPack:
    """Stack an AgentDecoder's L trunk layers per sublayer j = 3l + kind
    (pack_sublayers); matrices in the compute dtype `dtype`. A bf16 pack
    at D = 128 also holds `tiles` (column_tiles)."""
    subs = []
    for i in range(L):
        subs += [(getattr(decoder, f"{name}_{i}"), bip)
                 for name, bip in _KINDS]
    weights, vectors, w, v, D = pack_sublayers(subs, dtype)
    tiles = column_tiles(w) if dtype == torch.bfloat16 and D == TILE_D \
        else None
    return ColumnPack(weights, vectors, w, v, L, D, tiles)


# the bf16 path's widths (csrc/motion_column.cu: kCD, kCHd) and its [D, D]
# tiles of one sublayer, in the order of its Tile enum
TILE_D, TILE_HEAD_DIM = 128, 16
TILE_ORDER = ("wq", "wk", "wkr", "wv", "wvr", "wga", "wgd", "ws", "wo",
              *(f"wf0/{c}" for c in range(4)), *(f"wf1/{c}" for c in range(4)))


def swizzle(t: torch.Tensor) -> torch.Tensor:
    """[..., n, D] -> the same rows with 8-element chunk c of row n stored
    at chunk c ^ (n % 8) (csrc/motion_column.cu::swz). Its own inverse."""
    n, D = t.shape[-2:]
    rows = torch.arange(n, device=t.device)[:, None]
    perm = torch.arange(D // 8, device=t.device)[None] ^ (rows % 8)
    c = t.reshape(*t.shape[:-1], D // 8, 8)
    idx = perm[..., None].expand(n, D // 8, 8).expand(c.shape)
    return torch.gather(c, -2, idx).reshape(t.shape)


def tile_matrix(w: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """Matrix `name` of TILE_ORDER for every sublayer as [J, in, out] =
    [J, D, D]: wf0/c is ff_0's output columns [cD, cD + D), wf1/c ff_1's
    input rows [cD, cD + D)."""
    base, _, c = name.partition("/")
    m = w[base]
    if not c:
        return m
    D, c = m.shape[-1] if base == "wf1" else m.shape[1], int(c)
    return m[..., c * D:(c + 1) * D] if base == "wf0" \
        else m[:, c * D:(c + 1) * D]


@torch.no_grad()
def column_tiles(w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The bf16 path's weights: per sublayer j the 17 matrices of
    TILE_ORDER as [D, D] tiles of W^T (tile[n, k] = W[k, n]), swizzled;
    [3L, 17, D, D] in the pack's dtype. csrc/motion_column.cu streams them
    by bulk copies, one tile each."""
    return torch.stack([swizzle(tile_matrix(w, name).transpose(-1, -2))
                        for name in TILE_ORDER], 1).contiguous()


def scratch_floats(dtype, L: int, A: int, W: int, K: int, D: int) -> int:
    """fp32 scratch of one lane (csrc/motion_column.cu's Scratch rows):
    five [A, D] hand-over rows; bf16 also the agent-agent aggregate and the
    pair projections, per layer and query row k and v rows for up to W
    temporal, K map and A agent keys (its pair_layer). A call over B lanes
    takes B times this."""
    if dtype != torch.bfloat16:
        return 5 * A * D
    return 6 * A * D + L * A * (W + K + A) * 2 * D


def launches_per_call(dtype, L: int) -> int:
    """Kernel launches of one call, with or without lanes: per layer a row
    and an agent-agent kernel; bf16: the pair-projection kernel before them
    and per layer the agent-agent attention kernel between them."""
    return 3 * L + 1 if dtype == torch.bfloat16 else 2 * L


def kernel_accepts(dtype, D: int, num_heads: int, head_dim: int,
                   max_keys: int) -> bool:
    """Whether csrc/motion_column.cu takes these widths (max_keys: the
    largest of A, W and K): the fp32 path any num_heads x head_dim == D <=
    512; the bf16 path (its tensor-core tiles) D = 128 with 8 heads of 16;
    both at most 256 keys per query."""
    if num_heads * head_dim != D or max_keys > 256:
        return False
    if dtype == torch.bfloat16:
        return D == TILE_D and head_dim == TILE_HEAD_DIM
    return dtype == torch.float32 and D <= 512


def _sublayer(pack, j, x, keys, r, mask, H, Hd, live):
    """One DenseAttention forward for the A query rows of the column.
    keys [A, N, D] per query, or None for the agent-agent sublayer, whose
    keys are the rows of x themselves; r [A, N, D]; mask [A, N] bool;
    live [A, 1] bool or None (rows past the occupancy bound)."""
    f32, cdt = torch.float32, pack.dtype
    w, v = pack.w, pack.v
    A = x.shape[0]
    mm = lambda a, m: a.to(cdt).to(f32) @ m.to(f32)

    dst_n = _ln(x, v["lnd_s"][j], v["lnd_b"][j])
    q = mm(dst_n, w["wq"][j]) + v["bq"][j]
    rn = _ln(r.to(f32), v["lnr_s"][j], v["lnr_b"][j])
    kr = mm(rn, w["wkr"][j])
    vr = mm(rn, w["wvr"][j]) + v["bvr"][j]
    if keys is None:
        src_n = _ln(x, v["lns_s"][j], v["lns_b"][j])
        k_eff = mm(src_n, w["wk"][j])[None] + kr
        v_eff = (mm(src_n, w["wv"][j]) + v["bv"][j])[None] + vr
    else:
        sn = _ln(keys.to(f32), v["lns_s"][j], v["lns_b"][j])
        k_eff = mm(sn, w["wk"][j]) + kr
        v_eff = mm(sn, w["wv"][j]) + v["bv"][j] + vr
    N = k_eff.shape[1]
    sim = (k_eff.reshape(A, N, H, Hd) * q.reshape(A, 1, H, Hd)).sum(-1) \
        * Hd ** -0.5                                       # [A, N, H]
    mf = mask.to(f32)[..., None]
    sim = sim * mf + (1.0 - mf) * NEG_INF
    p = torch.exp(sim - sim.max(1, keepdim=True).values) * mf
    den = p.sum(1)                                         # [A, H]
    agg = (p[..., None] * v_eff.reshape(A, N, H, Hd)).sum(1) \
        / torch.clamp(den, min=1e-30)[..., None]
    agg = agg.reshape(A, H * Hd)
    if live is not None:
        agg = torch.where(live, agg, 0.0)

    g = torch.sigmoid(mm(agg, w["wga"][j]) + mm(dst_n, w["wgd"][j])
                      + v["bg"][j])
    agg = agg + g * (mm(dst_n, w["ws"][j]) + v["bs"][j] - agg)
    x1 = x + _ln(mm(agg, w["wo"][j]) + v["bo"][j], v["post_s"][j],
                 v["post_b"][j])
    h = _ln(x1, v["ffp_s"][j], v["ffp_b"][j])
    h = F.relu(mm(h, w["wf0"][j]) + v["bf0"][j])
    h = mm(h, w["wf1"][j]) + v["bf1"][j]
    return x1 + _ln(h, v["ffq_s"][j], v["ffq_b"][j])


def motion_column_reference(pack: ColumnPack, x0, key_stack, r_t, t_mask,
                            pl_keys, r_pl, pl_mask, r_aa, aa_mask,
                            num_heads: int, head_dim: int, n_rows=None,
                            layer_inputs=None) -> torch.Tensor:
    """Plain-PyTorch trunk column, the kernel's math: matmul inputs rounded
    to the compute dtype, products and sums in fp32; fp32 LayerNorm (eps
    1e-6), scores and softmax; a fully masked query aggregates to zero.
    Returns [L, A, D] fp32 (row l = layer l's output). With layer_inputs
    [L, A, D] (another run's outputs), layer l > 0 starts from
    layer_inputs[l - 1] instead of this run's layer l - 1: one layer at a
    time, on the same inputs as that run's. With a lane axis (x0 [B, A, D],
    the module docstring's shapes; layer_inputs [L, B, A, D]) each lane is
    the call on its own arrays, into [L, B, A, D]."""
    if x0.dim() == 3:
        return torch.stack([motion_column_reference(
            pack, x0[b], key_stack[:, b], r_t[b], t_mask[b], pl_keys[b],
            r_pl[b], pl_mask[b], r_aa[b], aa_mask[b], num_heads, head_dim,
            None if n_rows is None else n_rows[b],
            None if layer_inputs is None else layer_inputs[:, b])
            for b in range(x0.shape[0])], 1)
    x = x0.to(torch.float32)
    A = x.shape[0]
    live = None if n_rows is None else \
        (torch.arange(A, device=x.device) < n_rows)[:, None]
    cols = []
    for l in range(pack.L):
        if layer_inputs is not None and l > 0:
            x = layer_inputs[l - 1].to(torch.float32)
        x = _sublayer(pack, 3 * l, x, key_stack[l], r_t, t_mask, num_heads,
                      head_dim, live)
        x = _sublayer(pack, 3 * l + 1, x, pl_keys, r_pl, pl_mask, num_heads,
                      head_dim, live)
        x = _sublayer(pack, 3 * l + 2, x, None, r_aa, aa_mask, num_heads,
                      head_dim, live)
        cols.append(x)
    return torch.stack(cols)


def motion_column_kernel(pack: ColumnPack, x0, key_stack, r_t, t_mask,
                         pl_keys, r_pl, pl_mask, r_aa, aa_mask,
                         num_heads: int, head_dim: int, n_rows=None
                         ) -> torch.Tensor:
    """The L-layer trunk column. x0 [A, D] fp32; key_stack [L, A, W, D],
    r_t [A, W, D], pl_keys / r_pl [A, K, D] and r_aa [A, A, D] in the
    pack's compute dtype; t_mask [A, W], pl_mask [A, K], aa_mask [A, A]
    bool; n_rows an int32 scalar tensor on the same device, or None (all
    rows). Returns [L, A, D] fp32. With a lane axis (the module docstring's
    shapes) n_rows is [B] or None and the output [L, B, A, D]; the width
    limits (kernel_accepts) hold per lane. Runs the registered op
    `infgen::motion_column`: CUDA tensors launch csrc/motion_column.cu on
    the current stream (launches_per_call kernels for every lane, counted
    once in `motion_column_kernel.launches`); CPU tensors take
    motion_column_reference."""
    dev = x0.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"motion_column_kernel: unsupported device {dev}")
    L, D, cdt = pack.L, pack.D, pack.dtype
    lead = tuple(x0.shape[:-2])
    if len(lead) > 1:
        raise ValueError("motion_column_kernel takes x0 [A, D] or [B, A, D],"
                         f" got {tuple(x0.shape)}")
    A, W, K = x0.shape[-2], key_stack.shape[-2], pl_keys.shape[-2]
    _check("x0", x0, torch.float32, (*lead, A, D), dev)
    _check("key_stack", key_stack, cdt, (L, *lead, A, W, D), dev)
    _check("r_t", r_t, cdt, (*lead, A, W, D), dev)
    _check("t_mask", t_mask, torch.bool, (*lead, A, W), dev)
    _check("pl_keys", pl_keys, cdt, (*lead, A, K, D), dev)
    _check("r_pl", r_pl, cdt, (*lead, A, K, D), dev)
    _check("pl_mask", pl_mask, torch.bool, (*lead, A, K), dev)
    _check("r_aa", r_aa, cdt, (*lead, A, A, D), dev)
    _check("aa_mask", aa_mask, torch.bool, (*lead, A, A), dev)
    if n_rows is not None:
        _check("n_rows", n_rows, torch.int32,
               lead if lead else n_rows.shape, dev)
        if not lead and n_rows.numel() != 1:
            raise ValueError("n_rows must hold one value")
    return torch.ops.infgen.motion_column(
        pack.views(), pack.tiles, x0, key_stack, r_t, t_mask, pl_keys, r_pl,
        pl_mask, r_aa, aa_mask, L, num_heads, head_dim, n_rows)


@torch.library.custom_op("infgen::motion_column", mutates_args=(),
                         device_types="cpu")
def _motion_column_op(views: List[torch.Tensor],
                      tiles: Optional[torch.Tensor], x0: torch.Tensor,
                      key_stack: torch.Tensor, r_t: torch.Tensor,
                      t_mask: torch.Tensor, pl_keys: torch.Tensor,
                      r_pl: torch.Tensor, pl_mask: torch.Tensor,
                      r_aa: torch.Tensor, aa_mask: torch.Tensor, L: int,
                      num_heads: int, head_dim: int,
                      n_rows: Optional[torch.Tensor]) -> torch.Tensor:
    mats, vecs = _layouts(3 * L, x0.shape[-1])
    names = [n for n, _ in mats + vecs]
    pack = ColumnPack(views[0], views[len(mats)],
                      dict(zip(names[:len(mats)], views[:len(mats)])),
                      dict(zip(names[len(mats):], views[len(mats):])), L,
                      x0.shape[-1], tiles)
    return motion_column_reference(
        pack, x0, key_stack, r_t, t_mask, pl_keys, r_pl, pl_mask, r_aa,
        aa_mask, num_heads, head_dim, n_rows).contiguous()


@_motion_column_op.register_fake
def _(views, tiles, x0, key_stack, r_t, t_mask, pl_keys, r_pl, pl_mask, r_aa,
      aa_mask, L, num_heads, head_dim, n_rows):
    return x0.new_empty((L, *x0.shape), dtype=torch.float32)


@_motion_column_op.register_kernel("cuda")
def _(views, tiles, x0, key_stack, r_t, t_mask, pl_keys, r_pl, pl_mask, r_aa,
      aa_mask, L, num_heads, head_dim, n_rows):
    dev = x0.device
    D, cdt = x0.shape[-1], views[0].dtype
    lead = tuple(x0.shape[:-2])
    A, W, K = x0.shape[-2], key_stack.shape[-2], pl_keys.shape[-2]
    if cdt not in _DTYPE_CODE:
        raise ValueError(f"motion_column_kernel: compute dtype {cdt} "
                         "unsupported")
    if not kernel_accepts(cdt, D, num_heads, head_dim, max(A, W, K)):
        raise ValueError(
            "motion_column_kernel takes num_heads * head_dim == D <= 512 "
            "(bf16: D = 128, head_dim 16) and at most 256 keys per query, "
            f"got D={D}, {num_heads} heads of {head_dim}, "
            f"{max(A, W, K)} keys")
    mats, vecs = _layouts(3 * L, D)
    if len(views) != len(mats) + len(vecs):
        raise ValueError(f"motion_column_kernel: {len(views)} views, "
                         f"expected {len(mats) + len(vecs)}")
    for (name, shape), t in zip(mats, views):
        _check(name, t, cdt, shape, dev)
    for (name, shape), t in zip(vecs, views[len(mats):]):
        _check(name, t, torch.float32, shape, dev)
    if cdt == torch.bfloat16:
        _check("tiles", tiles, cdt, (3 * L, len(TILE_ORDER), D, D), dev)

    from infgen_torch.ops.build import library
    lib = library()
    B = lead[0] if lead else 1
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((L, *lead, A, D), **f32)
    # per lane and layer the hand-over from the row kernel to the
    # agent-agent kernel: x after the map sublayer, its normalised query /
    # key rows, q, k, v; bf16: also the agent-agent aggregate and every
    # layer's pair projections (scratch_floats)
    scratch = torch.empty((B * scratch_floats(cdt, L, A, W, K, D),), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.infgen_motion_column_lanes(
        _DTYPE_CODE[cdt], x0.data_ptr(), key_stack.data_ptr(),
        r_t.data_ptr(), t_mask.data_ptr(), pl_keys.data_ptr(),
        r_pl.data_ptr(), pl_mask.data_ptr(), r_aa.data_ptr(),
        aa_mask.data_ptr(), 0 if n_rows is None else n_rows.data_ptr(),
        ctypes.addressof(ptr_array(views)),
        0 if cdt != torch.bfloat16 else tiles.data_ptr(),
        out.data_ptr(), scratch.data_ptr(),
        L, A, W, K, D, num_heads, head_dim, B, stream)
    if err != 0:
        raise RuntimeError(f"motion_column kernel launch failed: cudaError "
                           f"{err}")
    motion_column_kernel.launches += 1
    return out


motion_column_kernel.launches = 0
