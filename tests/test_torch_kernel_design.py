"""The designs of the port's redesigned CUDA kernels, held on the CPU in
plain torch (no JAX): the reassociated attention of the fused DenseAttention
block (csrc/fused_block.cu) against the plain `fused_attention_block_reference`,
the reassociated relation-biased attention (csrc/r_biased_attention.cu)
against `r_biased_attention_reference`, the refine pass as its cluster of
head slices computes it (csrc/refine.cu) against `refine_reference`, the
host-side weight layouts the kernels read (the fused block's head-blocked
key projections, the seed_eval_full bf16 path's weight tiles, the trunk
column's swizzled tiles, refine's per-CTA stages) against the module
parameters they come from, and the kernels' width rules.

Reassociation: with u_h = W_k[:, h] q_h and ur_h = W_kr[:, h] q_h, a pair's
score is LN(key) . u_h + LN(r) . ur_h, and its values enter only through the
per-head softmax-weighted sums of LN(key) and LN(r), projected once per
query. The torch version below follows the kernel step for step (keys in
tiles of 32 with an online softmax) and reads the pack's head-blocked
arrays. Both sides compute in fp32 and differ in summation order only:
atol 1e-5 on outputs of order 1-10. A query with no valid key must
aggregate to exactly 0.
"""

import numpy as np
import pytest
import torch

from infgen_torch.config import Config
from infgen_torch.model.layers import DenseAttention, LayerNorm
from infgen_torch.ops import column_kernel as CK
from infgen_torch.ops import fused_block as FB
from infgen_torch.ops import pallas_attention as PA
from infgen_torch.ops import refine_kernel as RK
from infgen_torch.ops import seed_kernel as SK

from test_torch_layers import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5
KEY_TILE = 32                 # the kernel's keys per pass
WIDTHS = {"flagship": (128, 8), "narrow": (32, 2),
          "narrow_heads": (32, 8)}   # (D, heads); head_dim 4 at the last
MODES = ("per_query", "shared", "self")
MASKS = ("random", "masked_row", "all_valid")


def _fill(module, rng):
    """Every parameter from a numpy seed, non-zero biases and LayerNorm
    offsets included."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner = module.get_submodule(name.rsplit(".", 1)[0]) \
                if "." in name else module
            if isinstance(owner, LayerNorm):
                val = (name.endswith("weight") * 1.0) \
                    + rng.normal(0, 0.1, p.shape)
            elif p.dim() == 2:
                val = rng.normal(0, min(p.shape) ** -0.5, p.shape)
            else:
                val = rng.normal(0, 0.1, p.shape)
            p.copy_(torch.as_tensor(val, dtype=torch.float32))


def _case(width, mode, mask_case):
    D, H = WIDTHS[width]
    rng = np.random.default_rng(MODES.index(mode) * 7 + MASKS.index(mask_case)
                                + D)
    mod = DenseAttention(D, H, D // H, bipartite=mode == "per_query")
    _fill(mod, rng)
    Q = 128 if width == "flagship" else 37
    K = {"per_query": 12, "shared": 53, "self": Q}[mode]
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
    x, r = f(Q, D), f(Q, K, D)
    src = {"per_query": lambda: f(Q, K, D), "shared": lambda: f(K, D),
           "self": lambda: None}[mode]()
    if mask_case == "all_valid":
        mask = torch.ones((Q, K), dtype=torch.bool)
    else:
        mask = torch.as_tensor(rng.uniform(size=(Q, K)) < 0.5)
        mask[7] = True
    if mask_case == "masked_row":
        mask[3] = False
    return FB.pack_fused_block(mod), x, src, r, mask, H


def _ln(t, v, name):
    return SK._ln(t, v[name + "_s"][0], v[name + "_b"][0])


def reassociated_block(pack, x, src, r, mask, H):
    """The fused block as csrc/fused_block.cu computes it: (agg [Q, D], the
    layer's output [Q, D]), fp32."""
    w, v = pack.w, pack.v
    Q, D = x.shape
    Hd = D // H
    dn = _ln(x, v, "lnd")
    q = (dn @ w["wq"][0] + v["bq"][0]).view(Q, H, Hd)
    u = torch.einsum("jhd,ahj->ahd", pack.heads["wkh"].view(Hd, H, D), q)
    ur = torch.einsum("jhd,ahj->ahd", pack.heads["wkrh"].view(Hd, H, D), q)
    keys = x if src is None else src
    sn = _ln(keys, v, "lns")                       # [K, D] or [Q, K, D]
    rn = _ln(r, v, "lnr")
    wv, wvr = w["wv"][0].view(D, H, Hd), w["wvr"][0].view(D, H, Hd)
    bsum = (v["bv"][0] + v["bvr"][0]).view(H, Hd)
    agg = torch.zeros(Q, H, Hd)
    for a in range(Q):
        valid = torch.nonzero(mask[a]).flatten()
        ska = sn[a] if sn.dim() == 3 else sn
        m = torch.full((H,), -torch.inf)
        den, S, T = torch.zeros(H), torch.zeros(H, D), torch.zeros(H, D)
        for t0 in range(0, len(valid), KEY_TILE):
            ks = valid[t0:t0 + KEY_TILE]
            sc = (ska[ks] @ u[a].T + rn[a, ks] @ ur[a].T) * Hd ** -0.5
            mn = torch.maximum(m, sc.max(0).values)
            al, p = torch.exp(m - mn), torch.exp(sc - mn)     # [H], [k, H]
            den = den * al + p.sum(0)
            S = S * al[:, None] + p.T @ ska[ks]
            T = T * al[:, None] + p.T @ rn[a, ks]
            m = mn
        proj = torch.einsum("hd,dhj->hj", S, wv) \
            + torch.einsum("hd,dhj->hj", T, wvr)
        agg[a] = (proj + bsum * den[:, None]) \
            / torch.clamp(den, min=1e-30)[:, None]
    agg = agg.reshape(Q, D)
    g = torch.sigmoid(agg @ w["wga"][0] + dn @ w["wgd"][0] + v["bg"][0])
    a2 = agg + g * (dn @ w["ws"][0] + v["bs"][0] - agg)
    x1 = x + _ln(a2 @ w["wo"][0] + v["bo"][0], v, "post")
    h = torch.relu(_ln(x1, v, "ffp") @ w["wf0"][0] + v["bf0"][0])
    return agg, x1 + _ln(h @ w["wf1"][0] + v["bf1"][0], v, "ffq")


@pytest.mark.parametrize("mask_case", MASKS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_reassociated_block_matches_reference(width, mode, mask_case):
    pack, x, src, r, mask, H = _case(width, mode, mask_case)
    with torch.no_grad():
        agg, got = reassociated_block(pack, x, src, r, mask, H)
        ref = FB.fused_attention_block_reference(pack, x, src, r, mask, H)
    err = float((got - ref).abs().max())
    assert err <= ATOL, f"max abs error {err} > {ATOL}"
    assert torch.isfinite(got).all()
    if mask_case == "masked_row":
        assert torch.equal(agg[3], torch.zeros_like(agg[3]))


@pytest.mark.parametrize("D,H,ok", (
    (128, 8, True), (32, 2, True), (32, 8, True), (64, 16, True),
    (128, 16, False),   # u / ur need 4 column pairs per thread
    (32, 16, False),    # head_dim 2
    (96, 8, False), (128, 3, False), (128, 32, False)))
def test_kernel_accepts_widths(D, H, ok):
    """The fused kernel's width rule: every case the reassociated math is
    held at above is taken, and the widths whose weight tiles would
    overflow a thread's column pairs or a 4-row chunk are refused."""
    assert FB.kernel_accepts(D, H) is ok
    for width, (d, h) in WIDTHS.items():
        assert FB.kernel_accepts(d, h), width


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_head_blocked_layout_round_trips(width):
    D, H = WIDTHS[width]
    Hd = D // H
    mod = DenseAttention(D, H, Hd)
    _fill(mod, np.random.default_rng(3))
    pack = FB.pack_fused_block(mod)
    for name, full in (("wkh", mod.to_k.weight.T), ("wkrh", mod.w_kr)):
        blocked = pack.heads[name]
        assert blocked.shape == (Hd, H * D)
        back = blocked.view(Hd, H, D).permute(2, 1, 0).reshape(D, H * Hd)
        assert torch.equal(back, full.detach())
    # the pointer array ends with the two head-blocked arrays
    assert list(pack.ptrs)[-2:] == [pack.heads["wkh"].data_ptr(),
                                    pack.heads["wkrh"].data_ptr()]


def _seed_decoder(L, D, H):
    from infgen_torch.cli import build_tokenizers
    from infgen_torch.model.infgen import InfGenModel

    cfg = Config(max_agents=16, max_map_tokens=32, num_agent_layers=1,
                 num_seed_layers=L, num_map_layers=1, hidden_dim=D,
                 num_heads=H, head_dim=D // H, num_freq_bands=8)
    attr = build_tokenizers(cfg)[0]
    model = InfGenModel(cfg, attr.grid, attr.grid_size, attr.angle_size)
    _fill(model, np.random.default_rng(5))
    return model.agent_decoder, attr.grid_size


@pytest.mark.parametrize("L", (1, 3))
def test_chain_tiles_round_trip(L):
    """Each tile of the bf16 seed_eval_full pack is W^T of the block of the
    module parameter that csrc/seed_eval_full.cu expects at that position."""
    D, H = 64, 4
    dec, G = _seed_decoder(L, D, H)
    pack = SK.pack_seed_params_full(dec, L, G, torch.bfloat16)
    tiles = pack.tiles
    assert tiles.dtype == torch.bfloat16
    assert tiles.shape == (SK.n_chain_tiles(L), D, D)
    bf = lambda t: t.detach().to(torch.bfloat16)
    it = iter(tiles)

    def take_step(j):
        sub = [getattr(dec, f"{n}_{j // 3}") for n in ("occ2sa", "pt2sa",
                                                       "a2sa")][j % 3]
        assert torch.equal(next(it).T, bf(sub.to_g.weight.T[D:]))
        assert torch.equal(next(it).T, bf(sub.to_s.weight.T))
        assert torch.equal(next(it).T, bf(sub.to_out.weight.T))
        f0 = torch.cat([next(it).T for _ in range(4)], 1)
        assert torch.equal(f0, bf(sub.ff_0.weight.T))
        f1 = torch.cat([next(it).T for _ in range(4)], 0)
        assert torch.equal(f1, bf(sub.ff_1.weight.T))

    for i in range(L):
        take_step(3 * i)
        take_step(3 * i + 1)
        a2 = getattr(dec, f"a2sa_{i}")
        for want in (a2.to_k.weight.T, a2.w_kr, a2.to_v.weight.T, a2.w_vr):
            assert torch.equal(next(it).T, bf(want))
        if i + 1 < L:
            take_step(3 * i + 2)
    for i in range(L):
        pt = getattr(dec, f"pt2sa_{i}")
        assert torch.equal(next(it).T, bf(pt.w_kr))
        assert torch.equal(next(it).T, bf(pt.w_vr))
    assert next(it, None) is None
    assert pack.ptrs[-1] == tiles.data_ptr()
    assert SK.pack_seed_params_full(dec, L, G).tiles is None


# --------------------------------------------------------------------- #
# r_biased_attention, reassociated (csrc/r_biased_attention.cu)
# --------------------------------------------------------------------- #

RBA_WIDTHS = {"rollout": (128, 128, 8), "narrow": (32, 32, 2)}  # HD, Dr, H


def _rba_case(width, mask_case, drop):
    HD, Dr, H = RBA_WIDTHS[width]
    rng = np.random.default_rng(11 + MASKS.index(mask_case) + 3 * drop + HD)
    B, Q, K = 2, 9, 70          # three key tiles of the kernel per row
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
    q, k, v, r = f(B, Q, HD), f(B, K, HD), f(B, K, HD), f(B, Q, K, Dr)
    w_kr, w_vr = f(Dr, HD) * Dr ** -0.5, f(Dr, HD) * Dr ** -0.5
    if mask_case == "all_valid":
        mask = torch.ones((B, Q, K), dtype=torch.bool)
    else:
        mask = torch.as_tensor(rng.uniform(size=(B, Q, K)) < 0.5)
        mask[1, 4] = True
    if mask_case == "masked_row":
        mask[0, 3] = False
    d = None
    if drop:
        d = torch.as_tensor((rng.uniform(size=(B, Q, K, H)) < 0.9) / 0.9,
                            dtype=torch.float32)
    return q, k, v, r, w_kr, w_vr, mask, H, d


def reassociated_rba(q, k, v, r, w_kr, w_vr, mask, H, drop):
    """r_biased_attention as csrc/r_biased_attention.cu computes it: per
    query row ur_h = W_kr[:, h] q_h; the valid keys in tiles of 32 with an
    online softmax (running max, undropped denominator); per tile the
    scores q_h . k_h + r . ur_h, the dropped weights w and the sums
    sum w v and, per head, sum w r; at the end the relation sums projected
    through W_vr once per row. fp32."""
    B, Q, HD = q.shape
    Dr = r.shape[-1]
    Hd = HD // H
    out = torch.zeros(B, Q, HD)
    for b in range(B):
        for a in range(Q):
            qh = q[b, a].view(H, Hd)
            ur = torch.einsum("jhd,hd->hj", w_kr.view(Dr, H, Hd), qh)
            valid = torch.nonzero(mask[b, a]).flatten()
            m = torch.full((H,), -torch.inf)
            den, accv, accr = torch.zeros(H), torch.zeros(H, Hd), \
                torch.zeros(H, Dr)
            for t0 in range(0, len(valid), KEY_TILE):
                ks = valid[t0:t0 + KEY_TILE]
                sc = (r[b, a, ks] @ ur.T
                      + torch.einsum("khd,hd->kh", k[b, ks].view(-1, H, Hd),
                                     qh)) * Hd ** -0.5            # [k, H]
                mn = torch.maximum(m, sc.max(0).values)
                al, e = torch.exp(m - mn), torch.exp(sc - mn)
                den = den * al + e.sum(0)
                w = e if drop is None else e * drop[b, a, ks]
                accv = accv * al[:, None] + torch.einsum(
                    "kh,khd->hd", w, v[b, ks].view(-1, H, Hd))
                accr = accr * al[:, None] + w.T @ r[b, a, ks]
                m = mn
            proj = torch.einsum("hj,jhd->hd", accr, w_vr.view(Dr, H, Hd))
            out[b, a] = ((accv + proj)
                         / torch.clamp(den, min=1e-30)[:, None]).reshape(HD)
    return out


@pytest.mark.parametrize("drop", (False, True))
@pytest.mark.parametrize("mask_case", MASKS)
@pytest.mark.parametrize("width", sorted(RBA_WIDTHS))
def test_reassociated_rba_matches_reference(width, mask_case, drop):
    q, k, v, r, w_kr, w_vr, mask, H, d = _rba_case(width, mask_case, drop)
    got = reassociated_rba(q, k, v, r, w_kr, w_vr, mask, H, d)
    ref = PA.r_biased_attention_reference(q, k, v, r, w_kr, w_vr, mask, H,
                                          d)
    err = float((got - ref).abs().max())
    assert err <= ATOL, f"max abs error {err} > {ATOL}"
    if mask_case == "masked_row":
        assert torch.equal(got[0, 3], torch.zeros_like(got[0, 3]))


@pytest.mark.parametrize("K,HD,Dr,H,ok", (
    (128, 128, 128, 8, True),     # the rollout's call
    (300, 128, 128, 8, True),     # the smoke's bipartite call
    (16, 32, 32, 2, True),        # the parity rollout's
    (53, 64, 64, 16, True),       # head_dim 4
    (70, 48, 48, 6, True),        # heads not a multiple of four
    (40, 128, 256, 8, True),      # H Dr = 2048, the limit
    (40, 256, 64, 4, True),       # HD = 256
    (40, 512, 512, 4, False),     # the key tiles overflow shared memory
    (8, 128, 128, 32, False),     # more heads than 16
    (8, 512, 516, 4, False),      # H Dr > 2048
    (8, 1024, 256, 4, False),     # HD > 512
    (70, 48, 46, 6, False),       # Dr not a multiple of 4
    (16, 6, 8, 2, False),         # HD not a multiple of 4
    (8, 128, 128, 3, False),      # heads do not divide HD
    (60000, 128, 128, 8, False)))  # the key indices overflow shared memory
def test_rba_kernel_accepts(K, HD, Dr, H, ok):
    assert PA.kernel_accepts(K, HD, Dr, H) is ok


# --------------------------------------------------------------------- #
# motion_column's bf16 tiles (csrc/motion_column.cu)
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def column_pack():
    """Two trunk layers' worth of sublayers at the bf16 path's width."""
    rng = np.random.default_rng(13)
    subs = []
    for _ in range(2):
        for bip in (False, True, False):
            mod = DenseAttention(128, 8, 16, bipartite=bip)
            _fill(mod, rng)
            subs.append((mod, bip))
    weights, vectors, w, v, D = CK.pack_sublayers(subs, torch.bfloat16)
    return w, CK.column_tiles(w), subs


def test_swizzle_is_an_involution():
    t = torch.arange(16 * 128).reshape(16, 128)
    s = CK.swizzle(t)
    assert torch.equal(CK.swizzle(s), t)
    flat = s.reshape(-1)
    for n in range(16):          # the kernel's swz(row, k)
        for k in range(128):
            assert flat[n * 128 + (((k >> 3) ^ (n & 7)) << 3) + (k & 7)] \
                == t[n, k]


@pytest.mark.parametrize("name", CK.TILE_ORDER)
def test_column_tiles_round_trip(column_pack, name):
    """Tile `name` of each sublayer, unswizzled and transposed back, is the
    pack's matrix (its bf16 view of the module parameter)."""
    w, tiles, subs = column_pack
    t = CK.TILE_ORDER.index(name)
    assert tiles.shape == (len(subs), len(CK.TILE_ORDER), 128, 128)
    assert tiles.dtype == torch.bfloat16 and tiles.is_contiguous()
    for j, (mod, _) in enumerate(subs):
        back = CK.swizzle(tiles[j, t]).T
        assert torch.equal(back, CK.tile_matrix(w, name)[j])
    # and the pack's views are the module's parameters
    base, _, c = name.partition("/")
    full = {"wf0": lambda m: m.ff_0.weight.T, "wf1": lambda m: m.ff_1.weight.T,
            "wq": lambda m: m.to_q.weight.T, "wk": lambda m: m.to_k.weight.T,
            "wv": lambda m: m.to_v.weight.T, "wkr": lambda m: m.w_kr,
            "wvr": lambda m: m.w_vr, "ws": lambda m: m.to_s.weight.T,
            "wo": lambda m: m.to_out.weight.T,
            "wga": lambda m: m.to_g.weight.T[:128],
            "wgd": lambda m: m.to_g.weight.T[128:]}[base]
    block = slice(int(c) * 128, (int(c) + 1) * 128) if c else slice(None)
    for j, (mod, _) in enumerate(subs):
        m = full(mod).detach().to(torch.bfloat16)
        m = m[:, block] if base == "wf0" else m[block]
        assert torch.equal(CK.swizzle(tiles[j, t]).T, m)


@pytest.mark.parametrize("dtype,D,H,Hd,keys,ok", (
    (torch.bfloat16, 128, 8, 16, 128, True),    # the latency preset
    (torch.bfloat16, 128, 8, 16, 256, True),
    (torch.bfloat16, 128, 8, 16, 257, False),   # uint8 key indices
    (torch.bfloat16, 64, 4, 16, 128, False),    # tiles are D = 128
    (torch.bfloat16, 128, 16, 8, 128, False),   # heads of 16 columns
    (torch.float32, 32, 2, 16, 16, True),       # the parity rollout's
    (torch.float32, 512, 8, 64, 128, True),
    (torch.float32, 1024, 8, 128, 128, False),
    (torch.float32, 128, 8, 8, 128, False)))    # heads x head_dim != D
def test_column_kernel_accepts(dtype, D, H, Hd, keys, ok):
    assert CK.kernel_accepts(dtype, D, H, Hd, keys) is ok


# --------------------------------------------------------------------- #
# refine over a cluster of head slices (csrc/refine.cu)
# --------------------------------------------------------------------- #

REFINE_WIDTHS = {"narrow": (32, 2), "flagship": (128, 8)}   # D, heads
REFINE_L, REFINE_R, REFINE_KA, REFINE_BINS = 3, 32, 24, 120


def _refine_pack(D, H, dtype):
    from infgen_torch.cli import build_tokenizers
    from infgen_torch.model.infgen import InfGenModel

    cfg = Config(max_agents=16, max_map_tokens=32,
                 num_agent_layers=REFINE_L, num_seed_layers=1,
                 num_map_layers=1, hidden_dim=D, num_heads=H,
                 head_dim=D // H, num_freq_bands=8)
    attr = build_tokenizers(cfg)[0]
    model = InfGenModel(cfg, attr.grid, attr.grid_size, attr.angle_size)
    _fill(model, np.random.default_rng(7 + D))
    assert attr.angle_size == REFINE_BINS
    return RK.pack_refine_params(model.agent_decoder, REFINE_L,
                                 attr.angle_size, dtype)


@pytest.fixture(scope="module")
def refine_packs():
    return {(w, dt): _refine_pack(*REFINE_WIDTHS[w], dt)
            for w in REFINE_WIDTHS for dt in (torch.float32, torch.bfloat16)}


def _refine_args(D, dtype, case):
    """The rollout's padded inputs: row 0 the inserted agent, rows 1..24
    its neighbours, map key k in row k."""
    rng = np.random.default_rng(17 + D)
    f = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
    R, Ka = REFINE_R, REFINE_KA
    x = torch.zeros(R, D)
    x[:1 + Ka] = f(1 + Ka, D)
    r_aa = torch.zeros(R, D)
    r_aa[1:1 + Ka] = f(Ka, D)
    mask_a = torch.zeros(R, dtype=torch.bool)
    mask_a[1:1 + Ka] = torch.as_tensor(rng.uniform(size=Ka) < 0.6)
    mask_pl = torch.as_tensor(rng.uniform(size=R) < 0.6)
    if case == "agents_all_masked":
        mask_a[:] = False
    if case == "map_all_masked":
        mask_pl[:] = False
    return (x, f(R, D).to(dtype), f(R, D).to(dtype), mask_pl, r_aa.to(dtype),
            mask_a)


def _tile_rows(pack, c, t, off, n, width, K):
    """Rows [off / width, + n) of stage t of CTA c, each cut to K."""
    return pack.tiles[c, t, off:off + n * width].view(n, width)[:, :K]


def sliced_refine(pack, x_sub, pl_keys, r_pl, mask_pl, r_aa, mask_a, H):
    """The refine pass as csrc/refine.cu computes it, from the pack's tiles
    alone (refine_tiles) and its vectors: per CTA c its head's 16 columns of
    every product, its attention, and its share of row 0's agg @ to_g[:D]
    (its 16 aggregate values times its rows of to_g[:D]), the H shares
    added in head order; rows but 0 updated as g * s (agg == 0); the last
    sublayer's epilogue on row 0 only; the heads on CTA c's columns. fp32
    sums, operands rounded to the compute dtype where the kernel rounds
    them. Returns (heading logits, offset)."""
    f32, cdt = torch.float32, pack.dtype
    v, D, L = pack.v, pack.D, pack.L
    lay = RK.tile_layout(L, D, pack.angle_size, cdt)
    ld, ld4 = lay["ld"], lay["ld4"]
    rnd = lambda t: t.to(cdt).to(f32)
    ln = lambda t, n, j: SK._ln(t, v[n + "_s"][j], v[n + "_b"][j])
    cs = [slice(16 * c, 16 * c + 16) for c in range(H)]
    x = x_sub.to(f32).clone()
    R = x.shape[0]
    for j in range(2 * L):
        last = j == 2 * L - 1
        A = lambda c, b: _tile_rows(pack, c, 2 * j, b * 16 * ld, 16, ld,
                                    D).to(f32)
        B = lambda c, off, n, w, K: _tile_rows(pack, c, 2 * j + 1, off, n, w,
                                               K).to(f32)
        src, rel, m = (pl_keys.to(f32), r_pl, mask_pl) if j % 2 == 0 \
            else (x, r_aa, mask_a)
        dn, sn = rnd(ln(x, "lnq", j)), rnd(ln(src, "lns", j))
        rn = rnd(ln(rel.to(f32), "lnr", j))
        ag = torch.zeros(R, D)
        parts, a0, g0, s0 = [], [], [], []
        for c, cc in enumerate(cs):
            K = sn @ A(c, 1).T + rn @ A(c, 2).T
            V = ((sn @ A(c, 3).T + v["bv"][j][cc]) + rn @ A(c, 4).T) \
                + v["bvr"][j][cc]
            G, S = dn @ A(c, 5).T, dn @ A(c, 6).T + v["bs"][j][cc]
            q = dn[0] @ A(c, 0).T + v["bq"][j][cc]
            sc = torch.where(m, (K @ q) * 0.25, -torch.inf)
            e = torch.where(m, torch.exp(sc - sc.max()), 0.0)
            agg0 = (e / torch.clamp(e.sum(), min=1e-30)) @ V
            parts.append(rnd(agg0) @ A(c, 7))          # [16 k] x [16, D]
            a0.append(agg0)
            g0.append(G[0])
            s0.append(S[0])
            ag[1:, cc] = torch.sigmoid(G[1:] + v["bg"][j][cc]) * S[1:]
        ga = parts[0]
        for p in parts[1:]:
            ga = ga + p
        a, g = torch.cat(a0), torch.sigmoid((ga + torch.cat(g0))
                                            + v["bg"][j])
        ag[0] = a + g * (torch.cat(s0) - a)
        rows = slice(0, 1) if last else slice(None)
        ag = rnd(ag[rows])
        o = torch.cat([ag @ B(c, 0, 16, ld, D).T + v["bo"][j][cc]
                       for c, cc in enumerate(cs)], 1)
        x1 = x[rows] + ln(o, "post", j)
        h_in = rnd(ln(x1, "ffp", j))
        hh = rnd(torch.cat([torch.relu(
            h_in @ B(c, 16 * ld, 64, ld, D).T
            + v["bf0"][j][64 * c:64 * c + 64]) for c in range(H)], 1))
        f = torch.cat([hh @ B(c, 80 * ld, 16, ld4, 4 * D).T
                       + v["bf1"][j][cc] for c, cc in enumerate(cs)], 1)
        x[rows] = x1 + ln(f, "ffq", j)
    hop = rnd(x[0])
    hid = []
    for hi in range(2):
        hb = torch.cat([hop @ _tile_rows(pack, c, 4 * L, hi * 16 * ld, 16, ld,
                                         D).to(f32).T + v["bh0"][hi][cc]
                        for c, cc in enumerate(cs)])
        hid.append(rnd(torch.relu(SK._ln(hb, v["lnh_s"][hi],
                                         v["lnh_b"][hi]))))
    outs = []
    for hi, (n, off, per, bias) in enumerate(
            ((pack.angle_size, 32, lay["ch"], v["bh_head"]),
             (2, 32 + lay["nh"], lay["co"], v["bh_off"]))):
        cols = [hid[hi] @ _tile_rows(pack, c, 4 * L, off * ld, per, ld,
                                     D).to(f32).T for c in range(H)]
        outs.append(torch.cat(cols)[:n] + bias)
    return outs[0], outs[1]


@pytest.mark.parametrize("case", ("masked", "map_all_masked",
                                  "agents_all_masked"))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("width", sorted(REFINE_WIDTHS))
def test_sliced_refine_matches_reference(refine_packs, width, dtype, case):
    """The kernel's shortcuts hold exactly but for summation order: row 0's
    agg @ to_g[:D] as H head partials, g * s for the other rows, the last
    epilogue on row 0 only. fp32 outputs of order 1-10: atol 1e-5; bf16
    the same, as no operand lands on a rounding near-tie at these seeds."""
    D, H = REFINE_WIDTHS[width]
    pack = refine_packs[(width, dtype)]
    args = _refine_args(D, dtype, case)
    with torch.no_grad():
        got = sliced_refine(pack, *args, H)
        ref = RK.refine_reference(pack, *args, H, D // H)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.isfinite(g).all()
        err = float((g - r).abs().max())
        assert err <= ATOL, f"max abs error {err} > {ATOL}"


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("width", sorted(REFINE_WIDTHS))
def test_refine_tiles_round_trip(refine_packs, width, dtype):
    """Each block of each CTA's stages is the pack's view of the module
    parameter that csrc/refine.cu expects there; padding is zero."""
    D, H = REFINE_WIDTHS[width]
    pack = refine_packs[(width, dtype)]
    w, L = pack.w, pack.L
    lay = RK.tile_layout(L, D, pack.angle_size, dtype)
    ld, ld4 = lay["ld"], lay["ld4"]
    assert pack.tiles.shape == (H, 4 * L + 1, lay["slot"])
    assert pack.tiles.dtype == dtype
    for c in range(H):
        cc = slice(16 * c, 16 * c + 16)
        for j in range(2 * L):
            want = [w["wq"][j][:, cc].T, w["wk"][j][:, cc].T,
                    w["wkr"][j][:, cc].T, w["wv"][j][:, cc].T,
                    w["wvr"][j][:, cc].T, w["wg"][j][D:, cc].T,
                    w["ws"][j][:, cc].T, w["wg"][j][:D][cc]]
            for b, m in enumerate(want):
                assert torch.equal(
                    _tile_rows(pack, c, 2 * j, b * 16 * ld, 16, ld, D), m)
            for off, n, width_, m in (
                    (0, 16, ld, w["wo"][j][:, cc].T),
                    (16 * ld, 64, ld, w["wf0"][j][:, 64 * c:64 * c + 64].T),
                    (80 * ld, 16, ld4, w["wf1"][j][:, cc].T)):
                assert torch.equal(_tile_rows(pack, c, 2 * j + 1, off, n,
                                              width_, m.shape[1]), m)
        t = 4 * L
        for hi in range(2):
            assert torch.equal(_tile_rows(pack, c, t, hi * 16 * ld, 16, ld,
                                          D), w["wh0"][hi][:, cc].T)
        for off, per, n, m in ((32, lay["ch"], pack.angle_size, w["wh_head"]),
                               (32 + lay["nh"], lay["co"], 2, w["wh_off"])):
            got = _tile_rows(pack, c, t, off * ld, per, ld, D)
            lo, hi_ = min(n, c * per), min(n, (c + 1) * per)
            assert torch.equal(got[:hi_ - lo], m[:, lo:hi_].T)
            assert not got[hi_ - lo:].any()
    # everything outside the blocks is zero padding
    nz = pack.tiles.reshape(H, 4 * L + 1, -1).ne(0).sum()
    assert nz == sum(int(m.ne(0).sum()) for m in (
        w["wq"], w["wk"], w["wkr"], w["wv"], w["wvr"], w["wg"], w["ws"],
        w["wo"], w["wf0"], w["wf1"], w["wh0"], w["wh_head"], w["wh_off"]))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("width", sorted(REFINE_WIDTHS))
def test_refine_kernel_trace(refine_packs, width, dtype):
    """refine_kernel(..., trace=True) on CPU tensors: the untraced call's
    outputs bit for bit, and x after each sublayer as the plain sublayers
    give it, the heads reading the last one's row 0."""
    D, H = REFINE_WIDTHS[width]
    pack = refine_packs[(width, dtype)]
    args = _refine_args(D, dtype, "masked")
    x, rest = args[0], args[1:]
    with torch.no_grad():
        head, off, tr = RK.refine_kernel(pack, *args, H, D // H, trace=True)
        want = RK.refine_kernel(pack, *args, H, D // H)
        assert torch.equal(head, want[0]) and torch.equal(off, want[1])
        assert tr.shape == (2 * pack.L, *x.shape) and tr.dtype == torch.float32
        for j in range(2 * pack.L):
            step = RK.refine_sublayer(pack, j, x if j == 0 else tr[j - 1],
                                      *rest, H, D // H)
            assert torch.equal(tr[j], step)
        heads = RK.refine_heads(pack, tr[-1][0])
        assert torch.equal(head, heads[0]) and torch.equal(off, heads[1])


@pytest.mark.parametrize("dtype,D,H,Hd,R,ok", (
    (torch.bfloat16, 128, 8, 16, 32, True),     # the latency preset
    (torch.float32, 128, 8, 16, 32, True),
    (torch.float32, 32, 2, 16, 32, True),       # the parity rollout's
    (torch.bfloat16, 32, 2, 16, 32, True),      # the narrowest cluster
    (torch.bfloat16, 48, 3, 16, 20, True),
    (torch.bfloat16, 128, 16, 8, 32, False),    # heads of 8
    (torch.float32, 64, 2, 32, 32, False),      # heads of 32
    (torch.float32, 16, 1, 16, 32, False),      # a cluster of one
    (torch.bfloat16, 144, 9, 16, 32, False),    # more than 8 CTAs
    (torch.bfloat16, 128, 8, 16, 33, False),    # more than two m16 tiles
    (torch.float16, 128, 8, 16, 32, False)))
def test_refine_kernel_accepts(dtype, D, H, Hd, R, ok):
    assert RK.kernel_accepts(dtype, D, H, Hd, R) is ok


@pytest.mark.parametrize("dtype,D,H,Hd,ok", (
    (torch.bfloat16, 128, 8, 16, True),         # the flagship
    (torch.float32, 128, 8, 16, True),
    (torch.float32, 32, 2, 16, True),           # the parity rollout's
    (torch.bfloat16, 64, 4, 16, True),
    (torch.bfloat16, 32, 2, 16, False),         # 4 bf16 columns per CTA
    (torch.float32, 48, 3, 16, False),          # 6 columns per CTA
    (torch.float32, 64, 32, 2, False),          # heads of 2
    (torch.float32, 128, 8, 8, False),          # heads x head_dim != D
    (torch.float16, 128, 8, 16, False)))
def test_seed_eval_accepts(dtype, D, H, Hd, ok):
    assert SK.seed_eval_accepts(dtype, D, H, Hd) is ok
