"""The designs of the port's redesigned CUDA kernels, held on the CPU in
plain torch (no JAX): the reassociated attention of the fused DenseAttention
block (csrc/fused_block.cu) against the plain `fused_attention_block_reference`,
the reassociated relation-biased attention (csrc/r_biased_attention.cu)
against `r_biased_attention_reference`, the host-side weight layouts the
kernels read (the fused block's head-blocked key projections, the
seed_eval_full bf16 path's weight tiles, the trunk column's swizzled tiles)
against the module parameters they come from, and the kernels' width rules.

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
from infgen_torch.ops import seed_kernel as SK

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
    weights, vectors, w, v, ptrs, D = CK.pack_sublayers(subs, torch.bfloat16)
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
