"""Decomposed seed-stack evaluation with precomputed keys and values (port of
infgen_tpu/ops/seed_fast.py).

The insertion seed stack evaluates ONE query against three key sets per
layer: the occupancy embedding (one key), the map tokens and the agent rows.
These functions split the DenseAttention math so that the x_pt projections
happen once per rollout, the geometry terms and agent-row projections once
per step, and a single row is patched after each insertion. Each takes a
DenseAttention module (model/layers.py) for its parameters; the math is the
module's: fp32 LayerNorm statistics (two-pass, eps 1e-6), matmul operands in
the compute dtype, fp32 scores and softmax, gated update, FFN.
"""

import torch
import torch.nn.functional as F

from infgen_torch.model.layers import layer_norm_fp32, sigmoid


def _ln(v, ln, dtype):
    return layer_norm_fp32(v, ln.weight, ln.bias, dtype)


def _cast(w, dtype):
    return w.to(dtype) if dtype is not None else w


def _mm(x, dense, dtype):
    y = x @ _cast(dense.weight, dtype).T
    if dense.bias is not None:
        y = y + _cast(dense.bias, dtype)
    return y


def precompute_src_kv(layer, x_src, dtype=None):
    """Source-side k/v projections (no geometry): [..., N, H*Hd] each."""
    src_n = _ln(x_src, layer.prenorm_src, dtype)
    return _mm(src_n, layer.to_k, dtype), _mm(src_n, layer.to_v, dtype)


def r_contrib(layer, r_emb, dtype=None):
    """Geometry contributions k_r / v_r of the embedded relation r
    [..., N, D]."""
    r_n = _ln(r_emb, layer.prenorm_r, dtype)
    k_r = r_n @ _cast(layer.w_kr, dtype)
    v_r = r_n @ _cast(layer.w_vr, dtype) + _cast(layer.b_vr, dtype)
    return k_r, v_r


def gate_ffn(layer, x_dst, dst_n, agg, dtype=None):
    """Gated update + FFN epilogue; the residual carrier keeps the input
    dtype."""
    g = sigmoid(_mm(torch.cat([agg, dst_n], -1), layer.to_g, dtype))
    agg = agg + g * (_mm(dst_n, layer.to_s, dtype) - agg)
    x = x_dst + _ln(_mm(agg, layer.to_out, dtype), layer.postnorm, dtype)
    h = F.relu(_mm(_ln(x, layer.ff_prenorm, dtype), layer.ff_0, dtype))
    h = _mm(h, layer.ff_1, dtype)
    return x + _ln(h, layer.ff_postnorm, dtype)


def attn_1q(layer, sd, k, v, mask, num_heads, dtype=None, bipartite=True):
    """One-query attention over precomputed k/v [..., N, H*Hd] (source and
    geometry terms summed) with mask [..., N], then the epilogue. sd
    [..., D]; leading dims are the rollout's lanes, one query each."""
    dst_n = _ln(sd, layer.prenorm_dst if bipartite else layer.prenorm_src,
                dtype)
    q = _mm(dst_n, layer.to_q, dtype)
    H = num_heads
    Hd = q.shape[-1] // H
    lead = q.shape[:-1]
    sim = torch.einsum("...hd,...khd->...kh",
                       q.reshape(*lead, H, Hd).float(),
                       k.reshape(*lead, -1, H, Hd).float()) * (Hd ** -0.5)
    sim = torch.where(mask[..., None], sim, -torch.inf)
    attn = torch.softmax(sim, dim=-2)
    attn = torch.where(mask.any(-1)[..., None, None], attn, 0.0)
    attn = torch.where(mask[..., None], attn, 0.0).to(v.dtype)
    agg = torch.einsum("...kh,...khd->...hd", attn,
                       v.reshape(*lead, -1, H, Hd)).reshape(*lead, H * Hd)
    return gate_ffn(layer, sd, dst_n, agg, dtype)


def attn_1q_single_key(layer, sd, v_key, dtype=None):
    """One query, ONE always-valid key (occ2sa): agg is that key's value."""
    dst_n = _ln(sd, layer.prenorm_dst, dtype)
    return gate_ffn(layer, sd, dst_n, v_key, dtype)


def occ_value(layer, occ_emb, dtype=None):
    """Value projection of the occupancy embedding (the occ2sa key)."""
    return _mm(_ln(occ_emb, layer.prenorm_src, dtype), layer.to_v, dtype)
