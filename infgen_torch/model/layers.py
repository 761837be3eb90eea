"""Core layers (port of infgen_tpu/model/layers.py, the non-Pallas branch).

Parameter names and layouts follow the flax modules one to one, so that a
converted flax tree fills these modules by name (convert.py):
  - `Dense.weight` is torch's `[out, in]` (flax `kernel` transposed);
  - `LayerNorm.weight` / `.bias` are flax's `scale` / `bias`;
  - `Embed.weight` is flax's `embedding`;
  - the raw r-projections `w_kr` / `w_vr` keep flax's `[in, out]` layout,
    because they are used as `r_n @ w_kr`.

Compute-dtype policy (ops/precision.py): with `dtype=bfloat16` a Dense casts
its input, weight and bias to bf16 (fp32 accumulation inside the matmul,
the product rounded to bf16 before the bias is added, as flax does);
with `dtype=None` it computes in the promotion of its input and its
weight (float32 for an fp32 input, or for any input with fp32 weights; a
bf16 input meets bf16-stored weights, `param_dtype`, in bf16, as flax's
promotion has it).
LayerNorm statistics are fp32 with eps 1e-6 (flax's default, not torch's
1e-5), the output cast to the module dtype; a bf16 sigmoid rounds as XLA's
does (`sigmoid`). Attention scores and softmax are
fp32.
"""

import contextlib
import contextvars
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-6


def _out_dtype(x, dtype, param_dtype=torch.float32):
    """The module's compute dtype, else the promotion of its input and its
    parameters (flax's promote_dtype: bf16-stored weights, param_dtype,
    keep an fp32 input fp32 and a bf16 one bf16)."""
    return dtype if dtype is not None else torch.promote_types(x.dtype,
                                                               param_dtype)


_LANE_PRODUCTS = contextvars.ContextVar("lane_products", default=False)


@contextlib.contextmanager
def lane_products():
    """Within it, a Dense on a CPU input of three or more dims multiplies
    each slice of the leading (lane) axis as a matrix product of its own,
    all in one batched product: a lane's rows then round as when that lane
    is computed alone (the rollout's B-row products otherwise sum in
    another order than a single rollout's one-row products). CUDA inputs
    keep the one B-row product, as before: cuBLAS does not promise that a
    batch entry rounds as the lone product, so there the batched form
    would buy nothing shown."""
    token = _LANE_PRODUCTS.set(True)
    try:
        yield
    finally:
        _LANE_PRODUCTS.reset(token)


def _linear(x, w, b=None):
    """F.linear, lane by lane under lane_products."""
    if not (_LANE_PRODUCTS.get() and x.dim() >= 3
            and x.device.type == "cpu"):
        return F.linear(x, w, b)
    B = x.shape[0]
    y = torch.bmm(x.reshape(B, -1, x.shape[-1]),
                  w.t().expand(B, *w.t().shape))
    y = y.reshape(*x.shape[:-1], w.shape[0])
    return y if b is None else y + b


def _as(x, dtype):
    """x in `dtype`: x itself when it has it (as x.to would return), with
    no cast recorded when a program is traced (torch.export)."""
    return x if x.dtype == dtype else x.to(dtype)


def sigmoid(x):
    """jax.nn.sigmoid as XLA evaluates it: 1 / (1 + exp(-x)) with each step
    rounded to x's dtype. Under bf16 that is three roundings, where
    torch.sigmoid rounds once and differs in the last bit on about a third
    of the values. fp32 keeps torch.sigmoid: one kernel instead of three,
    equal within fp32 rounding."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def layer_norm_fp32(v, weight, bias, dtype=None):
    """Two-pass LayerNorm with fp32 statistics, output in `dtype` (None keeps
    the input dtype). The form of infgen_tpu's dense_attention_zero_agg and
    seed_fast helpers."""
    f32 = torch.float32
    v32 = _as(v, f32)
    m = v32.mean(-1, keepdim=True)
    var = ((v32 - m) ** 2).mean(-1, keepdim=True)
    y = (v32 - m) * torch.rsqrt(var + LN_EPS)
    y = y * _as(weight, f32) + _as(bias, f32)
    return _as(y, dtype if dtype is not None else v.dtype)


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.dtype = dtype

    def forward(self, x):
        dt = _out_dtype(x, self.dtype, self.weight.dtype)
        w = _as(self.weight, dt)
        if self.bias is None or dt == torch.float32:
            # fp32: one kernel; the fused bias equals flax's separate add
            # within fp32 rounding
            b = _as(self.bias, dt) if self.bias is not None else None
            return _linear(_as(x, dt), w, b)
        # flax rounds x @ W to the compute dtype, then adds the bias in it:
        # two roundings, where a fused bias would round once
        return _linear(_as(x, dt), w) + _as(self.bias, dt)


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm: fast variance E[x^2] - E[x]^2 in fp32 (clipped
    at 0), y = (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype

    def forward(self, x, dtype=None):
        """`dtype` overrides the module's output dtype (flax's LayerNorm
        built without one)."""
        f32 = torch.float32
        x32 = _as(x, f32)
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + LN_EPS) * _as(self.weight, f32)
        y = (x32 - mean) * mul + _as(self.bias, f32)
        return _as(y, _out_dtype(x, dtype or self.dtype, self.weight.dtype))


class Embed(nn.Module):
    def __init__(self, num: int, dim: int, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim))
        self.dtype = dtype

    def forward(self, idx):
        w = self.weight if self.dtype is None else self.weight.to(self.dtype)
        return w[idx.long()]


class MLPLayer(nn.Module):
    """Linear -> LN -> ReLU -> Linear."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 dtype=None):
        super().__init__()
        self.Dense_0 = Dense(in_dim, hidden_dim, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(hidden_dim, dtype=dtype)
        self.Dense_1 = Dense(hidden_dim, output_dim, dtype=dtype)

    def forward(self, x):
        return self.Dense_1(F.relu(self.LayerNorm_0(self.Dense_0(x))))


class MLPEmbedding(nn.Module):
    """3-layer embedding MLP (first hidden width fixed at 128)."""

    def __init__(self, in_dim: int, hidden_dim: int, dtype=None):
        super().__init__()
        self.Dense_0 = Dense(in_dim, 128, dtype=dtype)
        self.LayerNorm_0 = LayerNorm(128, dtype=dtype)
        self.Dense_1 = Dense(128, hidden_dim, dtype=dtype)
        self.LayerNorm_1 = LayerNorm(hidden_dim, dtype=dtype)
        self.Dense_2 = Dense(hidden_dim, hidden_dim, dtype=dtype)

    def forward(self, x):
        x = F.relu(self.LayerNorm_0(self.Dense_0(x)))
        x = F.relu(self.LayerNorm_1(self.Dense_1(x)))
        return self.Dense_2(x)


class FourierEmbedding(nn.Module):
    """Learnable sinusoidal embedding per continuous input channel:
    [..., input_dim] -> [..., hidden_dim]."""

    def __init__(self, input_dim: int, hidden_dim: int, num_freq_bands: int,
                 dtype=None):
        super().__init__()
        self.input_dim = input_dim
        self.freqs = nn.Parameter(torch.empty(input_dim, num_freq_bands))
        for i in range(input_dim):
            setattr(self, f"mlp_{i}_0",
                    Dense(2 * num_freq_bands + 1, hidden_dim, dtype=dtype))
            setattr(self, f"mlp_{i}_ln", LayerNorm(hidden_dim, dtype=dtype))
            setattr(self, f"mlp_{i}_1", Dense(hidden_dim, hidden_dim,
                                              dtype=dtype))
        self.out_ln = LayerNorm(hidden_dim, dtype=dtype)
        self.out_dense = Dense(hidden_dim, hidden_dim, dtype=dtype)

    def forward(self, x, categorical_embs: Optional[list] = None):
        if x is not None:
            # cos/sin of the raw fp32 features, then compute-dtype MLPs
            xf = x[..., None] * self.freqs * 2 * math.pi
            feat = torch.cat([torch.cos(xf), torch.sin(xf), x[..., None]], -1)
            out = 0
            for i in range(self.input_dim):
                h = getattr(self, f"mlp_{i}_0")(feat[..., i, :])
                h = F.relu(getattr(self, f"mlp_{i}_ln")(h))
                out = out + getattr(self, f"mlp_{i}_1")(h)
            if categorical_embs is not None:
                out = out + _sum(categorical_embs)
        else:
            out = _sum(categorical_embs)
        return self.out_dense(F.relu(self.out_ln(out)))


def _sum(xs):
    out = 0
    for x in xs:
        out = out + x
    return out


class DenseAttention(nn.Module):
    """Masked dense attention with gated update and FFN.

    x_dst [..., Q, D]; x_src [..., K, D] (None: self-attention over x_dst);
    r [..., Q, K, D] (per pair) or [..., K, D] (shared by all queries) or
    None; mask [..., Q, K] bool (True = attend). Fully-masked queries
    aggregate to zero. Pre-LN on src/dst (shared unless bipartite), K and V
    biased by the relative-geometry embedding r, gated update, post-LN
    residual, then the pre-LN FFN.

    use_pallas: eligible calls (`pallas_eligible`) take the attention core
    from ops/pallas_attention.r_biased_attention_trainable (the CUDA kernel
    r_biased_attention forward on the card, the plain recompute backward)
    with the JAX package's precision recipe for that branch.

    Training: in train mode, with `dropout` > 0 and a `generator` given to
    the call, the softmax weights (per head) and the FFN's hidden units are
    dropped as flax's nn.Dropout drops them (kept values scaled by
    1 / (1 - dropout)); without a generator the call is deterministic, as
    the JAX module is by default. `remat` wraps the call in
    torch.utils.checkpoint (non-reentrant) while grad is enabled: only the
    inputs are kept, the layer runs again in the backward. The dropout
    masks are drawn before the checkpointed region and passed in, because
    checkpoint restores the global RNG state, not an explicit generator's,
    and a recompute that drew anew would take other masks.
    """

    def __init__(self, hidden_dim: int, num_heads: int, head_dim: int,
                 bipartite: bool = False, has_pos_emb: bool = True,
                 use_pallas: bool = False, dtype=None, dropout: float = 0.0,
                 remat: bool = False):
        super().__init__()
        D, HD = hidden_dim, num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.bipartite, self.has_pos_emb, self.dtype = (bipartite,
                                                        has_pos_emb, dtype)
        self.use_pallas = use_pallas
        self.dropout, self.remat = dropout, remat
        self.prenorm_src = LayerNorm(D, dtype)
        if bipartite:
            self.prenorm_dst = LayerNorm(D, dtype)
        self.to_q = Dense(D, HD, dtype=dtype)
        self.to_k = Dense(D, HD, bias=False, dtype=dtype)
        self.to_v = Dense(D, HD, dtype=dtype)
        if has_pos_emb:
            self.w_kr = nn.Parameter(torch.empty(D, HD))
            self.w_vr = nn.Parameter(torch.empty(D, HD))
            self.b_vr = nn.Parameter(torch.zeros(HD))
            self.prenorm_r = LayerNorm(D, dtype)
        self.to_g = Dense(HD + D, HD, dtype=dtype)
        self.to_s = Dense(D, HD, dtype=dtype)
        self.to_out = Dense(HD, D, dtype=dtype)
        self.postnorm = LayerNorm(D, dtype)
        self.ff_prenorm = LayerNorm(D, dtype)
        self.ff_0 = Dense(D, 4 * D, dtype=dtype)
        self.ff_1 = Dense(4 * D, D, dtype=dtype)
        self.ff_postnorm = LayerNorm(D, dtype)

    def _cast(self, w):
        """A raw weight in the compute dtype; without one, promoted as jnp
        promotes it against fp32 inputs (a bf16-stored weight computes in
        fp32, param_dtype)."""
        return _as(w, self.dtype if self.dtype is not None else
                   torch.promote_types(w.dtype, torch.float32))

    def forward(self, x_dst, x_src=None, r=None, mask=None, generator=None):
        keep = (None, None)
        if generator is not None and self.training and self.dropout > 0.0:
            keep = self.draw_dropout(x_dst, x_src, mask, generator)
        if self.remat and torch.is_grad_enabled():
            # the region draws nothing: no RNG state to stash
            return checkpoint(self._forward, x_dst, x_src, r, mask, *keep,
                              use_reentrant=False, preserve_rng_state=False)
        return self._forward(x_dst, x_src, r, mask, *keep)

    def draw_dropout(self, x_dst, x_src, mask, generator):
        """Keep masks (bool) of the softmax weights [..., Q, K, H] and of
        the FFN's hidden units [..., Q, 4D], from torch.bernoulli."""
        src = x_dst if x_src is None else x_src
        lead = torch.broadcast_shapes(
            x_dst.shape[:-2], src.shape[:-2],
            mask.shape[:-2] if mask is not None else ())
        Q, K, D = x_dst.shape[-2], src.shape[-2], x_dst.shape[-1]
        p = torch.full((), 1.0 - self.dropout, device=generator.device)
        draw = lambda *shape: torch.bernoulli(
            p.expand(shape), generator=generator).bool().to(x_dst.device)
        return draw(*lead, Q, K, self.num_heads), draw(*lead, Q, 4 * D)

    def _drop(self, x, keep):
        """flax nn.Dropout: kept values / (1 - rate), dropped ones 0."""
        if keep is None:
            return x
        return torch.where(keep, x / (1.0 - self.dropout), 0.0)

    def _forward(self, x_dst, x_src, r, mask, attn_keep, ff_keep):
        H, Hd = self.num_heads, self.head_dim
        same = x_src is None
        if same:
            x_src = x_dst
        src_n = self.prenorm_src(x_src)
        if self.bipartite:
            dst_n = self.prenorm_dst(x_dst)
        else:
            dst_n = src_n if same else self.prenorm_src(x_dst)

        q = self.to_q(dst_n)
        k = self.to_k(src_n)
        v = self.to_v(src_n)
        q = q.reshape(*q.shape[:-1], H, Hd)
        k = k.reshape(*k.shape[:-1], H, Hd)
        v = v.reshape(*v.shape[:-1], H, Hd)
        r_per_pair = r is not None and r.dim() == x_src.dim() + 1
        if self.pallas_eligible(x_dst, x_src, r_per_pair, mask):
            agg = self._kernel_agg(x_dst, q, k, v, r, mask, attn_keep)
            return self._epilogue(x_dst, dst_n, agg, ff_keep)

        # scores accumulate in fp32 under any compute dtype
        f32 = torch.float32
        sim = torch.einsum("...qhd,...khd->...qkh", _as(q, f32), _as(k, f32))
        if self.has_pos_emb and r is not None:
            r_n = self.prenorm_r(r)
            k_r = (r_n @ self._cast(self.w_kr)).reshape(*r_n.shape[:-1], H, Hd)
            v_r = (r_n @ self._cast(self.w_vr) + self._cast(self.b_vr)
                   ).reshape(*r_n.shape[:-1], H, Hd)
            eq = "...qhd,...qkhd->...qkh" if r_per_pair else \
                "...qhd,...khd->...qkh"
            sim = sim + torch.einsum(eq, _as(q, f32), _as(k_r, f32))
        sim = sim * (Hd ** -0.5)

        if mask is not None:
            sim = torch.where(mask[..., None], sim, -torch.inf)
        attn = torch.softmax(sim, dim=-2)
        if mask is not None:
            # fully-masked queries: softmax of -inf rows is NaN -> zero
            any_valid = mask.any(dim=-1)
            attn = torch.where(any_valid[..., None, None], attn, 0.0)
            attn = torch.where(mask[..., None], attn, 0.0)
        attn = _as(self._drop(attn, attn_keep), v.dtype)
        agg = torch.einsum("...qkh,...khd->...qhd", attn, v)
        if self.has_pos_emb and r is not None:
            eq = "...qkh,...qkhd->...qhd" if r_per_pair else \
                "...qkh,...khd->...qhd"
            agg = agg + torch.einsum(eq, attn, v_r)
        agg = agg.reshape(*agg.shape[:-2], H * Hd)
        return self._epilogue(x_dst, dst_n, agg, ff_keep)

    def pallas_eligible(self, x_dst, x_src, r_per_pair, mask) -> bool:
        """The JAX package's rule for the fused attention kernel: per-pair
        r, a mask, x_dst batched [B, Q, D] or an unbatched [Q, D] x [K, D]
        call (riding as B = 1), and at least 8 queries."""
        unbatched = x_dst.dim() == 2 and x_src.dim() == 2
        return (self.use_pallas and self.has_pos_emb and r_per_pair
                and mask is not None and (x_dst.dim() == 3 or unbatched)
                and x_dst.shape[-2] >= 8)

    def _kernel_agg(self, x_dst, q, k, v, r, mask, attn_keep=None):
        """The attention aggregate through r_biased_attention_trainable, in
        fp32 with the JAX branch's casts: prenorm_r without the compute
        dtype, q and k the compute-dtype projections cast up, b_vr added to
        v in the compute dtype, w_kr / w_vr rounded to it, the dropout keep
        mask as a per-head multiplier, and the aggregate cast back to
        x_dst's dtype."""
        from infgen_torch.ops.pallas_attention import \
            r_biased_attention_trainable

        H, Hd = self.num_heads, self.head_dim
        f32 = torch.float32
        r_n = self.prenorm_r(r, dtype=f32)
        q2 = q.reshape(*q.shape[:-2], H * Hd).to(f32)
        k2 = k.reshape(*k.shape[:-2], H * Hd).to(f32)
        v2 = (v.reshape(*v.shape[:-2], H * Hd)
              + self._cast(self.b_vr)).to(f32)
        drop = None
        if attn_keep is not None:
            drop = attn_keep.to(f32) / (1.0 - self.dropout)
        unbatched = x_dst.dim() == 2
        if unbatched:
            q2, k2, v2, r_n, mask = (t[None] for t in (q2, k2, v2, r_n,
                                                       mask))
            drop = None if drop is None else drop[None]
        agg = r_biased_attention_trainable(
            q2.contiguous(), k2.contiguous(), v2.contiguous(),
            r_n.contiguous(), self._cast(self.w_kr).to(f32).contiguous(),
            self._cast(self.w_vr).to(f32).contiguous(), mask.contiguous(),
            H, None if drop is None else drop.contiguous()).to(x_dst.dtype)
        return agg[0] if unbatched else agg

    def _epilogue(self, x_dst, dst_n, agg, ff_keep=None):
        g = sigmoid(self.to_g(torch.cat([agg, dst_n], -1)))
        agg = agg + g * (self.to_s(dst_n) - agg)
        x = x_dst + self.postnorm(self.to_out(agg))
        h = self._drop(F.relu(self.ff_0(self.ff_prenorm(x))), ff_keep)
        return x + self.ff_postnorm(self.ff_1(h))

    def zero_agg(self, x):
        """Closed form for rows with NO incident edges (agg == 0):
        g = sigmoid(to_g([0, dst_n])), agg = g * to_s(dst_n), then the
        residual/FFN epilogue. Port of dense_attention_zero_agg: two-pass
        fp32 LayerNorm, the residual carrier kept in the input dtype."""
        dt = self.dtype
        ln = self.prenorm_dst if self.bipartite else self.prenorm_src
        dst_n = layer_norm_fp32(x, ln.weight, ln.bias, dt)
        HD = self.to_s.weight.shape[0]
        c = self._cast
        g = sigmoid(dst_n @ c(self.to_g.weight)[:, HD:].T
                          + c(self.to_g.bias))
        agg = g * (dst_n @ c(self.to_s.weight).T + c(self.to_s.bias))
        attn_out = agg @ c(self.to_out.weight).T + c(self.to_out.bias)
        x1 = x + layer_norm_fp32(attn_out, self.postnorm.weight,
                                 self.postnorm.bias, dt)
        h = layer_norm_fp32(x1, self.ff_prenorm.weight, self.ff_prenorm.bias,
                            dt)
        h = F.relu(h @ c(self.ff_0.weight).T + c(self.ff_0.bias))
        h = h @ c(self.ff_1.weight).T + c(self.ff_1.bias)
        return x1 + layer_norm_fp32(h, self.ff_postnorm.weight,
                                    self.ff_postnorm.bias, dt)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator):
    """Initialise every parameter from `generator` with the flax init zoo:
    xavier-uniform Dense kernels and r-projections, zero biases, unit/zero
    LayerNorms, N(0, 0.02) embeddings and Fourier frequencies. Draws run on
    the CPU in parameter-name order, so a seed gives the same weights on any
    device."""
    for name, p in sorted(module.named_parameters()):
        leaf = name.rsplit(".", 1)[-1]
        owner = module.get_submodule(name.rsplit(".", 1)[0]) \
            if "." in name else module
        if isinstance(owner, LayerNorm):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf in ("bias", "b_vr"):
            p.zero_()
        elif isinstance(owner, Embed) or leaf == "freqs":
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        else:   # Dense weight [out, in] or raw w_kr/w_vr [in, out]
            bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound
                    - bound)
