"""One whole DenseAttention layer as one CUDA call (port of
infgen_tpu/ops/fused_block.py::fused_attention_block; the CUDA source is
csrc/fused_block.cu, whose header states its bound and design).

  pack_fused_block                 one DenseAttention module's parameters,
                                   fp32, in the layout of the trunk column's
                                   pack (column_kernel.pack_sublayers), plus
                                   head-blocked key projections
                                   (head_blocked)
  pack_column_blocks               the 3L packs of an AgentDecoder's trunk
                                   (t_attn, pt2a, a2a per layer), built once
                                   per rollout
  fused_attention_block_reference  the same math in plain PyTorch (the CPU
                                   path, and what the kernel is held against
                                   on the card)
  fused_attention_block            the wrapper: launches the kernel on CUDA
                                   tensors, takes the plain version for CPU
                                   tensors, raises otherwise

Lanes: every array may carry a leading lane axis B (one scenario each, as
`jax.vmap` batches the TPU kernel): x_dst [B, Q, D], x_src [B, Q, K, D],
[B, K, D] or None, r [B, Q, K, D], mask [B, Q, K]. Each lane is the call
on its own arrays; self-attention attends within its lane's rows.

Precision follows the TPU kernel: the weights are the fp32 masters, every
input is cast up to fp32 and the whole layer runs in fp32, with no
compute-dtype rounding of matmul operands (unlike the other kernels of the
port); only the output is cast back to x_dst's dtype. LayerNorm eps 1e-6,
two-pass statistics. A masked key contributes exactly 0; a query with no
valid key aggregates to 0. At most MAX_KEYS keys per query.
"""

from dataclasses import dataclass
from typing import Dict, List, Optional

import ctypes
import torch

from infgen_torch.ops.column_kernel import (_KINDS, _layouts, _sublayer,
                                            pack_sublayers)
from infgen_torch.ops.seed_kernel import _DTYPE_CODE, _check, _views, ptr_array

MAX_KEYS = 128   # the TPU kernel's single key tile
_SMEM_OK = set()   # (dtype, D, heads, K, per_query) whose shared memory fits


@dataclass
class FusedPack:
    weights: torch.Tensor          # flat fp32 matrices
    vectors: torch.Tensor          # flat fp32 vectors
    w: Dict[str, torch.Tensor]     # views into `weights`, [1, ...]
    v: Dict[str, torch.Tensor]     # views into `vectors`, [1, ...]
    heads: Dict[str, torch.Tensor]  # head-blocked wk / wkr (head_blocked)
    D: int
    H: int

    @property
    def dtype(self):
        return self.weights.dtype

    @classmethod
    def of(cls, weights, vectors, heads, D: int, H: int) -> "FusedPack":
        """The pack over the buffers that pack_fused_block made (or their
        counterparts in a traced program): the views are rebuilt."""
        mats, vecs = _layouts(1, D)
        return cls(weights, vectors, _views(weights, mats),
                   _views(vectors, vecs), heads, D, H)

    def views(self) -> List[torch.Tensor]:
        """Each view, layout order, then the two `heads`: the pointer array
        that csrc/fused_block.cu reads."""
        return [*self.w.values(), *self.v.values(), self.heads["wkh"],
                self.heads["wkrh"]]

    @property
    def ptrs(self) -> ctypes.Array:
        return ptr_array(self.views())


def head_blocked(w, num_heads: int) -> torch.Tensor:
    """A key projection [D, H Hd] ([in, out]) as the kernel's head-blocked
    [Hd, H D]: out[j, h D + d] = w[d, h Hd + j], so that u_h = w[:, h] q_h
    of every head is one row-tile product (csrc/fused_block.cu)."""
    D, HD = w.shape
    Hd = HD // num_heads
    return w.reshape(D, num_heads, Hd).permute(2, 1, 0).reshape(
        Hd, num_heads * D).contiguous()


def pack_fused_block(module) -> FusedPack:
    """The fp32 pack of one DenseAttention module (its query LayerNorm is
    prenorm_dst when the module is bipartite, prenorm_src otherwise), with
    head-blocked copies of to_k and w_kr appended to the pointer array."""
    weights, vectors, w, v, D = pack_sublayers(
        [(module, module.bipartite)], torch.float32)
    H = module.num_heads
    heads = {"wkh": head_blocked(w["wk"][0], H),
             "wkrh": head_blocked(w["wkr"][0], H)}
    return FusedPack(weights, vectors, w, v, heads, D, H)


def pack_column_blocks(decoder, L: int):
    """[3L] packs of the trunk's sublayers, j = 3l + kind (kind 0 t_attn,
    1 pt2a, 2 a2a)."""
    return [pack_fused_block(getattr(decoder, f"{name}_{i}"))
            for i in range(L) for name, _ in _KINDS]


def kernel_accepts(D: int, num_heads: int) -> bool:
    """Whether csrc/fused_block.cu takes a layer of width D with num_heads
    heads: D in (32, 64, 128); num_heads a power of two up to 16 with a
    head_dim (D / num_heads) divisible by 4; and num_heads * D <= 1024, as
    the per-head query products (u, ur: [head_dim, num_heads * D]) give
    each of the block's 256 threads at most two column pairs and need
    weight chunks of at least 4 rows."""
    if D not in (32, 64, 128) or num_heads < 1 or num_heads > 16:
        return False
    Hd = D // num_heads
    return (num_heads & (num_heads - 1) == 0 and Hd % 4 == 0
            and num_heads * D <= 1024)


def _mode(x_dst, x_src):
    """Key mode of a call: 'self' (x_src None), 'shared' ([..., K, D]) or
    'per_query' ([..., Q, K, D]: one more axis than x_dst)."""
    if x_src is None:
        return "self"
    return "per_query" if x_src.dim() == x_dst.dim() + 1 else "shared"


def fused_attention_block_reference(pack: FusedPack, x_dst, x_src, r, mask,
                                    num_heads: int) -> torch.Tensor:
    """Plain-PyTorch DenseAttention layer, the kernel's math (the TPU
    kernel's `_kernel`): fp32 throughout. x_dst [Q, D]; x_src [Q, K, D]
    (keys gathered per query), [K, D] (shared keys) or None (self-attention
    over x_dst); r [Q, K, D]; mask [Q, K] bool. Returns [Q, D] in x_dst's
    dtype. With a lane axis (x_dst [B, Q, D], the others likewise) each
    lane is the call on its own arrays, into [B, Q, D]."""
    if x_dst.dim() == 3:
        return torch.stack([fused_attention_block_reference(
            pack, x_dst[b], None if x_src is None else x_src[b], r[b],
            mask[b], num_heads) for b in range(x_dst.shape[0])])
    f32 = torch.float32
    Q, D = x_dst.shape
    keys = x_src
    if _mode(x_dst, x_src) == "shared":
        keys = x_src[None].expand(Q, *x_src.shape)
    out = _sublayer(pack, 0, x_dst.to(f32),
                    None if keys is None else keys.to(f32), r.to(f32),
                    mask, num_heads, D // num_heads, None)
    return out.to(x_dst.dtype)


def fused_attention_block(pack: FusedPack, x_dst, x_src, r, mask,
                          num_heads: int) -> torch.Tensor:
    """One DenseAttention layer (shapes and math of
    fused_attention_block_reference), with or without a leading lane axis.
    x_dst, x_src and r share one dtype, float32 or bfloat16, and are
    contiguous; the output takes the dtype. Runs the registered op
    `infgen::fused_attention_block`: CUDA tensors launch csrc/fused_block.cu
    on the current stream (one launch for every lane, counted once in
    `fused_attention_block.launches`); CPU tensors take the plain version.
    The kernel's widths: kernel_accepts, with the pack's num_heads."""
    dev = x_dst.device
    mode = _mode(x_dst, x_src)
    lead = tuple(x_dst.shape[:-2])
    if len(lead) > 1:
        raise ValueError("fused_attention_block takes x_dst [Q, D] or "
                         f"[B, Q, D], got {tuple(x_dst.shape)}")
    Q, D = x_dst.shape[-2:]
    K = r.shape[-2]
    dt = x_dst.dtype
    if K > MAX_KEYS:
        raise ValueError(f"fused_attention_block takes at most {MAX_KEYS} "
                         f"keys per query, got {K}")
    if dt not in _DTYPE_CODE:
        raise ValueError(f"fused_attention_block: dtype {dt} unsupported")
    if D != pack.D or D > 512 or D % num_heads:
        raise ValueError("fused_attention_block needs x_dst [Q, D] with the "
                         "pack's D <= 512, a multiple of num_heads")
    _check("x_dst", x_dst, dt, (*lead, Q, D), dev)
    if mode == "per_query":
        _check("x_src", x_src, dt, (*lead, Q, K, D), dev)
    elif mode == "shared":
        _check("x_src", x_src, dt, (*lead, K, D), dev)
    elif K != Q:
        raise ValueError("self-attention needs r [Q, Q, D]")
    _check("r", r, dt, (*lead, Q, K, D), dev)
    _check("mask", mask, torch.bool, (*lead, Q, K), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention_block: unsupported device {dev}")
    if dev.type == "cuda" and num_heads != pack.H:
        raise ValueError(f"fused_attention_block: {num_heads} heads, the "
                         f"pack's {pack.H}")
    return torch.ops.infgen.fused_attention_block(pack.views(), x_dst, x_src,
                                                  r, mask, num_heads)


def _op_pack(views, D, H) -> FusedPack:
    """The FusedPack of an op's arguments (its flat buffers are not
    needed)."""
    mats, vecs = _layouts(1, D)
    names = [n for n, _ in mats + vecs]
    n_w = len(mats)
    return FusedPack(views[0], views[n_w],
                     dict(zip(names[:n_w], views[:n_w])),
                     dict(zip(names[n_w:], views[n_w:len(names)])),
                     dict(wkh=views[-2], wkrh=views[-1]), D, H)


@torch.library.custom_op("infgen::fused_attention_block", mutates_args=(),
                         device_types="cpu")
def _fused_block_op(views: List[torch.Tensor], x_dst: torch.Tensor,
                    x_src: Optional[torch.Tensor], r: torch.Tensor,
                    mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    pack = _op_pack(views, x_dst.shape[-1], num_heads)
    return fused_attention_block_reference(pack, x_dst, x_src, r, mask,
                                           num_heads).contiguous()


@_fused_block_op.register_fake
def _(views, x_dst, x_src, r, mask, num_heads):
    return torch.empty_like(x_dst, memory_format=torch.contiguous_format)


@_fused_block_op.register_kernel("cuda")
def _(views, x_dst, x_src, r, mask, num_heads):
    dev = x_dst.device
    mode = _mode(x_dst, x_src)
    lead = tuple(x_dst.shape[:-2])
    Q, D = x_dst.shape[-2:]
    K = r.shape[-2]
    dt = x_dst.dtype
    Hd = D // num_heads
    if not kernel_accepts(D, num_heads):
        raise ValueError("the fused_attention_block kernel takes D in "
                         "(32, 64, 128), the pack's num_heads, a power of "
                         "two up to 16 with num_heads * D <= 1024, and a "
                         "head_dim divisible by 4 (kernel_accepts)")
    mats, vecs = _layouts(1, D)
    if len(views) != len(mats) + len(vecs) + 2:
        raise ValueError(f"fused_attention_block: {len(views)} views, "
                         f"expected {len(mats) + len(vecs) + 2}")
    for (name, shape), t in zip(mats + vecs, views):
        _check(name, t, torch.float32, shape, dev)
    for name, t in zip(("wkh", "wkrh"), views[-2:]):
        _check(name, t, torch.float32, (Hd, D * num_heads), dev)

    from infgen_torch.ops.build import library
    lib = library()
    per_query = int(mode == "per_query")
    shape = (_DTYPE_CODE[dt], D, num_heads, K, per_query)
    if shape not in _SMEM_OK:
        smem = lib.infgen_fused_block_smem(*shape)
        if smem > 232448:
            raise ValueError(f"fused_attention_block: {smem} B of shared "
                             "memory exceed the 227 KB a block can use")
        _SMEM_OK.add(shape)
    out = torch.empty((*lead, Q, D), dtype=dt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.infgen_fused_block(
        _DTYPE_CODE[dt], x_dst.data_ptr(),
        0 if x_src is None else x_src.data_ptr(), r.data_ptr(),
        mask.data_ptr(), ctypes.addressof(ptr_array(views)), out.data_ptr(),
        lead[0] if lead else 1, Q, K, D, num_heads, Hd, per_query, stream)
    if err != 0:
        raise RuntimeError(f"fused_block kernel launch failed: cudaError "
                           f"{err}")
    fused_attention_block.launches += 1
    return out


fused_attention_block.launches = 0
