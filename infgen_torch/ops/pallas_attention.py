"""Masked attention with relation-biased keys and values as one CUDA call
(port of infgen_tpu/ops/pallas_attention.py::r_biased_attention; the file
keeps its counterpart's name, but what it launches is CUDA C++,
csrc/r_biased_attention.cu, whose header states its bound and design).

  r_biased_attention_reference  the same math in plain PyTorch (the CPU
                                path, and what the kernel is held against on
                                the card); a port of the JAX package's
                                r_biased_attention_reference
  r_biased_attention            the wrapper: launches the kernel on CUDA
                                tensors, takes the plain version for CPU
                                tensors, raises otherwise
  kernel_accepts                the widths the kernel takes
  r_biased_attention_trainable  the differentiable form (port of the JAX
                                package's custom-VJP function): forward the
                                wrapper above, backward a recompute through
                                the plain version, as its _rba_bwd
                                recomputes through the XLA reference

out = softmax(q (k + r W_kr)^T / sqrt(d)) (v + r W_vr) per head, over the
keys the mask allows; a query with no valid key gives 0. `drop` is an
optional per-head multiplier of the softmax weights (attention dropout, the
denominator left undropped); the caller draws it. Everything is fp32.
"""

from typing import Optional

import torch

from infgen_torch.ops.seed_kernel import _check


def r_biased_attention_reference(q, k, v, r, w_kr, w_vr, mask,
                                 num_heads: int, drop=None) -> torch.Tensor:
    """q [B, Q, HD]; k, v [B, K, HD]; r [B, Q, K, Dr]; w_kr, w_vr [Dr, HD];
    mask [B, Q, K] bool; drop [B, Q, K, H] or None. Returns [B, Q, HD]."""
    B, N, HD = q.shape
    K = k.shape[1]
    H = num_heads
    d = HD // H
    qh = q.reshape(B, N, H, d)
    kh = k.reshape(B, K, H, d)
    vh = v.reshape(B, K, H, d)
    kr = (r @ w_kr).reshape(B, N, K, H, d)
    vr = (r @ w_vr).reshape(B, N, K, H, d)
    sim = torch.einsum("bqhd,bkhd->bqkh", qh, kh)
    sim = sim + torch.einsum("bqhd,bqkhd->bqkh", qh, kr)
    sim = sim * (d ** -0.5)
    sim = torch.where(mask[..., None], sim, -torch.inf)
    p = torch.softmax(sim, dim=2)
    p = torch.where(mask.any(-1)[..., None, None], p, 0.0)
    p = torch.where(mask[..., None], p, 0.0)
    if drop is not None:
        p = p * drop
    out = torch.einsum("bqkh,bkhd->bqhd", p, vh)
    out = out + torch.einsum("bqkh,bqkhd->bqhd", p, vr)
    return out.reshape(B, N, HD)


# csrc/r_biased_attention.cu's block: query rows, threads, keys per tile,
# and its registers' limits on the widths
_ROWS, _THREADS, _KEY_TILE, _MAX_H = 1, 256, 32, 16
_SMEM_LIMIT = 232448   # bytes of shared memory a block may take (H100)


def _round4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(K: int, HD: int, Dr: int, H: int) -> int:
    """Shared memory of one block of the kernel (its rba_floats)."""
    Hp, G = _round4(H), (_THREADS // HD if _THREADS >= HD else 1)
    floats = (2 * _ROWS * HD + _ROWS * Dr * Hp + _ROWS * H * Dr
              + _round4(_ROWS * H) + 2 * _KEY_TILE * (Dr + 2 * HD)
              + _KEY_TILE * Hp
              + 2 * _MAX_H + G * _ROWS * HD + _ROWS * _round4(K)
              + _THREADS // 32 + 1)
    return 4 * floats


def kernel_accepts(K: int, HD: int, Dr: int, H: int) -> bool:
    """Whether the kernel takes these widths: H | HD, at most 16 heads, the
    per-head relation sums H x Dr within 2,048 and the value sums HD within
    512 (eight and two per thread), Dr and HD multiples of 4 (16-byte
    copies of relation, key and value rows), and its shared memory within a
    block's."""
    return (H > 0 and HD % H == 0 and H <= _MAX_H and H * Dr <= 8 * _THREADS
            and HD <= 2 * _THREADS and Dr % 4 == 0 and HD % 4 == 0
            and smem_bytes(K, HD, Dr, H) <= _SMEM_LIMIT)


def r_biased_attention(q, k, v, r, w_kr, w_vr, mask, num_heads: int,
                       drop=None) -> torch.Tensor:
    """The attention of r_biased_attention_reference, every tensor fp32 and
    contiguous, through the registered op `infgen::r_biased_attention`:
    CUDA tensors launch csrc/r_biased_attention.cu on the current stream
    (counted in `r_biased_attention.launches`; widths that kernel_accepts
    refuses raise); CPU tensors take the plain version."""
    dev = q.device
    B, Q, HD = q.shape
    K, Dr, H = k.shape[1], r.shape[-1], num_heads
    f32 = torch.float32
    if HD % H:
        raise ValueError("r_biased_attention: H*d not a multiple of heads")
    _check("q", q, f32, (B, Q, HD), dev)
    _check("k", k, f32, (B, K, HD), dev)
    _check("v", v, f32, (B, K, HD), dev)
    _check("r", r, f32, (B, Q, K, Dr), dev)
    _check("w_kr", w_kr, f32, (Dr, HD), dev)
    _check("w_vr", w_vr, f32, (Dr, HD), dev)
    _check("mask", mask, torch.bool, (B, Q, K), dev)
    if drop is not None:
        _check("drop", drop, f32, (B, Q, K, H), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"r_biased_attention: unsupported device {dev}")
    return torch.ops.infgen.r_biased_attention(q, k, v, r, w_kr, w_vr, mask,
                                               num_heads, drop)


@torch.library.custom_op("infgen::r_biased_attention", mutates_args=(),
                         device_types="cpu")
def _rba_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            r: torch.Tensor, w_kr: torch.Tensor, w_vr: torch.Tensor,
            mask: torch.Tensor, num_heads: int,
            drop: Optional[torch.Tensor]) -> torch.Tensor:
    return r_biased_attention_reference(q, k, v, r, w_kr, w_vr, mask,
                                        num_heads, drop).contiguous()


@_rba_op.register_fake
def _(q, k, v, r, w_kr, w_vr, mask, num_heads, drop):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@_rba_op.register_kernel("cuda")
def _(q, k, v, r, w_kr, w_vr, mask, num_heads, drop):
    dev = q.device
    B, Q, HD = q.shape
    K, Dr, H = k.shape[1], r.shape[-1], num_heads
    if not kernel_accepts(K, HD, Dr, H):
        raise ValueError(f"r_biased_attention: the kernel does not take K={K}"
                         f", HD={HD}, Dr={Dr}, {H} heads")

    from infgen_torch.ops.build import library
    lib = library()
    out = torch.empty((B, Q, HD), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.infgen_r_biased_attention(
        0, q.data_ptr(), k.data_ptr(), v.data_ptr(), r.data_ptr(),
        w_kr.data_ptr(), w_vr.data_ptr(), mask.data_ptr(),
        0 if drop is None else drop.data_ptr(), out.data_ptr(),
        B, Q, K, HD, Dr, H, stream)
    if err != 0:
        raise RuntimeError(f"r_biased_attention kernel launch failed: "
                           f"cudaError {err}")
    r_biased_attention.launches += 1
    return out


r_biased_attention.launches = 0


class _RBATrainable(torch.autograd.Function):
    """Forward: r_biased_attention (the kernel on CUDA tensors), keeping
    only the raw inputs, as _rba_fwd does. Backward: autograd through
    r_biased_attention_reference on those inputs, as _rba_bwd takes
    jax.vjp of the XLA reference; the mask and the dropout multiplier get
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, r, w_kr, w_vr, mask, num_heads, drop):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, r, w_kr, w_vr, mask, drop)
        return r_biased_attention(q, k, v, r, w_kr, w_vr, mask, num_heads,
                                  drop)

    @staticmethod
    def backward(ctx, g):
        q, k, v, r, w_kr, w_vr, mask, drop = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in
                      (q, k, v, r, w_kr, w_vr)]
            out = r_biased_attention_reference(*leaves, mask, ctx.num_heads,
                                               drop)
            grads = torch.autograd.grad(out, leaves, g)
        r_biased_attention_trainable.backward_calls += 1
        return (*grads, None, None, None)


def r_biased_attention_trainable(q, k, v, r, w_kr, w_vr, mask,
                                 num_heads: int, drop=None) -> torch.Tensor:
    """r_biased_attention with gradients for q, k, v, r, w_kr and w_vr.

    The JAX package has no backward kernel for this function: its VJP is
    XLA code outside any Pallas kernel. The backward here is its
    counterpart, a recompute through the plain version under autograd
    (counted in `r_biased_attention_trainable.backward_calls`); it holds
    the [B, Q, K, HD] relation projections for the length of one backward
    call. The forward launches the kernel, counted in
    `r_biased_attention.launches`."""
    return _RBATrainable.apply(q, k, v, r, w_kr, w_vr, mask, num_heads,
                               drop)


r_biased_attention_trainable.backward_calls = 0
