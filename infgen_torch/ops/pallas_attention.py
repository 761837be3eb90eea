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

out = softmax(q (k + r W_kr)^T / sqrt(d)) (v + r W_vr) per head, over the
keys the mask allows; a query with no valid key gives 0. `drop` is an
optional per-head multiplier of the softmax weights (attention dropout, the
denominator left undropped); the caller draws it. Everything is fp32. The
training slice wraps this forward with its backward kernel.
"""

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


def r_biased_attention(q, k, v, r, w_kr, w_vr, mask, num_heads: int,
                       drop=None) -> torch.Tensor:
    """The attention of r_biased_attention_reference, every tensor fp32 and
    contiguous. CUDA tensors launch csrc/r_biased_attention.cu on the
    current stream (counted in `r_biased_attention.launches`; W_kr and W_vr
    must fit in a block's shared memory with the key tiles, or the launch
    is refused and this raises); CPU tensors take the plain version."""
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
    if dev.type == "cpu":
        return r_biased_attention_reference(q, k, v, r, w_kr, w_vr, mask,
                                            num_heads, drop)
    if dev.type != "cuda":
        raise ValueError(f"r_biased_attention: unsupported device {dev}")

    from infgen_torch.ops.build import library
    lib = library()
    out = torch.empty((B, Q, HD), dtype=f32, device=dev)
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
