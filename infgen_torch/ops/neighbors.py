"""Fixed-k neighbour selection (port of infgen_tpu/ops/neighbors.py).

`jax.lax.top_k` puts the lower index first among equal values; `torch.topk`
promises no order for ties. Masked keys all share one fill value, so ties are
common: a stable descending sort keeps the JAX order.

Every function takes leading batch dims (the rollout's lane axis: one
scenario per lane); `gather_rows` reads the selected rows lane by lane.
"""

import torch


def topk_neighbors(query_pos, key_pos, k: int, radius: float,
                   query_mask=None, key_mask=None, exclude_self: bool = False):
    """k nearest keys within `radius` of each query.

    query_pos [..., Q, 2]; key_pos [..., K, 2]. Returns (indices [..., Q, k]
    int64, valid [..., Q, k] bool); ties keep the lower key index first.
    """
    d2 = ((query_pos[..., :, None, :] - key_pos[..., None, :, :]) ** 2).sum(-1)
    k = min(k, d2.shape[-1])
    big = torch.inf
    if key_mask is not None:
        d2 = torch.where(key_mask[..., None, :], d2, big)
    if exclude_self:
        Q, K = d2.shape[-2], d2.shape[-1]
        eye = torch.eye(Q, K, dtype=torch.bool, device=d2.device)
        d2 = torch.where(eye, big, d2)
    neg, idx = torch.sort(-d2, dim=-1, descending=True, stable=True)
    dist2 = -neg[..., :k]
    idx = idx[..., :k]
    valid = dist2 <= radius * radius
    if query_mask is not None:
        valid = valid & query_mask[..., None]
    return idx, valid


def pairwise_radius_mask(query_pos, key_pos, radius: float,
                         query_mask=None, key_mask=None,
                         exclude_self: bool = False):
    """Dense [..., Q, K] bool mask: key within `radius` of query."""
    d2 = ((query_pos[..., :, None, :] - key_pos[..., None, :, :]) ** 2).sum(-1)
    mask = d2 <= radius * radius
    if exclude_self:
        Q, K = mask.shape[-2], mask.shape[-1]
        mask = mask & ~torch.eye(Q, K, dtype=torch.bool, device=mask.device)
    if key_mask is not None:
        mask = mask & key_mask[..., None, :]
    if query_mask is not None:
        mask = mask & query_mask[..., :, None]
    return mask


_ARANGE = {}


def arange_on(n: int, device):
    """torch.arange(n) on `device`, made once and kept: the lane index and
    the one-hot writes' positions, read on every call without a launch of
    their own. Callers must not write to it. While a program is traced
    (torch.export) a fresh one is made and none is kept."""
    key = (n, torch.device(device))
    out = _ARANGE.get(key)
    if out is None:
        out = torch.arange(n, device=device)
        if not torch.compiler.is_compiling():
            _ARANGE[key] = out
    return out


def gather_rows(x, idx, batch_dims: int = 0):
    """Rows of `x` at `idx`, within each of the leading `batch_dims` dims:
    x [*batch, N, ...], idx [*batch, ...] int, every index in [0, N) ->
    [*batch, *idx_rest, ...] (x[idx] when batch_dims = 0). One gather on
    the device over an expanded (not copied) index, no host read: advanced
    indexing with a lane index beside `idx` would make both index tensors
    contiguous on a CUDA device, a copy each."""
    if batch_dims == 0:
        return x[idx]
    lead, rest = x.shape[:batch_dims], x.shape[batch_dims + 1:]
    xf = x.reshape(-1, *x.shape[batch_dims:])
    idf = idx.reshape(xf.shape[0], -1).long()
    out = torch.gather(xf, 1, idf.reshape(*idf.shape, *[1] * len(rest))
                       .expand(*idf.shape, *rest))
    return out.reshape(*lead, *idx.shape[batch_dims:], *rest)
