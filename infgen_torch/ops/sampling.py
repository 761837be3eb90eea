"""Top-k multinomial sampling (port of infgen_tpu/ops/sampling.py's
`sample_from_topk`, the only sampler the rollout uses).

`torch.Generator`s replace `jax.random` keys: the two give different draws
from one seed, so sampled rollouts agree with JAX only in distribution. At
k = 1 the draw is the argmax (lowest index among ties, like `lax.top_k`).
"""

import torch


def topk_stable(x, k: int):
    """(values, indices) of the k largest along the last axis, ties lower
    index first (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sample_from_topk(generator, probs, k: int):
    """Top-k, then a multinomial draw over the k renormalised probabilities.

    probs [..., V] (need not be normalised). Returns indices [...] int64.
    `generator` may be a list of generators, one per lane: probs is then
    [B, ..., V] and lane b draws from generator b exactly what a call with
    probs[b] and that generator alone draws (JAX's per-lane keys under
    vmap). At k = 1 nothing is drawn.
    """
    topk_p, topk_idx = topk_stable(probs, k)
    if k == 1:
        return topk_idx[..., 0]
    if isinstance(generator, (list, tuple)):
        draws = [_draw(g, p, i) for g, p, i
                 in zip(generator, topk_p, topk_idx)]
        # one lane: a view, with no copy launched
        return draws[0][None] if len(draws) == 1 else torch.stack(draws)
    return _draw(generator, topk_p, topk_idx)


def _draw(generator, topk_p, topk_idx):
    k = topk_p.shape[-1]
    flat = torch.clamp(topk_p, min=1e-30).reshape(-1, k)
    choice = torch.multinomial(flat, 1, generator=generator)
    choice = choice.reshape(*topk_p.shape[:-1], 1)
    return torch.gather(topk_idx, -1, choice)[..., 0]
