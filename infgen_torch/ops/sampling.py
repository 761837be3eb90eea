"""On-device sampling (port of infgen_tpu/ops/sampling.py): the top-k
draw of the rollout (`sample_from_topk`, `topk_inverse_cdf`, and the
uniform variates they take, `draw_uniforms` / `step_variates`) and the
CatK-derived guided samplers (`sample_next_token_traj`,
`sample_next_gmm_traj`; reference scripts/traj_clustering.py:107-295),
which no rollout path calls.

The rollout's draws are uniform variates turned into top-k indices by
inverse CDF over the renormalised top-k probabilities: a traced program
takes the variates as tensor inputs (`torch.export` cannot take a
`torch.Generator` as one), and the eager rollout and the exported one
(rollout/export.py) draw them from each lane's generator in the same fixed
order and sample with the same routine. `torch.Generator`s replace
`jax.random` keys: the two give different draws from one seed, so sampled
results agree with JAX only in distribution. At k = 1 the draw is the
argmax (lowest index among ties, like `lax.top_k`) and nothing is drawn.
"""

import torch

from infgen_torch.utils.geometry import cal_polygon_contour, rot_mat_2d


def topk_stable(x, k: int):
    """(values, indices) of the k largest along the last axis, ties lower
    index first (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def draw_uniforms(generators, shape, device, live=None):
    """Uniform variates in [0, 1) of `shape` per lane, [B, *shape]: lane b
    draws them from generators[b] alone, lanes in order. `live` (a host
    list of bools, or None for every lane) leaves the other lanes' rows
    zero and their generators untouched."""
    rows = [torch.rand(shape, generator=g, device=device)
            if live is None or live[b] else
            torch.zeros(shape, device=device)
            for b, g in enumerate(generators)]
    # one lane: a view, with no copy launched
    return rows[0][None] if len(rows) == 1 else torch.stack(rows)


def step_variates(generators, device, n_insert: int, n_cand: int,
                  n_motion: int):
    """The variates of one token step whose insertion loop runs a fixed
    number of evaluations: (insertion [B, n_insert, n_cand] or None,
    motion [B, n_motion] or None), each lane drawing first the insertion's
    (evaluation by evaluation) and then the motion's. A count of 0 draws
    nothing."""
    u_ins = draw_uniforms(generators, (n_insert, n_cand), device) \
        if n_insert else None
    u_mot = draw_uniforms(generators, (n_motion,), device) \
        if n_motion else None
    return u_ins, u_mot


def topk_inverse_cdf(topk_p, u):
    """Indices [..., n] into the last axis of topk_p [..., k] (probabilities,
    not necessarily normalised; each clamped to at least 1e-30): for each
    variate u [..., n] in [0, 1), the first index whose cumulative
    probability exceeds u times the total, a draw from the renormalised k
    probabilities."""
    p = torch.clamp(topk_p, min=1e-30)
    cdf = torch.cumsum(p, -1)
    idx = torch.searchsorted(cdf, (u * cdf[..., -1:]).contiguous(),
                             right=True)
    return torch.clamp(idx, max=p.shape[-1] - 1)


def sample_from_topk(u, probs, k: int):
    """Top-k, then a draw over the k renormalised probabilities
    (topk_inverse_cdf) with one variate u [...] per row of probs [..., V]
    (need not be normalised). Returns indices [...] int64. At k = 1 the
    argmax, and u is not read (None allowed)."""
    topk_p, topk_idx = topk_stable(probs, k)
    if k == 1:
        return topk_idx[..., 0]
    choice = topk_inverse_cdf(topk_p, u[..., None])
    return torch.gather(topk_idx, -1, choice)[..., 0]


def _categorical(generator, logits):
    """One draw per row of softmax(logits) [N, K] (jax.random.categorical's
    distribution); with K = 1, the only index, and nothing drawn."""
    if logits.shape[-1] == 1:
        return torch.zeros(logits.shape[0], dtype=torch.long,
                           device=logits.device)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _rows(x, idx):
    """x[a, idx[a, k]] over the leading axis, trailing dims kept."""
    a = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[a, idx]


def sample_next_token_traj(generator, token_traj, token_traj_all,
                           next_token_logits, pos_now, head_now, pos_next_gt,
                           head_next_gt, valid_next_gt, token_agent_shape,
                           criterium: str = "topk_prob", num_k: int = 5,
                           temp: float = 1.0):
    """Guided next-token sampling (CatK; scripts/traj_clustering.py:107-187).

    criterium:
      topk_prob                   - top-k + tempered categorical
      topk_prob_sampled_with_dist - top-k by prob, logits replaced by the
                                    negative contour distance to the GT
                                    where the GT is valid
      topk_dist_sampled_with_prob - top-k by GT distance, sampled by the
                                    model's prob
    token_traj [A, V, 4, 2] local contours; token_traj_all [A, V, 6, 4, 2].
    Returns (next_token_idx [A], next_token_traj_all [A, 6, 4, 2]).
    """
    logits = next_token_logits.detach()
    rot = rot_mat_2d(head_now)                                   # [A, 2, 2]

    def world_contours(local):
        w = torch.einsum("avcj,ajk->avck", local, rot)
        return w + pos_now[:, None, None, :]

    if criterium in ("topk_prob", "topk_prob_sampled_with_dist"):
        topk_logits, topk_idx = topk_stable(logits, num_k)
        if criterium == "topk_prob_sampled_with_dist":
            gt_contour = cal_polygon_contour(pos_next_gt, head_next_gt,
                                             token_agent_shape)[:, None]
            dist = torch.linalg.norm(
                world_contours(_rows(token_traj, topk_idx)) - gt_contour,
                dim=-1).mean(-1)                                 # [A, K]
            v = valid_next_gt[:, None]
            topk_logits = torch.where(v, 0.0, topk_logits) \
                - torch.where(v, dist, 0.0)
    elif criterium == "topk_dist_sampled_with_prob":
        gt_contour = cal_polygon_contour(pos_next_gt, head_next_gt,
                                         token_agent_shape)[:, None]
        dist = torch.linalg.norm(world_contours(token_traj) - gt_contour,
                                 dim=-1).mean(-1)                # [A, V]
        guided = torch.where(valid_next_gt[:, None], -dist, logits)
        _, topk_idx = topk_stable(guided, num_k)
        topk_logits = torch.gather(logits, 1, topk_idx)
    else:
        raise ValueError(f"Invalid criterium: {criterium}")

    choice = _categorical(generator, topk_logits / temp)
    next_token_idx = torch.gather(topk_idx, 1, choice[:, None])[:, 0]
    traj = _rows(token_traj_all, next_token_idx[:, None])[:, 0]
    return next_token_idx, traj


def sample_next_gmm_traj(generator, token_traj, token_traj_all, ego_index,
                         ego_next_logits, ego_next_poses, ego_next_cov,
                         pos_now, head_now, pos_next_gt, head_next_gt,
                         valid_next_gt, token_agent_shape, next_token_idx,
                         criterium: str = "topk_prob", num_k: int = 5,
                         temp_mode: float = 1.0, temp_cov: float = 1.0):
    """GMM-based ego next-pose sampling (scripts/traj_clustering.py:190-295).

    Samples the ego pose from a top-k Gaussian mixture over predicted
    (x, y, heading) modes, snaps it to the nearest vocab token by contour
    distance, and interpolates the 6-step contour trajectory linearly from
    the decoded token's start contour to the sampled one. Other rows pass
    through. As in the JAX package, the ego rows come as integer row
    positions `ego_index` [n_batch] (the reference's boolean ego_mask) and
    are scattered back.

    token_traj [A, V, 4, 2]; token_traj_all [A, V, 6, 4, 2];
    ego_next_logits [n_batch, K_gmm]; ego_next_poses [n_batch, K_gmm, 3] in
    the ego's local frame; ego_next_cov [2] (position / heading std, the
    Normal's scale over [x, y, cos h, sin h]). The component, then the
    normal noise, come from `generator`.
    Returns (next_token_idx [A], next_token_traj_all [A, 6, 4, 2]).
    """
    next_token_idx = torch.as_tensor(next_token_idx,
                                     device=token_traj_all.device)
    next_traj_all = _rows(token_traj_all, next_token_idx[:, None])[:, 0]
    if criterium not in ("topk_prob", "topk_prob_sampled_with_dist"):
        raise ValueError(f"Invalid criterium: {criterium}")
    ego_index = torch.as_tensor(ego_index, device=token_traj_all.device)

    topk_logits, topk_idx = topk_stable(ego_next_logits, num_k)
    ego_pose_topk = _rows(ego_next_poses, topk_idx)        # [n_batch, k, 3]
    pos_e, head_e = pos_now[ego_index], head_now[ego_index]
    shape_e = token_agent_shape[ego_index]                 # [n_batch, 2]
    if criterium == "topk_prob_sampled_with_dist":
        # global-frame contour distance of each mode to the GT box (:233-263)
        gt_contour = cal_polygon_contour(
            pos_next_gt[ego_index], head_next_gt[ego_index], shape_e)[:, None]
        rot = rot_mat_2d(head_e)                           # [n_batch, 2, 2]
        pos_g = torch.einsum("akj,ajl->akl", ego_pose_topk[..., :2], rot) \
            + pos_e[:, None]
        head_g = ego_pose_topk[..., 2] + head_e[:, None]
        mode_contour = cal_polygon_contour(pos_g, head_g, shape_e[:, None])
        dist = torch.linalg.norm(mode_contour - gt_contour, dim=-1).mean(-1)
        v = valid_next_gt[ego_index][:, None]
        topk_logits = torch.where(v, 0.0, topk_logits) \
            - torch.where(v, dist, 0.0)

    topk_logits = topk_logits / temp_mode
    # mixture over [x, y, cos h, sin h] with per-pair stds (:268-287)
    mean4 = torch.cat([ego_pose_topk[..., :2],
                       torch.cos(ego_pose_topk[..., 2:3]),
                       torch.sin(ego_pose_topk[..., 2:3])], dim=-1)
    scale4 = torch.repeat_interleave(torch.as_tensor(
        ego_next_cov, device=mean4.device) * temp_cov, 2)
    comp = _categorical(generator, topk_logits)            # [n_batch]
    mean_sel = _rows(mean4, comp[:, None])[:, 0]           # [n_batch, 4]
    noise = torch.randn(mean_sel.shape, generator=generator,
                        dtype=mean_sel.dtype, device=mean_sel.device)
    ego_sample = mean_sel + scale4 * noise

    # snap to the nearest vocab token by local contour distance (:289-296)
    sample_head = torch.atan2(ego_sample[:, 3], ego_sample[:, 2])
    sample_contour = cal_polygon_contour(ego_sample[:, :2], sample_head,
                                         shape_e)          # [n_batch, 4, 2]
    tok_dist = torch.linalg.norm(
        sample_contour[:, None] - token_traj[ego_index], dim=-1).mean(-1)
    next_token_idx = next_token_idx.clone()
    next_token_idx[ego_index] = torch.argmin(tok_dist, dim=-1).to(
        next_token_idx.dtype)

    # interpolate the 6-step contour trajectory from the decoded token's
    # start contour to the sampled contour (:298-306)
    n_step = token_traj_all.shape[2]
    start = next_traj_all[ego_index][:, 0]                 # [n_batch, 4, 2]
    frac = torch.arange(n_step, dtype=start.dtype,
                        device=start.device) / (n_step - 1)
    interp = start[:, None] + (sample_contour - start)[:, None] * \
        frac[None, :, None, None]
    next_traj_all = next_traj_all.clone()
    next_traj_all[ego_index] = interp
    return next_token_idx, next_traj_all
