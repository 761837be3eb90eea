"""Host-side matplotlib plots of rollouts, insertion grids, occupancy and
attention masks (the port's copy of infgen_tpu/utils/visualization.py).

Every function takes numpy arrays (move tensors with `.cpu().numpy()`)
and draws with matplotlib's Agg backend. The plotting functions swallow
their exceptions through `safe_run`, so that a failing plot never kills a
training or evaluation job; a caller that must plot checks first with
`require_matplotlib`, which raises when matplotlib is not installed.
"""

import functools
import os

import numpy as np

AGENT_COLORS = {0: "#4477AA", 1: "#EE6677", 2: "#228833", 3: "#BBBBBB"}
STATE_ALPHA = {0: 0.0, 1: 1.0, 2: 1.0, 3: 0.6}


def safe_run(func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        try:
            return func(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 - plotting must never crash jobs
            print(f"[visualization] {func.__name__} failed: {e}")
            return None
    return wrapper


def require_matplotlib():
    """Raise RuntimeError unless matplotlib can be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "plotting needs matplotlib, which is not installed here") from e


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def a2a_inference_masks(pos_a, state_a, slot_active, radius: float):
    """The agent-agent attention masks of a rollout's columns 2, middle
    and last, rebuilt from its per-column poses and states by the rule
    the rollout applies (both ends live, within `radius`, no self edge):
    {"a2a_col{c}": bool [A, A]}. pos_a [A, Tc, 2]; state_a [A, Tc];
    slot_active [A]."""
    pos_a, state_a = np.asarray(pos_a), np.asarray(state_a)
    active = np.asarray(slot_active)
    A, Tc = state_a.shape
    masks = {}
    for c in (2, Tc // 2, Tc - 1):
        live = (state_a[:, c] != 0) & active
        d2 = ((pos_a[:, c][:, None] - pos_a[:, c][None]) ** 2).sum(-1)
        masks[f"a2a_col{c}"] = ((d2 <= radius ** 2) & live[None]
                                & live[:, None] & ~np.eye(A, dtype=bool))
    return masks


@safe_run
def plot_scenario_rollout(scenario_id: str, map_xy, pred_traj, pred_head,
                          pred_state, types, av_index: int, save_path: str,
                          slot_active=None, step_stride: int = 10,
                          make_gif: bool = False):
    """Rollout overview: map + agent trajectories colored by type.

    pred_traj [A, T, 2]; pred_state [A, T]; map_xy [P, 2].
    Saves <save_path>/<scenario_id>_rollout.png (and optionally a gif).
    """
    plt = _mpl()
    os.makedirs(save_path, exist_ok=True)
    A, T, _ = pred_traj.shape
    active = slot_active if slot_active is not None else np.ones(A, bool)

    fig, ax = plt.subplots(figsize=(9, 9))
    ax.scatter(map_xy[:, 0], map_xy[:, 1], s=0.5, c="#CCCCCC", zorder=0)
    for a in range(A):
        if not active[a]:
            continue
        valid = (pred_state[a] == 1) | (pred_state[a] == 3)
        if not valid.any():
            continue
        xy = pred_traj[a][valid]
        c = AGENT_COLORS.get(int(types[a]), "#999999")
        lw = 2.5 if a == av_index else 1.0
        ax.plot(xy[:, 0], xy[:, 1], color=c, lw=lw, alpha=0.8, zorder=2)
        ax.scatter(xy[-1:, 0], xy[-1:, 1], color=c, s=16, zorder=3)
    ax.set_aspect("equal")
    ax.set_title(f"{scenario_id} rollout ({T} steps)")
    out = os.path.join(save_path, f"{scenario_id}_rollout.png")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)

    if make_gif:
        _rollout_gif(scenario_id, map_xy, pred_traj, pred_state, types,
                     av_index, save_path, active, step_stride)
    return out


@safe_run
def _rollout_gif(scenario_id, map_xy, pred_traj, pred_state, types, av_index,
                 save_path, active, step_stride):
    import matplotlib.animation as animation
    plt = _mpl()
    A, T, _ = pred_traj.shape
    fig, ax = plt.subplots(figsize=(7, 7))

    def draw(t):
        ax.clear()
        ax.scatter(map_xy[:, 0], map_xy[:, 1], s=0.5, c="#CCCCCC")
        for a in range(A):
            if not active[a] or pred_state[a, t] == 0:
                continue
            c = AGENT_COLORS.get(int(types[a]), "#999999")
            ax.scatter(pred_traj[a, t, 0], pred_traj[a, t, 1], color=c,
                       s=40 if a == av_index else 16)
        ax.set_aspect("equal")
        ax.set_title(f"{scenario_id} t={t}")

    anim = animation.FuncAnimation(fig, draw, frames=range(0, T, step_stride))
    out = os.path.join(save_path, f"{scenario_id}_rollout.gif")
    anim.save(out, writer="pillow", fps=5)
    plt.close(fig)
    return out


@safe_run
def plot_insert_grid(scenario_id: str, prob_square, num_grid: int,
                     save_path: str, indices=None, prefix: str = ""):
    """Insertion-probability heatmap on the full square grid.

    prob_square [T, num_grid**2] (use AttrTokenizer.pad_square first).
    """
    plt = _mpl()
    os.makedirs(save_path, exist_ok=True)
    T = prob_square.shape[0]
    cols = min(T, 6)
    rows = (T + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.2 * rows),
                             squeeze=False)
    for t in range(T):
        ax = axes[t // cols][t % cols]
        ax.imshow(prob_square[t].reshape(num_grid, num_grid), cmap="viridis")
        if indices is not None and indices[t] >= 0:
            iy, ix = divmod(int(indices[t]), num_grid)
            ax.scatter([ix], [iy], c="red", s=10)
        ax.axis("off")
    for t in range(T, rows * cols):
        axes[t // cols][t % cols].axis("off")
    out = os.path.join(save_path, f"{prefix}{scenario_id}_insert_grid.png")
    fig.savefig(out, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out


@safe_run
def plot_occ_grid(scenario_id: str, occ_square, num_grid: int, save_path: str,
                  gt_occ_square=None, mode: str = "agent", prefix: str = ""):
    """Occupancy-grid prediction vs GT panels."""
    plt = _mpl()
    os.makedirs(save_path, exist_ok=True)
    T = occ_square.shape[0]
    step = max(T // 6, 1)
    ts = list(range(0, T, step))[:6]
    nrows = 2 if gt_occ_square is not None else 1
    fig, axes = plt.subplots(nrows, len(ts),
                             figsize=(2.2 * len(ts), 2.2 * nrows),
                             squeeze=False)
    for j, t in enumerate(ts):
        axes[0][j].imshow(occ_square[t].reshape(num_grid, num_grid),
                          cmap="magma")
        axes[0][j].axis("off")
        axes[0][j].set_title(f"t={t}", fontsize=7)
        if gt_occ_square is not None:
            axes[1][j].imshow(gt_occ_square[t].reshape(num_grid, num_grid),
                              cmap="magma")
            axes[1][j].axis("off")
    out = os.path.join(save_path, f"{prefix}{scenario_id}_occ_{mode}.png")
    fig.savefig(out, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out


@safe_run
def plot_prob_seed(scenario_id: str, probs, save_path: str, prefix: str = ""):
    """Seed insert-probability timeline. probs [T, insert_limit+1]."""
    plt = _mpl()
    os.makedirs(save_path, exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 3))
    im = ax.imshow(np.asarray(probs).T, aspect="auto", cmap="viridis",
                   vmin=0, vmax=1)
    ax.set_xlabel("rollout step")
    ax.set_ylabel("insert slot")
    fig.colorbar(im, ax=ax)
    out = os.path.join(save_path, f"{prefix}{scenario_id}_prob_seed.png")
    fig.savefig(out, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out


@safe_run
def plot_attention_masks(scenario_id: str, masks, save_path: str,
                         prefix: str = "", max_steps: int = 4):
    """Edge-map debug plots as dense masks: each attention mask renders as
    a heatmap (queries x keys), per step for stepwise masks. `masks`: dict
    name -> bool array [Q, K] or [T, Q, K]. Saves
    <save_path>/<prefix><scenario_id>_<name>_edge_map.png each; returns
    their paths."""
    plt = _mpl()
    os.makedirs(save_path, exist_ok=True)
    paths = []
    for name, m in masks.items():
        m = np.asarray(m)
        if m.ndim == 2:
            m = m[None]
        steps = np.linspace(0, m.shape[0] - 1,
                            min(max_steps, m.shape[0])).astype(int)
        fig, axes = plt.subplots(1, len(steps),
                                 figsize=(3 * len(steps), 3), squeeze=False)
        for ax, t in zip(axes[0], steps):
            ax.imshow(m[t], cmap="Blues", aspect="auto",
                      interpolation="nearest")
            ax.set_title(f"{name} t={t}", fontsize=8)
            ax.set_xlabel("key")
            ax.set_ylabel("query")
        fig.tight_layout()
        paths.append(os.path.join(
            save_path, f"{prefix}{scenario_id}_{name}_edge_map.png"))
        fig.savefig(paths[-1], dpi=100)
        plt.close(fig)
    return paths
