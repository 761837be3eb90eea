"""Training step: the model, its tokenizers, optax's AdamW chain and the
warmup-cosine schedule on one device (port of
infgen_tpu/train/train_step.py).

The JAX step is a pure function of a TrainState that it donates. Here the
model's parameters and the optimizer's moments are updated in place, and
`Trainer.step` counts the calls, as `TrainState.step` does.

`OptaxAdamW` is optax's
  chain(clip_by_global_norm(grad_clip_norm), adamw(lr_schedule))
[wrapped in MultiSteps(every_k = accumulate_grad_batches) when k > 1],
op for op, because torch's own differ: clip_grad_norm_ scales by
max_norm / (norm + 1e-6); torch.optim.AdamW's default weight decay is
1e-2 (optax's 1e-4).
"""

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from infgen_torch.config import Config
from infgen_torch.data.features import build_model_inputs
from infgen_torch.data.scenario import lane_of
from infgen_torch.model.infgen import InfGenModel
from infgen_torch.model.layers import init_params
from infgen_torch.model.occ_decoder import OccDecoder, occ_decoder_loss
from infgen_torch.ops.precision import cast_params_for_compute
from infgen_torch.tokenizers.attr_tokenizer import AttrTokenizer
from infgen_torch.tokenizers.motion_tokenizer import MotionTokenizer
from infgen_torch.tokenizers.vocab import load_map_vocab
from infgen_torch.train.losses import compute_losses
from infgen_torch.utils.device import resolve_device


def lr_schedule(cfg: Config):
    """Linear warmup, then cosine to zero over total_steps; evaluated at
    the optimizer's update count before it increments."""
    def fn(step: int) -> float:
        warm = (step + 1) / max(1, cfg.warmup_steps)
        denom = max(1, cfg.total_steps - cfg.warmup_steps)
        cos = max(0.0, 0.5 * (1.0 + math.cos(
            math.pi * (step - cfg.warmup_steps) / denom)))
        return cfg.lr * (warm if step + 1 < cfg.warmup_steps else cos)
    return fn


# elements per partial norm of global_norm
NORM_CHUNK = 1 << 16


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), as
    the norm of the norms of NORM_CHUNK-element pieces: a CPU fp32 norm of
    one tensor of 38M elements (the occupancy decoder's point head) reads
    0.26% low, of 65,536 about 1e-7 (one multi-tensor kernel on a card
    either way)."""
    pieces = [p for t in tensors for p in t.float().reshape(-1).split(
        NORM_CHUNK)]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(pieces)))


class OptaxAdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(schedule)) with
    optax.adamw's defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
    weight_decay 1e-4 on every parameter), inside optax.MultiSteps' mean
    over `every_k` micro-batches when every_k > 1. Per parameter p with
    gradient g (a parameter without a gradient takes zeros, as JAX's
    gradient of an unused leaf is zero; weight decay still moves it):
      g  <- g                      if |G| < max_norm
            (g / |G|) * max_norm   otherwise   (|G| the global norm)
      mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu;  n <- n + 1
      u  <- (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps) + wd p
      p  <- p + (-lr(n - 1)) u
    one op at a time in the parameters' dtype, every scalar (and the clip's
    norm) cast to that dtype first, as optax computes on bf16 leaves: every
    product and sum rounds to bf16 under param_dtype bfloat16. The global
    norm is summed in fp32 (global_norm), where optax sums bf16 leaves'
    squares in bf16 (ROADMAP Queue 3).
    With every_k > 1 the gradients are accumulated as a running mean
    (acc += (g - acc) / (i + 1)) and the update above runs on every k-th
    call only; the other calls leave p unchanged."""

    def __init__(self, named_params, schedule, max_norm: float,
                 every_k: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.schedule, self.max_norm, self.every_k = schedule, max_norm, \
            every_k
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        (self.dtype,) = {p.dtype for p in self.params}
        self.reset()

    def _scalar(self, x: float) -> float:
        """`x` as optax applies a Python scalar to a leaf: in the leaf's
        dtype (a bf16 value under param_dtype bfloat16; fp32 leaves
        compute with it in fp32 either way)."""
        return float(torch.tensor(x, dtype=self.dtype))

    def reset(self):
        self.count = 0          # inner updates made
        self.mini_step = 0      # micro-batches accumulated
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params] \
            if self.every_k > 1 else None

    def grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> bool:
        """One optimizer call on `grads` (one per parameter). Returns
        whether the parameters were updated. Each line runs as one
        multi-tensor (`torch._foreach_*`) op over every parameter; the clip
        factor stays on the device (no host read)."""
        if self.every_k > 1:
            n = self.mini_step
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(n + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step = (n + 1) % self.every_k
            if self.mini_step != 0:
                return False
            grads = self.acc
        norm = global_norm(grads)
        keep = norm < self.max_norm
        clip = torch._foreach_div(grads, norm.to(self.dtype))
        torch._foreach_mul_(clip, self._scalar(self.max_norm))
        clip = [torch.where(keep, g, c) for g, c in zip(grads, clip)]
        lr = self.schedule(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, self._scalar(self.b1))
        torch._foreach_add_(self.mu, torch._foreach_mul(
            clip, self._scalar(1.0 - self.b1)))
        sq = torch._foreach_mul(clip, clip)
        torch._foreach_mul_(sq, self._scalar(1.0 - self.b2))
        torch._foreach_mul_(self.nu, self._scalar(self.b2))
        torch._foreach_add_(self.nu, sq)
        denom = torch._foreach_div(
            self.nu, self._scalar(1.0 - self.b2 ** self.count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self._scalar(self.eps))
        u = torch._foreach_div(self.mu,
                               self._scalar(1.0 - self.b1 ** self.count))
        torch._foreach_div_(u, denom)
        torch._foreach_add_(u, torch._foreach_mul(self.params,
                                                  self._scalar(self.wd)))
        torch._foreach_mul_(u, self._scalar(-lr))
        torch._foreach_add_(self.params, u)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        return True

    def state_dict(self) -> Dict:
        return dict(count=self.count, mini_step=self.mini_step,
                    mu=dict(zip(self.names, self.mu)),
                    nu=dict(zip(self.names, self.nu)),
                    acc=None if self.acc is None
                    else dict(zip(self.names, self.acc)))

    def load_state_dict(self, state: Dict):
        self.count, self.mini_step = state["count"], state["mini_step"]
        for key in ("mu", "nu", "acc"):
            mine = getattr(self, key)
            if mine is None or state[key] is None:
                continue
            for t, n in zip(mine, self.names):
                t.copy_(state[key][n])


class Trainer:
    """The model, tokenizers, optimizer and step of one device (the card
    unless `device` says "cpu"; without CUDA the default raises). The
    model is InfGenModel, or OccDecoder under `decoder_type: occ_decoder`;
    its parameters are stored in `param_dtype`.

    `loss_fn` is one scenario's training forward and losses; `batch_loss`
    their mean over a stacked batch (the JAX vmap's mean, here a loop);
    `train_step` one optimizer call on a batch, returning the batch's mean
    logs (tensors) with `grad_norm`, the global norm of its gradient before
    clipping; its phases are the profiler spans `train.forward`,
    `train.backward` and `train.optimizer` (trace_train.py)."""

    def __init__(self, cfg: Config, device=None):
        if cfg.mesh_shape.get("model", 1) > 1 or \
                cfg.mesh_shape.get("data", 0) > 1:
            raise NotImplementedError("data and tensor parallelism are not "
                                      "ported (ROADMAP Queue 1 item 3)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.attr = AttrTokenizer(cfg.grid_range, cfg.grid_interval,
                                  cfg.pl2seed_radius, cfg.angle_interval)
        self.motion_tok = MotionTokenizer()
        map_vocab = load_map_vocab()
        self.is_occ_decoder = cfg.decoder_type == "occ_decoder"
        if self.is_occ_decoder:
            model = OccDecoder(cfg, self.attr.grid_size)
        else:
            model = InfGenModel(cfg, self.attr.grid, self.attr.grid_size,
                                self.attr.angle_size)
        self.model = cast_params_for_compute(model, cfg.param_dtype).to(
            self.device)
        self.agent_vocab = {k: torch.as_tensor(v, device=self.device)
                            for k, v in self.motion_tok.vocab.items()}
        self.map_traj = torch.as_tensor(map_vocab["traj_src"],
                                        device=self.device)
        self.optimizer = OptaxAdamW(
            list(self.model.named_parameters()), lr_schedule(cfg),
            cfg.grad_clip_norm, cfg.accumulate_grad_batches)
        self.step = 0

    def init_state(self, generator: Optional[torch.Generator] = None):
        """Fresh weights (init_params from `generator`, default cfg.seed;
        rounded to `param_dtype` when it is not float32, as the JAX
        package casts its init) and a fresh optimizer state, whose moments
        take the parameters' dtype as optax's do."""
        generator = generator or torch.Generator().manual_seed(self.cfg.seed)
        init_params(self.model, generator)
        self.optimizer.reset()
        self.step = 0

    def loss_fn(self, scenario, generator=None, draws: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Loss and logs of one scenario (a Scenario of tensors on the
        trainer's device) in the model's current mode. `draws` may give the
        random inputs the JAX package draws from its key: `pt_uniform` [P]
        (the map-token mask), `hist_drop` [A, 10] and `sa_uniform` [A, T];
        for the occupancy decoder `sel_a` / `sel_p` (its drawn agent slots
        and map tokens); the rest come from `generator`."""
        draws = draws or {}
        inputs = build_model_inputs(self.cfg, self.motion_tok, self.attr,
                                    scenario, generator,
                                    pt_uniform=draws.get("pt_uniform"))
        if self.is_occ_decoder:
            pred = self.model(inputs, scenario.map.position,
                              scenario.map.orientation, generator,
                              sel_a=draws.get("sel_a"),
                              sel_p=draws.get("sel_p"))
            return occ_decoder_loss(pred)
        pred = self.model(inputs, scenario.map, self.agent_vocab,
                          self.map_traj, generator,
                          hist_drop=draws.get("hist_drop"),
                          sa_uniform=draws.get("sa_uniform"))
        return compute_losses(self.cfg, self.attr.grid_size, pred, inputs)

    def batch_loss(self, batch, generator=None, draws=None):
        """Mean loss and mean logs over a stacked batch (leading lane axis,
        data.scenario.stack_scenarios); draws: one dict per scenario or
        None."""
        n = int(batch.agents.valid.shape[0])
        losses, logs = [], []
        for i in range(n):
            loss, lg = self.loss_fn(lane_of(batch, i), generator,
                                    draws[i] if draws else None)
            losses.append(loss)
            logs.append(lg)
        mean = {k: torch.stack([lg[k] for lg in logs]).mean()
                for k in logs[0]}
        return torch.stack(losses).mean(), mean

    def train_step(self, batch, generator=None, draws=None
                   ) -> Dict[str, torch.Tensor]:
        """One step on `batch` in train mode: gradients of batch_loss, then
        OptaxAdamW (which with accumulate_grad_batches = k updates on every
        k-th call). Parameters update in place."""
        self.model.train()
        self.model.zero_grad(set_to_none=True)
        with record_function("train.forward"):
            loss, logs = self.batch_loss(batch, generator, draws)
        with record_function("train.backward"):
            loss.backward()
        with record_function("train.optimizer"):
            grads = self.optimizer.grads()
            logs["grad_norm"] = global_norm(grads).detach()
            self.optimizer.step(grads)
        self.step += 1
        return {k: v.detach() for k, v in logs.items()}
