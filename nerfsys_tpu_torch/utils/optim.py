"""Optimizer with named per-group learning rates, optax's arithmetic.

Port of nerfsys_tpu/utils/optim.py (`OptimConfig` :21, `build_optimizer`
:72): a global-norm clip across ALL groups, then per group ('encoding',
'sigma', 'color', 'background') Adam, AdamW or SGD with its own learning
rate and an optional exponential decay lr_t = lr_0 * gamma^t. It is written
out rather than taken from `torch.optim`, whose conventions differ, so that
every step reproduces the reference's optax chain
`clip_by_global_norm -> multi_transform({group: chain(l2, adam(lr_t))})`:

  - clip: g if norm < max_norm, else g / norm * max_norm (no epsilon);
  - adam: b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
    corrected with the count after the increment; each group keeps its own
    count (optax's adam and schedule counts move together, so one serves);
  - the schedule is read at the count BEFORE the increment;
  - weight decay is L2 added to the gradient before the moments for adam
    and sgd, and decoupled (added to the Adam direction) for adamw.

Plain functions, no torch.optim: `build_optimizer(cfg, labels)` returns an
`Optimizer` with `init(params)` and `update(grads, state, params) ->
(updates, state)`; `apply_updates(params, updates)` adds them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from nerfsys_tpu_torch.utils.tree import tree_leaves, tree_map

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adam"  # adam | adamw | sgd
    lr: float = 1e-4  # base lr (used when a group lr is None)
    encoding_lr: Optional[float] = 1e-2
    sigma_lr: Optional[float] = 2e-3
    color_lr: Optional[float] = 2e-3
    bg_lr: Optional[float] = 1e-3
    weight_decay: float = 0.0
    momentum: float = 0.9  # sgd only
    grad_clip: Optional[float] = 1.0
    # exponential decay: lr -> lr / decay_factor over outer_steps
    use_scheduler: bool = True
    decay_factor: float = 10.0
    outer_steps: int = 20000

    def group_lrs(self) -> Dict[str, float]:
        pick = lambda v: self.lr if v is None else v  # noqa: E731
        return {"encoding": pick(self.encoding_lr),
                "sigma": pick(self.sigma_lr),
                "color": pick(self.color_lr),
                "background": pick(self.bg_lr)}

    def gamma(self) -> Optional[float]:
        """Per-step decay rate, or None for a constant lr."""
        if (not self.use_scheduler or self.outer_steps <= 0
                or self.decay_factor <= 1.0):
            return None
        return (1.0 / self.decay_factor) ** (1.0 / self.outer_steps)


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    cfg: OptimConfig
    labels: Any  # the params' nesting with a group name at every leaf

    def __post_init__(self):
        if self.cfg.optimizer.lower() not in ("adam", "adamw", "sgd"):
            raise ValueError(f"Unknown optimizer: {self.cfg.optimizer}")

    def init(self, params) -> Dict:
        """{'count': {group: int32}, 'mu', 'nu'} (adam, adamw) or
        {'count', 'trace'} (sgd), moments zero in the params' nesting."""
        dev = tree_leaves(params)[0].device
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        state = {"count": {g: torch.zeros((), dtype=torch.int32, device=dev)
                           for g in self.cfg.group_lrs()}}
        if self.cfg.optimizer.lower() == "sgd":
            state["trace"] = zeros()
        else:
            state["mu"], state["nu"] = zeros(), zeros()
        return state

    def _lr(self, lr0: float, count: torch.Tensor) -> torch.Tensor:
        gamma = self.cfg.gamma()
        if gamma is None:
            return _f32(lr0, count.device)
        decayed = _f32(lr0, count.device) * torch.pow(
            _f32(gamma, count.device), count.to(torch.float32))
        return torch.where(count <= 0, _f32(lr0, count.device), decayed)

    def update(self, grads, state: Dict, params) -> Tuple[Any, Dict]:
        cfg = self.cfg
        name = cfg.optimizer.lower()
        wd = cfg.weight_decay
        if cfg.grad_clip is not None and cfg.grad_clip > 0:
            norm = global_norm(grads)
            keep = norm < cfg.grad_clip
            grads = tree_map(
                lambda g: torch.where(keep, g, g / norm * cfg.grad_clip),
                grads)
        counts = state["count"]
        # per group: -lr at the old count, bias corrections at the new one
        step, bc1, bc2 = {}, {}, {}
        for grp, lr0 in cfg.group_lrs().items():
            c = counts[grp]
            step[grp] = -self._lr(lr0, c)
            n = (c + 1).to(torch.float32)
            bc1[grp] = 1 - torch.pow(_f32(B1, c.device), n)
            bc2[grp] = 1 - torch.pow(_f32(B2, c.device), n)
        new_count = {g: c + 1 for g, c in counts.items()}

        if name == "sgd":
            def one(g, p, tr, grp):
                if wd:
                    g = g + wd * p
                tr = g + cfg.momentum * tr
                return step[grp] * tr, tr

            out = tree_map(one, grads, params, state["trace"], self.labels)
            return (_part(out, 0, grads),
                    {"count": new_count, "trace": _part(out, 1, grads)})

        def one(g, p, mu, nu, grp):
            if wd and name == "adam":
                g = g + wd * p
            mu = (1 - B1) * g + B1 * mu
            nu = (1 - B2) * torch.square(g) + B2 * nu
            u = (mu / bc1[grp]) / (torch.sqrt(nu / bc2[grp]) + EPS)
            if wd and name == "adamw":
                u = u + wd * p
            return step[grp] * u, mu, nu

        out = tree_map(one, grads, params, state["mu"], state["nu"],
                       self.labels)
        return (_part(out, 0, grads),
                {"count": new_count, "mu": _part(out, 1, grads),
                 "nu": _part(out, 2, grads)})


def _part(tree_of_tuples, i: int, like):
    """Field i of the tuples at the leaves of `like`'s nesting."""
    return tree_map(lambda _, t: t[i], like, tree_of_tuples)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the sum of squares (optax's)."""
    return torch.sqrt(sum(torch.sum(torch.square(x))
                          for x in tree_leaves(tree)))


def build_optimizer(cfg: OptimConfig, labels) -> Optimizer:
    """The clip -> per-group optimizer + schedule of the reference, over the
    params' group labels (models.container.param_group_labels)."""
    return Optimizer(cfg, labels)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
