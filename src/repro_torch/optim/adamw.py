"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule.

Port of ``repro.optim.adamw``, formula for formula. The optimizer state
mirrors the parameter tree; ``update`` writes the new parameters and
moments in place (the JAX package returns new arrays) and returns them, so
call sites read the same in both packages. Moments are stored in
``moment_dtype`` and updates computed in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.core.device import dtype_of


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # Moment storage dtype ("float32" | "bfloat16"); updates are float32.
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor     # () int32
    mu: Any
    nu: Any


def init(params, cfg: AdamWConfig = None) -> OptState:
    dt = dtype_of(cfg.moment_dtype) if cfg is not None else torch.float32
    device = tree_lib.leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    mu=tree_lib.map_tree(zeros, params),
                    nu=tree_lib.map_tree(zeros, params))


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine decay to ``min_lr_ratio * lr``."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_lib.leaves(tree)))


def _decayable(path) -> bool:
    """No decay on norms / scalars / 1-D gains: the last key of the path
    ending in ``_r``, holding ``norm`` or starting with ``ln`` (the port's
    ``ln1``, ``ln2``, ``ln_f``). ``embed``, ``head`` and the matmul weights
    decay, as in the JAX package."""
    for entry in reversed(path):
        if isinstance(entry, str):
            return not (entry.endswith("_r") or "norm" in entry or entry.startswith("ln"))
    return True


@torch.no_grad()
def update(cfg: AdamWConfig, params, grads, state: OptState
           ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.betas
    step = state.step + 1
    lr = schedule(cfg, step)
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())
    for (path, p), g, mu, nu in zip(tree_lib.leaves_with_paths(params),
                                    tree_lib.leaves(grads), tree_lib.leaves(state.mu),
                                    tree_lib.leaves(state.nu)):
        g = g.float() * clip
        m = b1 * mu.float() + (1 - b1) * g
        n = b2 * nu.float() + (1 - b2) * g * g
        step_dir = (m / bc1) / (torch.sqrt(n / bc2) + cfg.eps)
        if _decayable(path):
            step_dir = step_dir + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step_dir)
        mu.copy_(m)
        nu.copy_(n)
    return params, OptState(step=step, mu=state.mu, nu=state.nu), {"grad_norm": gnorm,
                                                                   "lr": lr}
