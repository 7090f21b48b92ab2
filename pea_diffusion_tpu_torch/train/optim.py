"""The adapter's optimizer (port of ``pea_diffusion_tpu/train/optim.py``): the
optax chain ``clip_by_global_norm(1.0)`` then AdamW with the bias/norm
weight-decay exemption, at a learning rate of linear warmup then
polynomial, cosine, linear or constant decay.

Written as plain functions over ``{name: tensor}`` dicts so that each
rounding point is optax's, not ``torch.optim``'s:
- clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``, with
  no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
- the learning rate is read at the update's count, starting at 0, and Adam's
  bias correction at count + 1.
The state is a dict of tensors and ints, so ``torch.save`` stores it.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..configs.train import TrainConfig

Tensors = Dict[str, torch.Tensor]


def lr_at(cfg: TrainConfig, count: int) -> float:
    """The learning rate of update number `count` (0-based), as
    ``make_lr_schedule`` of the JAX package evaluates it."""
    warmup = cfg.warmup_steps if cfg.warmup_steps > 0 else int(
        cfg.warmup_ratio * cfg.total_steps)
    if count < warmup:
        return cfg.learning_rate * count / warmup
    count -= warmup
    decay_steps = max(int(cfg.total_steps * cfg.lr_decay_ratio) - warmup, 1)
    done = min(count, decay_steps) / decay_steps
    if cfg.scheduler_type == "polynomial":
        return (cfg.learning_rate - cfg.min_learning_rate) * (1 - done) + cfg.min_learning_rate
    if cfg.scheduler_type == "cosine":
        alpha = cfg.min_learning_rate / cfg.learning_rate
        return cfg.learning_rate * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * done)) + alpha)
    if cfg.scheduler_type == "linear":
        return cfg.learning_rate * (1 - done)
    if cfg.scheduler_type == "constant":
        return cfg.learning_rate
    raise ValueError(cfg.scheduler_type)


def decay_mask(module: nn.Module) -> Dict[str, bool]:
    """True where weight decay applies: not biases, not any parameter of a
    module whose name holds "norm", and only matrices (ndim >= 2), as the
    JAX package's ``_decay_mask``."""
    mask = {}
    for name, p in module.named_parameters():
        parts = name.split(".")
        mask[name] = not ("bias" in parts or any("norm" in s.lower() for s in parts[:-1])
                          or p.ndim < 2)
    return mask


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax.global_norm)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors.values()))


def clip_by_global_norm(grads: Tensors, max_norm: float) -> Tuple[Tensors, torch.Tensor]:
    """optax.clip_by_global_norm: unchanged below `max_norm`, else
    (g / norm) * max_norm. Returns the clipped grads and the pre-clip norm."""
    norm = global_norm(grads)
    if norm < max_norm:
        return dict(grads), norm
    return {k: (g / norm) * max_norm for k, g in grads.items()}, norm


def init_state(params: Tensors) -> dict:
    """Adam's moments at zero and the update count at 0."""
    return {"count": 0,
            "mu": {k: torch.zeros_like(p) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p) for k, p in params.items()}}


@torch.no_grad()
def apply_update(cfg: TrainConfig, params: Tensors, grads: Tensors, state: dict,
                 mask: Dict[str, bool]) -> torch.Tensor:
    """One step of the chain, in place on `params` and `state`. Returns the
    pre-clip global norm of `grads`."""
    grads, norm = clip_by_global_norm(grads, 1.0)
    count = state["count"]
    lr = lr_at(cfg, count)
    b1, b2 = cfg.adam_beta1, cfg.adam_beta2
    # bias corrections in fp32, as optax takes decay ** count
    c1, c2 = (1 - torch.tensor(b, dtype=torch.float32) ** (count + 1) for b in (b1, b2))
    for k, p in params.items():
        g, mu, nu = grads[k], state["mu"][k], state["nu"][k]
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * (g * g))
        update = (mu / c1) / (torch.sqrt(nu / c2) + cfg.adam_epsilon)
        if mask[k]:
            update = update + cfg.weight_decay * p
        p.add_(-lr * update)
    state["count"] = count + 1
    return norm
