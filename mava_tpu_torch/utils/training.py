"""Optimizer and schedules (port of `mava_tpu/utils/training.py:13-75`).

`ClippedAdam` is optax's `chain(clip_by_global_norm(max_norm), adam(lr,
eps=1e-5))` step for step: clip by the global norm with optax's rule (no 1e-6
added to the norm, unlike `torch.nn.utils.clip_grad_norm_`), Adam moments with
bias correction, eps outside the sqrt, then the (scheduled) learning rate.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, Union

import torch


def make_learning_rate_schedule(init_lr: float, config) -> Callable[[int], float]:
    """Linear decay to zero over every minibatch update of the run (clamped at 0)."""
    total_updates = (
        config.system.ppo_epochs * config.system.num_minibatches * config.system.num_updates
    )

    def linear_schedule(count: int) -> float:
        return init_lr * max(0.0, 1.0 - count / total_updates)

    return linear_schedule


def make_learning_rate(init_lr: float, config) -> Union[float, Callable[[int], float]]:
    if config.system.get("decay_learning_rates", False):
        return make_learning_rate_schedule(init_lr, config)
    return init_lr


class ClippedAdam:
    """Global-norm clip then Adam, updating `params` in place.

    `count` is the number of updates applied so far (optax's Adam `count`).
    """

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        lr: Union[float, Callable[[int], float]],
        max_grad_norm: float,
        eps: float = 1e-5,
        b1: float = 0.9,
        b2: float = 0.999,
    ):
        self.params = list(params)
        self.lr = lr
        self.max_grad_norm = max_grad_norm
        self.eps, self.b1, self.b2 = eps, b1, b2
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.max_grad_norm
        grads = [torch.where(keep, g, (g / g_norm) * self.max_grad_norm) for g in grads]

        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        dtype, dev = self.params[0].dtype, self.params[0].device
        bc1 = 1 - torch.tensor(self.b1, dtype=dtype, device=dev) ** self.count
        bc2 = 1 - torch.tensor(self.b2, dtype=dtype, device=dev) ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-lr * update)


def make_optimizer(params, lr, max_grad_norm: float) -> ClippedAdam:
    """Global-norm-clipped Adam with eps=1e-5 (the reference's optimizer)."""
    return ClippedAdam(params, lr, max_grad_norm, eps=1e-5)


def entropy_coefficient(config, actor_optimizer: ClippedAdam) -> float:
    """PPO entropy coefficient: constant `system.ent_coef`, or annealed linearly
    to `system.ent_coef_final` over every minibatch update, read from the actor
    optimizer's Adam count (reference :37-66)."""
    init = config.system.ent_coef
    final = config.system.get("ent_coef_final", None)
    if final is None:
        return init
    total = config.system.ppo_epochs * config.system.num_minibatches * config.system.num_updates
    frac = min(actor_optimizer.count / total, 1.0)
    return init + (final - init) * frac
