"""Optimizer, schedules and the off-policy helpers (port of
`mava_tpu/utils/training.py:13-170, 166-214`, of optax's target updates and of
`mava_tpu/utils/jax_utils.py`'s `select_along_last` and `switch_leading_axes`).

`ClippedAdam` is optax's `chain(clip_by_global_norm(max_norm), adam(lr,
eps=1e-5))` step for step: clip by the global norm with optax's rule (no 1e-6
added to the norm, unlike `torch.nn.utils.clip_grad_norm_`), Adam moments with
bias correction, eps outside the sqrt, then the (scheduled) learning rate.

`SweptClippedAdam` is the same step over parameters stacked on a leading axis
of S entries, each entry an optimizer of its own with its peak learning rate
held in the optimizer's state (the reference's `scale_by_swept_lr`,
`make_swept_optimizer`, `set_peak_lr` and `make_swept_adam`,
`utils/training.py:90-163`, under `jax.vmap`): what the seed, sweep and PBT
programs of `advanced_usage/` step.

A step reads nothing from the host, so that it can be captured in a CUDA graph
(the SAC train phase, the rec-IQL and PPO updates): the count is also kept on
the parameters' device (`device_count`, float64 and exact), which the step
advances in place, beside the host `count` that checkpoints read. The bias
corrections, a decayed learning rate and the PPO entropy coefficient are
formed from the device count, as optax forms them from its count in the
reference; each schedule also takes a host count, and the two forms are
bitwise equal at every count.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils import _pytree as pytree


Count = Union[int, torch.Tensor]


def _minibatch_updates(config) -> int:
    """Every minibatch update of the run: what the PPO schedules run over."""
    return config.system.ppo_epochs * config.system.num_minibatches * config.system.num_updates


def _fraction(count: Count, total: int) -> Count:
    """count / total in float64. A device count is divided by a tensor: CUDA
    divides by a host scalar as a product with its reciprocal, which is not
    always the quotient."""
    if isinstance(count, torch.Tensor):
        return count / torch.full_like(count, total)
    return count / total


def decay_fraction(count: Count, total: int) -> Count:
    """1 - count / total clamped at 0, in float64: a float of a host count, a
    tensor of a float64 device count."""
    if isinstance(count, torch.Tensor):
        return torch.clamp(1.0 - _fraction(count, total), min=0.0)
    return max(0.0, 1.0 - _fraction(count, total))


def make_learning_rate_schedule(init_lr: float, config) -> Callable[[Count], Count]:
    """Linear decay to zero over every minibatch update of the run (clamped at
    0), of a host count or of a device count (`decay_fraction`)."""
    total_updates = _minibatch_updates(config)

    def linear_schedule(count: Count) -> Count:
        return init_lr * decay_fraction(count, total_updates)

    return linear_schedule


def make_learning_rate(init_lr: float, config) -> Union[float, Callable[[Count], Count]]:
    if config.system.get("decay_learning_rates", False):
        return make_learning_rate_schedule(init_lr, config)
    return init_lr


class ClippedAdam:
    """Global-norm clip then Adam, updating `params` in place.

    `count` is the number of updates applied so far (optax's Adam `count`), a
    host int; `device_count` holds the same number on the parameters' device
    (float64, exact), and is what the bias corrections are formed from.
    Setting `count` sets both; a step advances both.
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
        dtype, dev = self.params[0].dtype, self.params[0].device
        betas = torch.tensor([b1, b2], dtype=dtype, device=dev)
        # b ** n as `tensor ** int` forms it: in float64, rounded to the
        # parameters' dtype, but b * b * b at n = 3.
        self._betas = betas.double()
        self._betas_cubed = betas * betas * betas
        self.device_count = torch.zeros((), dtype=torch.float64, device=dev)
        self.count = 0

    @property
    def count(self) -> int:
        return self._count

    @count.setter
    def count(self, value: int) -> None:
        self._count = int(value)
        self.device_count.fill_(self._count)

    def _advance(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Both counts one on; the bias corrections (1 - b1^n, 1 - b2^n) of the
        new count n, formed on the device."""
        self._count += 1
        self.device_count.add_(1)
        powers = torch.pow(self._betas, self.device_count).to(self._betas_cubed.dtype)
        powers = torch.where(self.device_count == 3, self._betas_cubed, powers)
        bias = 1 - powers
        return bias[0], bias[1]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.max_grad_norm
        grads = [torch.where(keep, g, (g / g_norm) * self.max_grad_norm) for g in grads]

        # A scheduled rate of the count before this step, a float64 tensor
        # that the update rounds to the parameters' dtype.
        lr = self.lr(self.device_count) if callable(self.lr) else self.lr
        bc1, bc2 = self._advance()
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-lr * update)

    def state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a step reads or writes in place: parameters, moments,
        counts and constants."""
        return [*self.params, *self.mu, *self.nu, self.device_count, self._betas,
                self._betas_cubed]


def make_optimizer(params, lr, max_grad_norm: float) -> ClippedAdam:
    """Global-norm-clipped Adam with eps=1e-5 (the reference's optimizer)."""
    return ClippedAdam(params, lr, max_grad_norm, eps=1e-5)


def _per_entry(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(S,) -> (S, 1, ..., 1), to broadcast over an entry of `like`."""
    return x.reshape(-1, *([1] * (like.dim() - 1)))


class SweptClippedAdam(ClippedAdam):
    """`ClippedAdam` over parameters stacked on a leading axis of S entries, each
    entry stepped as `ClippedAdam` would step it alone: clipped by its own global
    norm (a norm over the whole stack would mix the entries), its own Adam
    moments, and its own learning rate, `peak_lr[s]` (a float64 tensor of the
    state, set with `set_peak_lr`) decayed as `make_learning_rate_schedule`
    decays it when `decay_updates` is given.

    `count` is one for the stack: every entry takes every step. The learning
    rate of an entry is formed as the stock schedule forms it (in float64, then
    taken to float32 where it multiplies the update), so that entry s is
    bitwise the stock optimizer at `peak_lr[s]` wherever its squared norm sums
    in the same order (one CPU thread); elsewhere the two differ by rounding.
    """

    def __init__(self, params: Iterable[torch.Tensor], peak_lr, max_grad_norm: float,
                 decay_updates: Optional[int] = None, eps: float = 1e-5,
                 b1: float = 0.9, b2: float = 0.999):
        super().__init__(params, 0.0, max_grad_norm, eps, b1, b2)
        self.decay_updates = decay_updates
        set_peak_lr(self, peak_lr)

    @property
    def entries(self) -> int:
        return self.params[0].shape[0]

    def learning_rates(self) -> torch.Tensor:
        """(S,) float32: each entry's learning rate for the next step."""
        frac = 1.0
        if self.decay_updates is not None:
            frac = decay_fraction(self.device_count, self.decay_updates)
        return (self.peak_lr * frac).to(self.params[0].dtype)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        g_norm = torch.sqrt(sum(torch.sum(g * g, dim=tuple(range(1, g.dim()))) for g in grads))
        keep = g_norm < self.max_grad_norm
        grads = [
            torch.where(_per_entry(keep, g), g, (g / _per_entry(g_norm, g)) * self.max_grad_norm)
            for g in grads
        ]

        lr = self.learning_rates()
        bc1, bc2 = self._advance()
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-_per_entry(lr, p) * update)

    def state_tensors(self) -> List[torch.Tensor]:
        return [*super().state_tensors(), self.peak_lr]


def set_peak_lr(optimizer: SweptClippedAdam, peak_lr) -> SweptClippedAdam:
    """Write each entry's peak learning rate into the optimizer's state: a float
    for every entry, or one value an entry (reference `set_peak_lr`)."""
    lrs = torch.as_tensor(peak_lr, dtype=torch.float64, device=optimizer.params[0].device)
    optimizer.peak_lr = lrs.expand(optimizer.entries).clone()
    return optimizer


def make_swept_optimizer(params, config, max_grad_norm: float, peak_lr) -> SweptClippedAdam:
    """`make_optimizer` over stacked parameters with the learning rate in the
    optimizer's state: decayed over every minibatch update of the run with
    `system.decay_learning_rates`, as the stock schedule (reference
    `make_swept_optimizer`, :123-141)."""
    decay = None
    if config.system.get("decay_learning_rates", False):
        decay = _minibatch_updates(config)
    return SweptClippedAdam(params, peak_lr, max_grad_norm, decay, eps=1e-5)


def make_swept_adam(params, lr, max_grad_norm: float, eps: float = 1e-8) -> SweptClippedAdam:
    """Clip-then-Adam over stacked parameters at a constant learning rate a
    entry (a float for every entry, or one an entry) held in the optimizer's
    state: the off-policy systems' stock optimizer, each entry clipped by its
    own global norm over `params` (reference `make_swept_adam`, :147-163).
    SAC keeps optax's eps 1e-8, rec-IQL passes 1e-5."""
    return SweptClippedAdam(params, lr, max_grad_norm, decay_updates=None, eps=eps)


def entropy_coefficient(config, actor_optimizer: ClippedAdam) -> Union[float, torch.Tensor]:
    """PPO entropy coefficient: constant `system.ent_coef`, or annealed linearly
    to `system.ent_coef_final` over every minibatch update, formed from the
    actor optimizer's device count (reference :37-66) as a float32 tensor, so
    that an update reads no host count (`entropy_schedule`)."""
    if config.system.get("ent_coef_final", None) is None:
        return config.system.ent_coef
    return entropy_schedule(config, actor_optimizer.device_count).to(torch.float32)


def entropy_schedule(config, count: Count) -> Count:
    """The annealed entropy coefficient in float64 at a host count (a float)
    or a float64 device count (a tensor)."""
    init, final = config.system.ent_coef, config.system.ent_coef_final
    total = _minibatch_updates(config)
    if isinstance(count, torch.Tensor):
        frac = torch.clamp(_fraction(count, total), max=1.0)
    else:
        frac = min(_fraction(count, total), 1.0)
    return init + (final - init) * frac


def epoch_permutations(epochs: int, n: int, generator: torch.Generator,
                       device: torch.device) -> torch.Tensor:
    """(epochs, n): one uniform permutation of n per epoch, the PPO systems'
    minibatch shuffles (the reference argsorts random bits, :262-270)."""
    return torch.stack([torch.randperm(n, generator=generator, device=device)
                        for _ in range(epochs)])


def select_along_last(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values[..., index] over the last axis; out-of-range indices clamp, as the
    reference's one-hot select does."""
    index = index.long().clamp(0, values.shape[-1] - 1)
    return torch.gather(values, -1, index[..., None])[..., 0]


def switch_leading_axes(tree: Any) -> Any:
    """Swap the first two axes of every leaf ((B, T, ...) <-> (T, B, ...))."""
    return pytree.tree_map(lambda x: x.swapaxes(0, 1), tree)


@torch.no_grad()
def soft_update(target: torch.nn.Module, online: torch.nn.Module, tau: float) -> None:
    """optax's `incremental_update`: target <- tau * online + (1 - tau) * target,
    in place."""
    for t, o in zip(target.parameters(), online.parameters()):
        t.copy_(tau * o + (1.0 - tau) * t)


@torch.no_grad()
def replace_where(target: torch.nn.Module, online: torch.nn.Module, flag: torch.Tensor) -> None:
    """optax's periodic target update with its test (`steps % update_period == 0`)
    made beforehand, as a bool tensor `flag`: target <- online where `flag`,
    else kept; in place, no host read."""
    for t, o in zip(target.parameters(), online.parameters()):
        t.copy_(torch.where(flag, o, t))


# Loss-info keys that carry mean Q-value estimates across the off-policy
# systems (SAC: q{1,2}_a_vals, rec-IQL: mean_q / mean_target).
_Q_MAGNITUDE_KEYS = ("q1_a_vals", "q2_a_vals", "mean_q", "mean_target")


def warn_q_divergence(
    loss_info: Dict[str, Any], bound: float, system_name: str = "off-policy system"
) -> bool:
    """Warns when the largest |mean Q| of the logged losses exceeds `bound`
    (`system.q_divergence_warn_bound`): a bootstrapped Q-learner can diverge
    while training appears to succeed. NaN counts as worse than any finite
    value. Returns whether it warned (reference `utils/training.py:172-214`)."""
    worst_key, worst = None, 0.0
    for key in _Q_MAGNITUDE_KEYS:
        if key in loss_info:
            values = torch.as_tensor(loss_info[key]).detach()
            mag = float(values.abs().max())
            if mag != mag:  # NaN: the end state of the divergence this guards
                mag = float("inf")
            if mag > worst:
                worst_key, worst = key, mag
    if worst_key is not None and worst > bound:
        warnings.warn(
            f"{system_name}: |{worst_key}| reached {worst:.3g} "
            f"(> system.q_divergence_warn_bound={bound:g}) — the Q estimates "
            "are likely diverging. For reward-dense tasks lower the reward "
            "scale or reduce system.epochs.",
            stacklevel=2,
        )
        return True
    return False
