"""Action distributions (port of `mava_tpu/distributions.py`): the categorical
ones (:25-93, :182-212) and the tanh-squashed Normal of continuous actions
(:96-180).

Same surface as the reference: `sample`, `sample_from_noise`, `raw_params`,
`log_prob`, `entropy` and `mode` (and `TanhNormal.sample_and_log_prob`).
Randomness comes from an explicit `torch.Generator`, or is handed in as Gumbel
noise (categorical) or standard normals (tanh-Normal).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

_MASK_NEG = torch.finfo(torch.float32).min


def gumbel(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel noise, drawn as `jax.random.gumbel` draws it:
    -log(-log(U)) with U uniform on [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard normal noise: what `TanhNormal.sample_from_noise` takes."""
    return torch.randn(shape, generator=generator, device=device)


class Categorical:
    """Categorical over the last axis of `logits`."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    @property
    def num_categories(self) -> int:
        return self.logits.shape[-1]

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = gumbel(self.logits.shape, generator, self.logits.device)
        return self.sample_from_noise(noise)

    def sample_from_noise(self, gumbel_noise: torch.Tensor) -> torch.Tensor:
        """Gumbel-max sampling with pre-drawn noise: argmax(logits + g)."""
        return torch.argmax(self.logits + gumbel_noise, dim=-1)

    def raw_params(self) -> torch.Tensor:
        return self.logits

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        log_probs = torch.log_softmax(self.logits, dim=-1)
        # Out-of-range actions clamp, as the reference's one-hot select does (:63).
        value = value.long().clamp(0, self.num_categories - 1)
        return torch.gather(log_probs, -1, value[..., None])[..., 0]

    def entropy(
        self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Exact; takes and ignores the draws a `TanhNormal` entropy needs, as the
        reference's `entropy(seed=None)` (:67), and draws nothing."""
        log_probs = torch.log_softmax(self.logits, dim=-1)
        probs = torch.exp(log_probs)
        # 0 * log 0 -> 0 for masked entries.
        plogp = torch.where(probs > 0, probs * log_probs, 0.0)
        return -plogp.sum(-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)


def masked_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Illegal-action logits become float32.min (reference `:84-86`)."""
    return torch.where(mask, logits, _MASK_NEG)


class MaskedCategorical(Categorical):
    """Categorical with an action mask applied to the logits."""

    def __init__(self, logits: torch.Tensor, mask: torch.Tensor):
        super().__init__(masked_logits(logits, mask))


def masked_greedy(q_values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Greedy masked argmax over the last axis: `MaskedEpsGreedy.mode()` without
    building the distribution (the fused double-DQN target pass)."""
    return torch.argmax(torch.where(mask, q_values, _MASK_NEG), dim=-1)


class MaskedEpsGreedy(Categorical):
    """Epsilon-greedy over masked Q-values (reference `distributions.py:187-212`):
    probs = eps * uniform(legal actions) + (1 - eps) * onehot(greedy), kept as the
    logits log(clip(probs, 1e-12)) of the base `Categorical`, so that sampling
    (also at eps = 0) is the Gumbel-max draw the reference makes."""

    def __init__(self, q_values: torch.Tensor, epsilon, mask: torch.Tensor):
        self.q_values = q_values
        mask_f = mask.to(q_values.dtype)
        uniform = mask_f / mask_f.sum(-1, keepdim=True)
        self._greedy = masked_greedy(q_values, mask)
        greedy = torch.nn.functional.one_hot(self._greedy, q_values.shape[-1]).to(q_values.dtype)
        probs = epsilon * uniform + (1.0 - epsilon) * greedy
        super().__init__(torch.log(torch.clamp(probs, min=1e-12)))

    def mode(self) -> torch.Tensor:
        return self._greedy


_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_HALF_LOG_2PI_E = 0.5 * math.log(2.0 * math.pi * math.e)


def _normal_log_prob(value: torch.Tensor, loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    log_unnormalized = -0.5 * torch.square((value - loc) / scale)
    return log_unnormalized - (_HALF_LOG_2PI + torch.log(scale))


def _tanh_forward_log_det_jacobian(x: torch.Tensor) -> torch.Tensor:
    """log|d tanh(x)/dx| = 2 (log 2 - x - softplus(-2x)). The softplus is
    `logaddexp(., 0)` as the reference's (`F.softplus` turns into the identity
    above 20)."""
    return 2.0 * (math.log(2.0) - x - torch.logaddexp(-2.0 * x, torch.zeros_like(x)))


class _LogNdtr(torch.autograd.Function):
    """`log_ndtr` as the reference computes it: the value rounded from float64
    (PyTorch's float32 `log_ndtr` is an ulp off in the tail where the
    reference's is not), and the derivative as `jax.scipy.special.log_ndtr`'s
    jvp groups it: exp((-0.5 x² - log√(2π)) - log_ndtr(x)). The derivative
    scales the value's error by |x|, so an ulp at x = -4 shows as 1e-6."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = torch.special.log_ndtr(x.double()).to(x.dtype)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        x, y = ctx.saved_tensors
        return grad * torch.exp(-0.5 * torch.square(x) - _HALF_LOG_2PI - y)


class TanhNormal:
    """Independent tanh-squashed diagonal Normal over the last axis (reference
    `distributions.py:111-180`): events lie in [-1, 1]; `log_prob` clips them
    at |a| = `threshold` and gives the clipped ends the Normal's tail mass
    (differentiable in loc and scale) spread over the clipped width; `entropy`
    is a one-sample estimate of H[normal] + E[log det J_tanh]."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, threshold: float = 0.999):
        self.loc = loc
        self.scale = scale
        self._threshold = threshold

    def _tail_log_probs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The log-probabilities of the clipped ends, left and right, made where
        `log_prob` needs them: a sample does not, and a stacked actor's head
        builds its distribution inside `torch.func.vmap`, where `_LogNdtr`
        cannot run."""
        # float32 constants, as the reference's jnp calls make them.
        f32 = dict(dtype=self.loc.dtype, device=self.loc.device)
        inverse_threshold = torch.atanh(torch.tensor(self._threshold, **f32))
        log_epsilon = torch.log(torch.tensor(1.0 - self._threshold, **f32))
        # norm.logcdf(x, loc, scale) = log_ndtr((x - loc) / scale).
        left = _LogNdtr.apply((-inverse_threshold - self.loc) / self.scale) - log_epsilon
        right = _LogNdtr.apply((-inverse_threshold + self.loc) / self.scale) - log_epsilon
        return left, right

    def _noise(self, generator: Optional[torch.Generator]) -> torch.Tensor:
        return normal(self.loc.shape, generator, self.loc.device)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.sample_from_noise(self._noise(generator))

    def sample_from_noise(self, normal_noise: torch.Tensor) -> torch.Tensor:
        """tanh(loc + scale * noise) with pre-drawn standard normals."""
        return torch.tanh(self.loc + self.scale * normal_noise)

    def raw_params(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.loc, self.scale)

    def sample_and_log_prob(
        self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(action, log_prob) of one draw. The log-prob is the unclipped
        pre-tanh value's (reference :150-157), not `log_prob(action)`, which
        clips at the threshold."""
        noise = self._noise(generator) if noise is None else noise
        pre_tanh = self.loc + self.scale * noise
        per_dim = _normal_log_prob(pre_tanh, self.loc, self.scale)
        per_dim = per_dim - _tanh_forward_log_det_jacobian(pre_tanh)
        return torch.tanh(pre_tanh), per_dim.sum(-1)

    def log_prob(self, event: torch.Tensor) -> torch.Tensor:
        t = self._threshold
        event = torch.clamp(event, -t, t)
        pre_tanh = torch.atanh(event)
        in_bounds = _normal_log_prob(pre_tanh, self.loc, self.scale)
        in_bounds = in_bounds - _tanh_forward_log_det_jacobian(pre_tanh)
        left, right = self._tail_log_probs()
        per_dim = torch.where(event <= -t, left, torch.where(event >= t, right, in_bounds))
        return per_dim.sum(-1)

    def entropy(
        self, generator: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        noise = self._noise(generator) if noise is None else noise
        pre_tanh = self.loc + self.scale * noise
        per_dim = _HALF_LOG_2PI_E + torch.log(self.scale) + _tanh_forward_log_det_jacobian(pre_tanh)
        return per_dim.sum(-1)

    def mode(self) -> torch.Tensor:
        return torch.tanh(self.loc)
