"""Staggered environment resets (port of `mava_tpu/envs/stagger.py`).

With every env reset at once, episodes of (near) fixed length end in lockstep
and each rollout holds the same episode phase across the batch.
`stagger_env_states` desynchronises the batch once, at setup: after the
normal reset, env i takes k_i ~ U[0, time_limit) uniform random legal actions
(auto-resets included), so its episodes then end near t = k_i (mod L). No
per-step semantics change. Opt-in via `arch.stagger_resets=True`, for the
feed-forward PPO systems; the others call `reject_stagger`.

The burn-in draws from a generator of its own, seeded from the run's seed and
a fixed constant (`stagger_generator`), so that turning it on does not shift
the learner's stream, as the reference's `fold_in` key (:40-45) does not. Its
draws can be handed in instead: the caps, each step's action noise (Gumbel
noise over the masked actions, or uniforms on [0, 1) for a bounded continuous
spec) and each step's `env.step_noise`.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from mava_tpu_torch import specs
from mava_tpu_torch.distributions import gumbel

STAGGER_SEED_CONSTANT = 0x57A6


def stagger_generator(seed: int, device: torch.device) -> torch.Generator:
    """The burn-in's generator: one seed derived from the run's seed and a
    fixed constant, the same at every call site."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 65536 + STAGGER_SEED_CONSTANT) % (2**63)
    )


def _action_noise(spec: specs.Array, timestep: Any, generator: torch.Generator) -> torch.Tensor:
    mask = timestep.observation.action_mask
    if isinstance(spec, specs.DiscreteArray):
        return gumbel(mask.shape, generator, mask.device)
    n = timestep.reward.shape[0]
    return torch.rand((n, *spec.shape), generator=generator, device=mask.device)


def _random_action(spec: specs.Array, timestep: Any, noise: torch.Tensor) -> torch.Tensor:
    """Uniform random legal actions (reference :48-70): a Gumbel-max draw over
    logits of 0 (legal) and -1e9 (masked), or uniforms scaled to the spec's
    bounds as `jax.random.uniform(minval, maxval)` scales them."""
    if isinstance(spec, specs.DiscreteArray):
        mask = timestep.observation.action_mask
        logits = torch.where(mask, 0.0, -1e9)
        return torch.argmax(noise + logits, dim=-1).to(spec.dtype)
    lo = -1.0 if spec.minimum is None else spec.minimum
    hi = 1.0 if spec.maximum is None else spec.maximum
    return torch.clamp_min(noise * (hi - lo) + lo, lo).to(spec.dtype)


def _select(advance: torch.Tensor, new: Any, old: Any) -> Any:
    def sel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.where(advance.reshape(-1, *([1] * (a.dim() - 1))), a, b)

    return pytree.tree_map(sel, new, old)


def stagger_env_states(
    env: Any,
    env_state: Any,
    timestep: Any,
    generator: torch.Generator,
    caps: Optional[torch.Tensor] = None,
    action_noise: Optional[Sequence[torch.Tensor]] = None,
    env_noise: Optional[Sequence[Any]] = None,
) -> Tuple[Any, Any]:
    """Advance env i by caps[i] ~ U[0, time_limit) random-action steps of the
    wrapped train env (auto-reset included); returns the (state, timestep) of
    the batch after the burn-in, whose data is discarded (reference :73-117).
    `caps` (E,), `action_noise[t]` and `env_noise[t]` replace the draws of
    the caps and of step t."""
    time_limit = int(env.time_limit)
    n_envs = timestep.reward.shape[0]
    spec = env.action_spec()
    if caps is None:
        caps = torch.randint(
            0, time_limit, (n_envs,), generator=generator, device=timestep.reward.device
        )
    state, ts = env_state, timestep
    # The largest cap is time_limit - 1, so at most that many steps advance anyone.
    for t in range(time_limit - 1):
        noise = _action_noise(spec, ts, generator) if action_noise is None else action_noise[t]
        step_noise = env.step_noise(n_envs, generator) if env_noise is None else env_noise[t]
        new_state, new_ts = env.step(state, _random_action(spec, ts, noise), step_noise)
        advance = t < caps
        state, ts = _select(advance, new_state, state), _select(advance, new_ts, ts)
    return state, ts


def reject_stagger(config: Any, system_name: str) -> None:
    """Fail fast when `arch.stagger_resets` is set for a system that ignores
    it (reference :120-132): a recurrent policy would start mid-episode with a
    zero carry, and off-policy replay already decorrelates episode phase."""
    if config.arch.get("stagger_resets", False):
        raise ValueError(
            f"arch.stagger_resets=True is not supported by {system_name} "
            "(feedforward PPO systems only — see mava_tpu_torch/envs/stagger.py)."
        )
