"""ff-IPPO with population based training over a stacked population (port of
`mava_tpu/advanced_usage/ff_ippo_pbt.py`).

A population of N members trains as one stacked learner with a learning rate
each (`ff_ippo_vmap_seeds.learner_setup` with `sweep_lrs`: log-uniform over
`system.pbt_lr_range`). Between evaluations a PBT step (Jaderberg et al. 2017)
works on the stacked state in place:
  exploit: the bottom `pbt_frac` of the members by the env's headline metric
           copy the parameters and the optimizer's state (Adam moments and
           peak learning rate) of a top member drawn uniformly;
  explore: the copied members' learning rate is multiplied by a factor drawn
           uniformly from `system.pbt_perturb`.
Env states, hidden states and the generators stay each member's own. With
`+system.pbt_exploit=False` no step is taken: a fixed-lr population, the
control arm of a PBT comparison.

CLI: python -m mava_tpu_torch.advanced_usage.ff_ippo_pbt \
    env=rware env/scenario=tiny-2ag arch.num_envs=64 '+system.pbt_population=8' \
    '+system.pbt_lr_range=[1e-4, 1e-3]'
"""

from __future__ import annotations

import copy
import sys
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from mava_tpu_torch import envs as environments
from mava_tpu_torch.advanced_usage import ff_ippo_vmap_seeds
from mava_tpu_torch.advanced_usage.common import refuse_seed_shards, train_entries
from mava_tpu_torch.evaluator import make_ff_eval_act_fn
from mava_tpu_torch.systems.anakin import schedule_updates, start_experiment
from mava_tpu_torch.systems.ppo.types import OptStates, Params
from mava_tpu_torch.utils.config import Config, load_config
from mava_tpu_torch.utils.training import set_peak_lr


@torch.no_grad()
def pbt_exploit_explore(
    params: Params,
    opt_states: OptStates,
    returns: np.ndarray,
    generator: torch.Generator,
    frac: float = 0.25,
    perturb: Tuple[float, float] = (0.8, 1.25),
) -> Tuple[np.ndarray, np.ndarray]:
    """One PBT step on a stacked population, in place (reference :43-88).

    The bottom k = max(1, int(N * frac)) members by `returns` take the
    parameters and optimizer state of a top-k member drawn uniformly, and
    their peak learning rate (actor's and critic's alike) times a factor drawn
    uniformly from `perturb`; every other member is left bit for bit. The Adam
    count is one for the stack (every member takes every step), so it needs no
    copy. `generator` is a CPU generator. Returns (src, factors): the member
    each member now copies (itself for survivors) and its lr factor."""
    pop = returns.shape[0]
    k = max(1, int(pop * frac))
    if 2 * k > pop:
        raise ValueError(f"pbt_frac={frac} makes bottom-{k} and top-{k} overlap in a "
                         f"population of {pop}; use frac <= 0.5")
    order = np.argsort(np.asarray(returns), kind="stable")  # ascending
    bottom, top = order[:k], order[-k:]
    src = np.arange(pop)
    src[bottom] = top[torch.randint(0, k, (k,), generator=generator).numpy()]
    factors = np.ones(pop)
    factors[bottom] = torch.empty(k, dtype=torch.float64).uniform_(
        perturb[0], perturb[1], generator=generator).numpy()

    device = opt_states[0].params[0].device
    index = torch.as_tensor(src, device=device)
    for net in params:
        for p in net.parameters():
            p.copy_(p[index])
    for opt in opt_states:
        for moment in (*opt.mu, *opt.nu):
            moment.copy_(moment[index])
    # Both optimizers carry the member's lr; read the actor's.
    new_lrs = opt_states[0].peak_lr[index] * torch.as_tensor(factors, device=device)
    for opt in opt_states:
        set_peak_lr(opt, new_lrs)
    return src, factors


def resolve_rank_metric(config: Config) -> str:
    """The evaluator's key that ranks the members: `won_episode` (whose mean is
    the win rate) where the env's headline metric is `win_rate`, else that
    metric (reference :91-103)."""
    metric = config.env.get("eval_metric", "episode_return")
    return "won_episode" if metric == "win_rate" else metric


def run_pbt(
    _config: Config,
    centralised_critic: bool,
    seeds_module: Any,
    eval_act_fn: Callable,
    init_actor_state: Callable[[Config, torch.device], Callable[[], Dict[str, Any]]],
    label: str,
) -> float:
    """The PBT loop of `seeds_module`'s stacked learner (ff or rec); returns the
    best member's rank metric at the last evaluation."""
    config = copy.deepcopy(_config)
    refuse_seed_shards(config, "the PBT programs")
    pop = int(config.system.get("pbt_population", 8))
    lr_range = [float(x) for x in config.system.get("pbt_lr_range", [1e-4, 1e-3])]
    frac = float(config.system.get("pbt_frac", 0.25))
    perturb = tuple(float(x) for x in config.system.get("pbt_perturb", [0.8, 1.25]))
    exploit = bool(config.system.get("pbt_exploit", True))
    # A log-uniform grid of initial learning rates over the population.
    init_lrs = list(np.exp(np.linspace(np.log(lr_range[0]), np.log(lr_range[1]), pop)))

    if hasattr(seeds_module, "prepare"):
        config = seeds_module.prepare(config)
    device = start_experiment(config)
    env, eval_env = environments.make(config, device, add_global_state=centralised_critic)
    config = schedule_updates(config)
    generator = torch.Generator(device=device).manual_seed(config.system.seed)
    pbt_generator = torch.Generator().manual_seed(config.system.seed + 2)
    learn, _, learner_state = seeds_module.learner_setup(
        env, generator, config, device, pop, centralised_critic, sweep_lrs=init_lrs)
    lrs = np.asarray(init_lrs)

    def after_eval(eval_step: int, state: Any, ranks: np.ndarray) -> Dict[str, Any]:
        nonlocal lrs
        lrs = state.opt_states[0].peak_lr.cpu().numpy()
        best = int(ranks.argmax())
        out = {"episode_return": ranks, "pbt_best_return": float(ranks[best]),
               "pbt_best_lr": float(lrs[best])}
        if exploit and eval_step + 1 < config.arch.num_evaluation:
            pbt_exploit_explore(state.params, state.opt_states, ranks, pbt_generator, frac,
                                perturb)
        return out

    _, _, ranks = train_entries(
        config, device, learn, learner_state, eval_env, eval_act_fn(config),
        init_actor_state(config, device), pop, rank_metric=resolve_rank_metric(config),
        after_eval=after_eval)
    best = int(ranks.argmax())
    print(f"{label}PBT final: best member {best} return {ranks[best]:.2f} "
          f"lr {float(lrs[best]):.2e}; population returns "
          + ", ".join(f"{r:.2f}" for r in ranks))
    return float(ranks.max())


def run_experiment(config: Config, centralised_critic: bool = False) -> float:
    return run_pbt(config, centralised_critic, ff_ippo_vmap_seeds, make_ff_eval_act_fn,
                   lambda config, device: (lambda: {}), "")


def main() -> float:
    cfg = load_config("default_ff_ippo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("ff-IPPO PBT experiment completed.")
    return performance


if __name__ == "__main__":
    main()
