"""What the stacked programs share (the reference spreads it over
`mava_tpu/advanced_usage/ff_isac_vmap_seeds.py:60-108` and the run loops of
`ff_ippo_vmap_seeds.py` and `rec_ippo_vmap_seeds.py`).

A stacked program trains S entries as one learner: the parameters and the
optimizers' moments carry a leading entry axis, the envs are one batch of
S * E rows (entry s owns rows [s * E, (s + 1) * E)), and every draw of an
update is made for all entries at once.
  * Seeds: each entry its own init (`system.seed + s`) and its own draws.
  * A sweep (and a PBT population): every entry the same init, the same env
    resets and the same draws, so that the entries differ by their learning
    rate alone; the rate lives in the optimizer's state.
The evaluation is the stock evaluator, entry by entry, outside the updates.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from mava_tpu_torch.envs.wrappers import get_final_step_metrics
from mava_tpu_torch.evaluator import get_eval_fn
from mava_tpu_torch.utils.config import Config
from mava_tpu_torch.utils.logger import LogEvent, MavaLogger
from mava_tpu_torch.utils.profiling import PhaseTimer


def refuse_seed_shards(config: Config, program: str) -> None:
    """`system.seed_shards > 1` shards the entries over a 2-D (seed, data) mesh
    of several devices in the reference; one card has no such mesh."""
    shards = int(config.system.get("seed_shards", 1))
    if shards > 1:
        raise ValueError(
            f"system.seed_shards={shards} is not supported by {program}: sharding the "
            "entries over devices needs the multi-GPU data parallelism of ROADMAP.md "
            "Queue 1 item 5, which is not yet ported. Run it with seed_shards=1."
        )


def entry_seeds(config: Config, num: int, shared: bool) -> List[int]:
    """The init seed of each entry: `system.seed + s` for independent seeds, the
    same `system.seed` for every entry of a sweep."""
    seed = int(config.system.seed)
    return [seed] * num if shared else [seed + s for s in range(num)]


def tile(tree: Any, num: int) -> Any:
    """Every tensor of `tree` with a leading env axis repeated `num` times along it:
    one entry's envs or draws made every entry's."""
    return pytree.tree_map(
        lambda x: x.repeat(num, *([1] * (x.dim() - 1)))
        if isinstance(x, torch.Tensor) and x.dim() > 0 else x,
        tree,
    )


class Draws:
    """The draws of a stacked update: (S, *shape) from one generator, each entry
    its own (`shared` False), or one entry's draw for every entry (`shared`)."""

    def __init__(self, num: int, shared: bool, generator: torch.Generator, device):
        self.num, self.shared, self.generator, self.device = num, shared, generator, device

    def __call__(self, fn: Callable, shape: Sequence[int]) -> torch.Tensor:
        """`fn(shape, generator, device)` for every entry: (S, *shape)."""
        if self.shared:
            return fn((1, *shape), self.generator, self.device).expand(self.num, *shape)
        return fn((self.num, *shape), self.generator, self.device)

    def env(self, env: Any, num_envs: int) -> Any:
        """`env.step_noise` for the S * E rows."""
        if self.shared:
            return tile(env.step_noise(num_envs, self.generator), self.num)
        return env.step_noise(self.num * num_envs, self.generator)

    def reset(self, env: Any, num_envs: int) -> Any:
        """`env.reset_noise` for the S * E rows."""
        if self.shared:
            return tile(env.reset_noise(num_envs, self.generator), self.num)
        return env.reset_noise(self.num * num_envs, self.generator)

    def permutations(self, epochs: int, n: int) -> torch.Tensor:
        """(S, epochs, n): a uniform permutation of n per entry and epoch."""
        def perms(shape, generator, device):
            return torch.argsort(torch.rand(shape, generator=generator, device=device), dim=-1)
        return self(perms, (epochs, n))


def gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x (S, N, ...) with each entry's rows taken in its own order, index (S, M)."""
    entries = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[entries, index]


def per_entry_mean(x: torch.Tensor) -> torch.Tensor:
    """(S, ...) -> (S,): the mean over each entry's elements."""
    return x.flatten(1).mean(1)


def train_entries(
    config: Config,
    device: torch.device,
    learn: Callable,
    learner_state: Any,
    eval_env: Any,
    eval_act_fn: Callable,
    init_actor_state: Callable[[], Dict[str, Any]],
    num: int,
    rank_metric: str = "episode_return",
    after_eval: Optional[Callable[[int, Any, np.ndarray], Dict[str, float]]] = None,
):
    """Rounds of learn, log and evaluate every entry with the stock evaluator.

    Per round: the ACT line (env-steps/s over all S entries) and the TRAIN line
    as the stock loop logs them; each entry's `rank_metric` (its mean over the
    evaluation's episodes) and return, and its win rate where the env reports
    `won_episode`; the EVAL line. `after_eval(round, state, ranks)` may return
    extra EVAL entries and is where PBT steps (it returns the state to go on
    from as `state`). Returns (per-entry returns, per-entry win rates or None,
    per-entry ranks) of the last evaluation."""
    evaluator = get_eval_fn(eval_env, eval_act_fn, config, absolute_metric=False)
    eval_generator = torch.Generator(device=device).manual_seed(config.system.seed + 1)
    steps_per_round = (
        config.system.num_updates_per_eval * config.system.rollout_length * config.arch.num_envs
    )
    logger = MavaLogger(config)
    returns = np.zeros(num)
    wins: Optional[np.ndarray] = None
    ranks = np.zeros(num)
    for eval_step in range(config.arch.num_evaluation):
        timer = PhaseTimer(device)
        with timer.phase("learn"):
            output = learn(learner_state)
        elapsed = timer.phases["learn"]
        t = int(steps_per_round * (eval_step + 1))
        episode_metrics, ep_completed = get_final_step_metrics(output.episode_metrics)
        episode_metrics["steps_per_second"] = num * steps_per_round / elapsed
        if ep_completed:
            logger.log(episode_metrics, t, eval_step, LogEvent.ACT)
        logger.log(output.train_metrics, t, eval_step, LogEvent.TRAIN)

        wins = None
        state = output.learner_state
        stacked_actor = state.params.actor_params
        for s in range(num):
            metrics = evaluator(stacked_actor.entry(s), eval_generator, init_actor_state())
            returns[s] = float(np.mean(metrics["episode_return"]))
            if "won_episode" in metrics:
                won = np.asarray(metrics["won_episode"])
                wins = np.zeros(num) if wins is None else wins
                wins[s] = 100.0 * won.sum() / won.size
            ranks[s] = float(np.mean(metrics[rank_metric]))
        eval_log: Dict[str, Any] = {"episode_return": returns.copy()}
        if after_eval is None:
            eval_log["seed_return_best"] = float(returns.max())
            eval_log["seed_return_worst"] = float(returns.min())
            if wins is not None:
                # The mean win rate as the scalar the marl-eval JSON shares with
                # the stock systems; each entry's in the seed_win_* spread keys.
                eval_log["win_rate"] = float(np.mean(wins))
                eval_log["seed_win_best"] = float(np.max(wins))
                eval_log["seed_win_worst"] = float(np.min(wins))
        else:
            extra = after_eval(eval_step, state, ranks.copy())
            state = extra.pop("state", state)
            eval_log.update(extra)
        logger.log(eval_log, t, eval_step, LogEvent.EVAL)
        learner_state = state
    logger.stop()
    return returns, wins, ranks


def print_entries(prefix: str, returns: np.ndarray, wins: Optional[np.ndarray],
                  sweep_lrs: Optional[Sequence[float]]) -> None:
    """The reference's final per-entry lines."""
    if sweep_lrs is not None:
        print(f"{prefix}vmap-sweep final eval returns per lr: "
              + ", ".join(f"lr={lr:g}: {r:.2f}" for lr, r in zip(sweep_lrs, returns)))
    else:
        print(f"{prefix}vmap-seeds final eval returns per seed: "
              + ", ".join(f"{r:.2f}" for r in returns))
    if wins is not None:
        print(f"{prefix}vmap-seeds final eval win rates per seed: "
              + ", ".join(f"{w:.1f}%" for w in wins))

