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

With `system.seed_shards = K` under a process group of W ranks (the
reference's `make_seed_sharded_mesh`), the ranks split into K seed groups of
W / K consecutive ranks; each group holds `num_seeds / K` entries (their
params, optimizers, rings and envs), each of its ranks `arch.num_envs` envs of
every one of them, and the gradients are averaged over the group's ranks only
(`seed_placement`). The data-parallel stock systems are the K = 1 case of the
same placement.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from mava_tpu_torch.envs.wrappers import get_final_step_metrics
from mava_tpu_torch.evaluator import get_eval_fn
from mava_tpu_torch.parallel import Mesh, make_mesh, make_seed_sharded_mesh
from mava_tpu_torch.parallel.distributed import gather_metrics, take_rows
from mava_tpu_torch.systems import anakin
from mava_tpu_torch.systems.anakin import eval_generator
from mava_tpu_torch.utils.config import Config
from mava_tpu_torch.utils.logger import LogEvent, MavaLogger
from mava_tpu_torch.utils.profiling import PhaseTimer
from mava_tpu_torch.utils.timestep_checker import check_total_timesteps


def refuse_seed_shards(config: Config, program: str) -> None:
    """The PBT programs refuse `system.seed_shards > 1`, as the reference's do
    (`ff_ippo_pbt.py:117-123`): a population's exploit step copies members
    across the whole population."""
    shards = int(config.system.get("seed_shards", 1))
    if shards > 1:
        raise ValueError(
            f"system.seed_shards={shards} is not supported by {program}: its exploit "
            "step copies members across the population. Run it with seed_shards=1."
        )


def seed_placement(config: Config, num: int) -> Tuple[Mesh, range]:
    """The (seed, data) mesh of `system.seed_shards` groups and this rank's
    entries of `num`: its seed group's consecutive `num / seed_shards`. Sets
    `arch.n_devices` to the ranks of one group (the reference's per-seed data
    shards, `ff_isac_vmap_seeds.py:250-253`). Raises unless `seed_shards`
    divides `num` and the number of ranks."""
    shards = int(config.system.get("seed_shards", 1))
    if shards < 1 or num % shards:
        raise ValueError(f"system.seed_shards={shards} must divide num_seeds={num}")
    mesh = make_seed_sharded_mesh(shards)
    config.arch.n_devices = mesh.data_size
    return mesh, local_entries(mesh, num)


def local_entries(mesh: Mesh, num: int) -> range:
    """The entries of `num` that a rank of `mesh` holds."""
    per = num // mesh.seed_shards
    return range(mesh.seed_group * per, (mesh.seed_group + 1) * per)


def entry_reset(env: Any, generator: torch.Generator, num: int, shared: bool, num_envs: int,
                mesh: Mesh, device) -> Tuple[Any, Any]:
    """This rank's envs of a stacked program: the reset noise of all `num`
    entries' envs, `num_envs` on each data rank of a group (entry-major, then
    data rank), drawn from `generator` as every rank holds it, and the rows of
    this rank's entries and data rank reset."""
    per_entry = mesh.data_size * num_envs
    noise = Draws(num, shared, generator, device).reset(env, per_entry)
    if mesh.world_size > 1:
        rows = torch.cat([
            torch.arange(e * per_entry + mesh.data_rank * num_envs,
                         e * per_entry + (mesh.data_rank + 1) * num_envs)
            for e in local_entries(mesh, num)]).to(device)
        noise = take_rows(noise, rows, num * per_entry)
    return env.reset(noise)


def gather_entries(local: Dict[int, Dict[str, np.ndarray]]) -> Dict[int, Dict[str, np.ndarray]]:
    """{entry: metrics} of every rank's entries, each entry's arrays joined
    over the ranks that hold it (the data ranks of its seed group), in rank
    order. A collective over every rank; the identity without a process group."""
    if not torch.distributed.is_initialized() or torch.distributed.get_world_size() == 1:
        return local
    every: List[Any] = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(every, local)
    joined: Dict[int, Dict[str, list]] = {}
    for part in every:
        for entry, metrics in part.items():
            for k, v in metrics.items():
                joined.setdefault(entry, {}).setdefault(k, []).append(np.atleast_1d(v))
    return {e: {k: np.concatenate(vs) for k, vs in m.items()} for e, m in sorted(joined.items())}


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


def schedule_rounds(config: Config) -> Tuple[Config, int]:
    """The reference's rounds of the off-policy programs: `total_timesteps //
    num_evaluation` env-steps, `scan_steps` updates each (at least one)."""
    config = check_total_timesteps(config)
    steps_per_rollout = int(config.system.total_timesteps // config.arch.num_evaluation)
    act_steps = config.arch.n_devices * config.arch.num_envs * config.system.rollout_length
    config.system.scan_steps = max(1, steps_per_rollout // act_steps)
    return config, steps_per_rollout


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
    log_wins: bool = False,
    policy: Callable[[Any], Any] = lambda state: state.params.actor_params,
    explore: Optional[Callable[[Any], Tuple[Any, Any, int]]] = None,
    rounds: Optional[Sequence[int]] = None,
    steps_per_round: Optional[int] = None,
    mesh: Optional[Mesh] = None,
):
    """Rounds of learn, log and evaluate every entry with the stock evaluator.
    On a seed-sharded `mesh` (by default the process group's data mesh) each
    rank trains and evaluates its own entries (`local_entries`) and every
    entry's evaluation is gathered from the ranks that hold it; `num` counts
    all the entries.

    `explore(state)` -> (state, episode metrics, env-steps), where given, runs
    first and is logged at ACT (SAC's explore phase). Per round: the ACT line
    (env-steps/s over all S entries) and the TRAIN line as the stock loop logs
    them; each entry's `rank_metric` (its mean over the evaluation's episodes)
    and return, and, with `log_wins` (the rec PPO programs, as their
    reference), its win rate where the env reports `won_episode`; the EVAL
    line. `policy(state)` is the stacked network the evaluator runs entry by
    entry. A round is `steps_per_round` env-steps (by default the PPO
    programs' `num_updates_per_eval` updates) and `rounds` the env-step count
    at the end of each (by default `arch.num_evaluation` rounds from 0).
    `after_eval(round, state, ranks)` may return extra EVAL entries and is
    where PBT steps (it returns the state to go on from as `state`). Returns
    (per-entry returns, per-entry win rates or None, per-entry ranks) of the
    last evaluation."""
    evaluator = get_eval_fn(eval_env, eval_act_fn, config, absolute_metric=False)
    generator = eval_generator(config, device)
    entries = local_entries(mesh or make_mesh(), num)
    if steps_per_round is None:
        steps_per_round = anakin.steps_per_round(config)
    if rounds is None:
        rounds = [steps_per_round * (r + 1) for r in range(config.arch.num_evaluation)]
    logger = MavaLogger(config)
    if explore is not None:
        timer = PhaseTimer(device)
        with timer.phase("explore"):
            learner_state, metrics, t = explore(learner_state)
        episode_metrics, ep_completed = get_final_step_metrics(gather_metrics(metrics))
        episode_metrics["steps_per_second"] = num * t / timer.phases["explore"]
        if ep_completed:
            logger.log(episode_metrics, t, 0, LogEvent.ACT)
    returns = np.zeros(num)
    wins: Optional[np.ndarray] = None
    ranks = np.zeros(num)
    for eval_step, t in enumerate(rounds):
        timer = PhaseTimer(device)
        with timer.phase("learn"):
            output = learn(learner_state)
        elapsed = timer.phases["learn"]
        episode_metrics, ep_completed = get_final_step_metrics(
            gather_metrics(output.episode_metrics))
        episode_metrics["steps_per_second"] = num * steps_per_round / elapsed
        if ep_completed:
            logger.log(episode_metrics, t, eval_step, LogEvent.ACT)
        logger.log(output.train_metrics, t, eval_step, LogEvent.TRAIN)

        wins = None
        state = output.learner_state
        stacked = policy(state)
        evaluated = gather_entries({
            e: evaluator(stacked.entry(s), generator, init_actor_state())
            for s, e in enumerate(entries)})
        for s, metrics in evaluated.items():
            returns[s] = float(np.mean(metrics["episode_return"]))
            if log_wins and "won_episode" in metrics:
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
    """The reference's final per-entry lines: the returns, and the win rates
    where `train_entries` logged them (`log_wins`)."""
    if sweep_lrs is not None:
        print(f"{prefix}vmap-sweep final eval returns per lr: "
              + ", ".join(f"lr={lr:g}: {r:.2f}" for lr, r in zip(sweep_lrs, returns)))
    else:
        print(f"{prefix}vmap-seeds final eval returns per seed: "
              + ", ".join(f"{r:.2f}" for r in returns))
    if wins is not None:
        print(f"{prefix}vmap-seeds final eval win rates per seed: "
              + ", ".join(f"{w:.1f}%" for w in wins))
