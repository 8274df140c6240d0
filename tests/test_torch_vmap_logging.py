"""What the port's stacked programs log, against their references, and the one
Adam count of a stacked PBT population.

The EVAL record: the ff PPO seed and sweep programs log the entries' returns
and their best and worst, as `mava_tpu/advanced_usage/ff_ippo_vmap_seeds.py:
324-333` does, and no win rate, on SMAX too; the rec programs add the mean win
rate and its best and worst and print the entries' win rates
(`rec_ippo_vmap_seeds.py:338-352,365-369`). The PBT step copies a member's
Adam moments but not its count, which is one for the stack: the reference's
counts advance in lockstep, so its copy leaves every count as it was too
(`mava_tpu/advanced_usage/ff_ippo_pbt.py:84-85`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu.advanced_usage.ff_ippo_pbt import pbt_exploit_explore as jax_pbt_exploit_explore
from mava_tpu.systems.ppo.types import OptStates as JOptStates
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu.utils.training import make_swept_optimizer as jax_make_swept_optimizer
from mava_tpu.utils.training import set_peak_lr as jax_set_peak_lr
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.advanced_usage import (
    common,
    ff_ippo_vmap_seeds,
    ff_ippo_vmap_sweep,
    ff_mappo_vmap_seeds,
    rec_ippo_vmap_seeds,
    rec_mappo_vmap_sweep,
)
from mava_tpu_torch.advanced_usage.ff_ippo_pbt import pbt_exploit_explore
from mava_tpu_torch.systems.anakin import schedule_updates
from mava_tpu_torch.utils.config import load_config

torch.set_num_threads(1)
SMAX = ["env=smax", "env/scenario=2s3z", "+env.kwargs.time_limit=16", "+arch.device=cpu",
        "arch.num_eval_episodes=4"]
RETURN_KEYS = {"episode_return", "seed_return_best", "seed_return_worst"}
WIN_KEYS = {"win_rate", "seed_win_best", "seed_win_worst"}
PROGRAMS = {
    "ff_ippo_vmap_seeds": (ff_ippo_vmap_seeds, "default_ff_ippo", False, ["+system.num_seeds=2"]),
    "ff_ippo_vmap_sweep": (ff_ippo_vmap_sweep, "default_ff_ippo", False,
                           ["+system.sweep_lrs=[1e-4, 1e-3]"]),
    "ff_mappo_vmap_seeds": (ff_mappo_vmap_seeds, "default_ff_mappo", False,
                            ["+system.num_seeds=2"]),
    "rec_ippo_vmap_seeds": (rec_ippo_vmap_seeds, "default_rec_ippo", True,
                            ["+system.num_seeds=2", "network.hidden_state_dim=16"]),
    "rec_mappo_vmap_sweep": (rec_mappo_vmap_sweep, "default_rec_mappo", True,
                             ["+system.sweep_lrs=[1e-4, 1e-3]", "network.hidden_state_dim=16"]),
}


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_eval_record_has_the_references_keys_on_smax(program, fast_config_overrides,
                                                     monkeypatch, capsys):
    module, config_name, wins, extra = PROGRAMS[program]
    records, log = [], common.MavaLogger.log

    def record(self, metrics, t, t_eval, event):
        if event.name == "EVAL":
            records.append(set(metrics))
        return log(self, metrics, t, t_eval, event)

    monkeypatch.setattr(common.MavaLogger, "log", record)
    cfg = load_config(config_name, fast_config_overrides + SMAX + extra)
    module.run_experiment(cfg)
    out = capsys.readouterr().out
    assert records == [RETURN_KEYS | WIN_KEYS if wins else RETURN_KEYS]
    assert ("final eval win rates per seed: " in out) == wins
    assert "final eval returns per " in out


def test_pbt_copy_leaves_the_one_adam_count_as_the_references_lockstep_counts():
    cfg = load_config("default_ff_ippo", [
        "system.num_updates=1", "arch.num_evaluation=1", "system.rollout_length=4",
        "arch.num_envs=2", "+arch.device=cpu", "network.actor_network.pre_torso.layer_sizes=[8]",
        "network.critic_network.pre_torso.layer_sizes=[8]"])
    cfg = schedule_updates(cfg)
    env, _ = tenvs.make(cfg, "cpu")
    lrs = [1e-4, 2e-4, 5e-4, 1e-3]
    learn, _, state = ff_ippo_vmap_seeds.learner_setup(
        env, torch.Generator().manual_seed(0), cfg, torch.device("cpu"), len(lrs), sweep_lrs=lrs)
    state = learn(state).learner_state
    steps = cfg.system.ppo_epochs * cfg.system.num_minibatches
    assert [opt.count for opt in state.opt_states] == [steps, steps]
    moments = [m.clone() for opt in state.opt_states for m in opt.mu]
    src, _ = pbt_exploit_explore(state.params, state.opt_states, np.array([3.0, 0.0, 2.0, 1.0]),
                                 torch.Generator().manual_seed(0), frac=0.25)
    assert src[1] == 0 and [opt.count for opt in state.opt_states] == [steps, steps]
    for before, after in zip(moments, (m for opt in state.opt_states for m in opt.mu)):
        assert torch.equal(after[1], before[0]) and torch.equal(after[0], before[0])
    # The reference: each member's own counts (Adam's and the lr schedule's), all
    # `steps` after lockstep updates, copied with the rest of its optimizer state.
    opt = jax_make_swept_optimizer(jax_load_config("default_ff_ippo", []), 0.5)
    params = {"w": jnp.zeros((len(lrs), 3))}
    jstate = jax_set_peak_lr(jax.vmap(opt.init)(params), jnp.asarray(lrs))
    for t in range(steps):
        grads = {"w": jnp.full((len(lrs), 3), float(t + 1)) * jnp.arange(1, len(lrs) + 1)[:, None]}
        _, jstate = jax.vmap(opt.update)(grads, jstate)
    _, jcopied, jsrc, _ = jax_pbt_exploit_explore(params, JOptStates(jstate, jstate),
                                                  np.array([3.0, 0.0, 2.0, 1.0]),
                                                  jax.random.PRNGKey(0))
    assert int(jsrc[1]) == 0
    counts = [np.asarray(leaf).tolist() for leaf in jax.tree.leaves(jcopied)
              if jnp.issubdtype(leaf.dtype, jnp.integer)]
    assert counts and all(c == [steps] * len(lrs) for c in counts)
