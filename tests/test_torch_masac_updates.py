"""ff-MASAC of the port against `mava_tpu`'s over a chain of 24 updates, at the
reward scale the MaSwarm anchor runs (`system.reward_scale=0.1`).

The JAX learner runs its explore phase and one warm-up update; its state is
loaded into the port once. Then both learners make 24 updates, each from its
own state: before each one the port is handed that update's draws,
recomputed from the JAX learner's keys (`test_torch_sac._update_draws`), and
its state is carried on from its own last update, never reloaded, as a long
run carries it. With 3 envs, rollout 2 and episodes of 5 steps the chain holds
several time-limit episode ends and their auto-reset draws, and the ring of 7
items wraps at every update.

After each update the parameters, the targets, `log_alpha`, the three Adam
states, the buffer, the losses and the episode metrics are held to the JAX
learner's: at update 1 to the one-update test's tolerances (rtol = atol =
1e-5, the Adam moments rtol 1e-5 and atol 1e-8); at updates 2 to 24 to
rtol 1e-4 and atol 1e-6 (the Adam moments, whose second moments lie near
1e-6, to rtol 1e-4 and atol 1e-7). The largest relative difference of each
update, max |port - JAX| / max |JAX| over a leaf, is printed (`pytest -s`), so
that any growth along the chain shows. The JAX learner is compiled once; an
ff-ISAC chain would double the file's time and is left to the one-update test.
"""

import jax
import numpy as np
import torch

from mava_tpu.parallel import make_mesh
from mava_tpu.systems.sac import ff_isac as jff_isac
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch import envs as tenvs
from mava_tpu_torch.systems.sac import ff_isac
from mava_tpu_torch.utils.config import load_config
from test_torch_sac import (
    ADAM_TOL,
    TINY,
    TOL,
    _load_learner_state,
    _prepare,
    _update_draws,
    assert_update_matches,
)

torch.set_num_threads(1)
UPDATES = 24
CHAIN_TOL = dict(rtol=1e-4, atol=1e-6)
CHAIN_ADAM_TOL = dict(rtol=1e-4, atol=1e-7)
OVERRIDES = TINY + ["system.reward_scale=0.1"]


def test_masac_chain_of_updates_matches_jax_learner():
    cfg = _prepare(jax_load_config("default_ff_masac", OVERRIDES))
    explore, update, jstate = jff_isac.build_bench_learners(cfg, make_mesh(jax.devices()[:1]), True)
    jstate, _ = explore(jstate)
    jstate, _ = update(jstate)  # warm-up: the buffer wraps

    tcfg = _prepare(load_config("default_ff_masac", OVERRIDES + ["+arch.device=cpu"]))
    assert tcfg.system.reward_scale == 0.1
    tenv, _ = tenvs.make(tcfg, "cpu", add_global_state=True)
    _, learn, _, state = ff_isac.learner_setup(tenv, torch.Generator().manual_seed(0), tcfg,
                                               torch.device("cpu"), True)
    state = _load_learner_state(state, jax.device_get(jstate))
    ends, worst = 0, []
    for u in range(1, UPDATES + 1):
        # Each update is called on the arrays the last one made, so its
        # compiled program is reused; the host copies are for the draws.
        jout = update(jstate)
        host_state, host_out = jax.device_get((jstate, jout))
        draws = _update_draws(host_state, host_out, cfg, tenv)
        out = learn(state, [draws])
        tol, adam_tol = (TOL, ADAM_TOL) if u == 1 else (CHAIN_TOL, CHAIN_ADAM_TOL)
        worst.append(assert_update_matches(out, host_out, tol, adam_tol))
        print(f"update {u}: largest relative difference {worst[-1][0]:.3e} ({worst[-1][1]})")
        ends += int(np.asarray(host_out[1][0]["is_terminal_step"]).sum())
        state, jstate = out.learner_state, jout[0]
    assert ends >= 3 * 8  # every env ends an episode at least 8 times along the chain
    assert state.t == int(np.asarray(jstate.t))
