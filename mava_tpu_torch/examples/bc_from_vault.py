"""Offline MARL from a vault: behaviour-clone a policy from stored experience
(port of `examples/bc_from_vault.py`).

It reads a vault that `advanced_usage/ff_ippo_store_experience.py` wrote (its
named leaves `.obs.agents_view`, `.obs.action_mask`, `.obs.step_count`,
`.action`), trains a fresh feed-forward actor by behaviour cloning (the
cross-entropy of the recorded actions under the masked policy, Adam), and
evaluates the clone in the live environment with the stock evaluator.

Usage (record a dataset first, then clone from it):

    python -m mava_tpu_torch.advanced_usage.ff_ippo_store_experience \
        env=rware env/scenario=tiny-2ag system.total_timesteps=2000000
    python -m mava_tpu_torch.examples.bc_from_vault vault_uid=<ts> env=rware \
        env/scenario=tiny-2ag bc_epochs=40

The vault is `vaults/<vault_name>/<vault_uid>` of the working directory; the
newest uid when none is given. Runs on the card unless `+arch.device=cpu`.
"""

from __future__ import annotations

import os
import sys
from typing import Sequence, Tuple

import numpy as np
import torch

from mava_tpu_torch import envs as environments
from mava_tpu_torch.evaluator import get_eval_fn, make_ff_eval_act_fn
from mava_tpu_torch.networks import FeedForwardActor
from mava_tpu_torch.networks.factory import make_action_head, make_torso
from mava_tpu_torch.replay.vault import Vault
from mava_tpu_torch.systems.anakin import start_experiment
from mava_tpu_torch.types import Observation
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.training import ClippedAdam

DEFAULTS = ["env=rware", "logger.use_console=False"]
NEEDED = (".obs.agents_view", ".obs.action_mask", ".obs.step_count", ".action")


def load_dataset(vault_name: str, vault_uid: str, device) -> Tuple[Observation, torch.Tensor]:
    """The vault's (observation, action) pairs, flattened over batch and time:
    leaves (N, A, ...)."""
    vault = Vault(vault_name=vault_name, vault_uid=vault_uid)
    data = vault.read()
    missing = [k for k in NEEDED if k not in data]
    if missing:
        raise SystemExit(f"vault {vault.base_dir} lacks named leaves {missing}; re-record it "
                         "(older vaults used positional leaf names).")

    def flat(name, dtype=None):
        x = torch.as_tensor(data[name].reshape(-1, *data[name].shape[2:]), device=device)
        return x if dtype is None else x.to(dtype)

    obs = Observation(flat(".obs.agents_view", torch.float32), flat(".obs.action_mask"),
                      flat(".obs.step_count"))
    return obs, flat(".action", torch.int64)


def main(argv: Sequence[str] = ()) -> float:
    argv = list(argv) or sys.argv[1:]
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    vault_uid = kv.pop("vault_uid", "")
    vault_name = kv.pop("vault_name", "ff_ippo_store_experience")
    epochs = int(kv.pop("bc_epochs", "20"))
    batch_size = int(kv.pop("bc_batch_size", "2048"))
    lr = float(kv.pop("bc_lr", "3e-4"))
    config = load_config("default_ff_ippo", DEFAULTS + [f"{k}={v}" for k, v in kv.items()])
    if not vault_uid:
        base = os.path.join("vaults", vault_name)
        uids = sorted(os.listdir(base)) if os.path.isdir(base) else []
        if not uids:
            raise SystemExit(f"no vaults under {base}; record one first.")
        vault_uid = uids[-1]

    device = start_experiment(config)
    obs, actions = load_dataset(vault_name, vault_uid, device)
    n = obs.agents_view.shape[0]
    print(f"dataset: {n:,} timesteps x {actions.shape[-1]} agents", flush=True)

    _, eval_env = environments.make(config, device)
    config.system.num_agents = eval_env.num_agents
    with torch.random.fork_rng(devices=[]):
        torch.random.default_generator.manual_seed(config.system.seed)
        torso = make_torso(config.network.actor_network.pre_torso, obs.agents_view.shape[-1])
        actor = FeedForwardActor(torso, make_action_head(
            config.network.action_head, torso.out_features, eval_env.action_dim)).to(device)
    params = list(actor.parameters())
    opt = ClippedAdam(params, lr, float("inf"), eps=1e-8)  # optax.adam(lr): no clip

    generator = torch.Generator().manual_seed(config.system.seed)
    steps_per_epoch = max(1, n // batch_size)
    for epoch in range(epochs):
        perm = torch.randperm(n, generator=generator).to(device)
        losses = []
        for i in range(steps_per_epoch):
            idx = perm[i * batch_size:(i + 1) * batch_size]
            batch = Observation(*(x[idx] for x in obs))
            loss = -actor(batch).log_prob(actions[idx]).mean()
            opt.step(torch.autograd.grad(loss, params))
            losses.append(loss.detach())
        if epoch % max(1, epochs // 10) == 0 or epoch == epochs - 1:
            print(f"epoch {epoch}: bc loss {torch.stack(losses).mean().item():.4f}", flush=True)

    evaluator = get_eval_fn(eval_env, make_ff_eval_act_fn(config), config, absolute_metric=False)
    with torch.no_grad():
        metrics = evaluator(actor, torch.Generator(device=device).manual_seed(123), {})
    ep_return = float(np.mean(np.asarray(metrics["episode_return"])))
    print(f"BC policy eval return: {ep_return:.3f} (dataset {vault_name}/{vault_uid})", flush=True)
    return ep_return


if __name__ == "__main__":
    main()
