"""Render one episode to an animated GIF (port of `examples/render_episode.py`).

Rolls out one eval env with a random policy or an ff actor (fresh from the
config's seed, or restored from a checkpoint that a training run saved with
`logger.checkpointing.save_model=True`), rendering every state with
`mava_tpu_torch/envs/render.py`. It runs on the card, as the training CLIs
do, unless `+arch.device=cpu` asks for the CPU.

Usage (config overrides compose as in the training CLIs):

    python -m mava_tpu_torch.examples.render_episode env=rware env/scenario=tiny-2ag
    python -m mava_tpu_torch.examples.render_episode env=cleaner network=cnn policy=fresh
    python -m mava_tpu_torch.examples.render_episode env=lbf policy=checkpoint \\
        checkpoint_uid=<ts> out=results/render/lbf.gif
    python -m mava_tpu_torch.examples.render_episode env=lbf +arch.device=cpu

Envs: RWARE, LBF, Cleaner, MaConnector, SMAX, MaSwarm, Gigastep, MaReacher,
MaSwimmer, MaHopper, MaWalker, MaCheetah, MaAnt, MaHumanoid.
"""

from __future__ import annotations

import os
import sys

import torch

from mava_tpu_torch import envs as environments
from mava_tpu_torch import specs
from mava_tpu_torch.envs.render import rollout_episode, save_gif, unwrap_env
from mava_tpu_torch.systems.anakin import start_experiment
from mava_tpu_torch.utils.config import load_config

DEFAULTS = ["env=rware", "logger.use_console=False"]  # rware's default scenario: tiny-2ag


def make_act_fn(cfg, env, policy: str, checkpoint_uid: str, device: torch.device):
    """`act(timestep, generator)` -> the actions of a batch of one env."""
    base = unwrap_env(env)
    if policy == "random":
        spec = base.action_spec()

        def random_act(timestep, generator):
            if isinstance(spec, specs.DiscreteArray):
                return torch.randint(0, base.action_dim, (1, base.num_agents),
                                     generator=generator, device=device)
            return torch.rand((1, base.num_agents, base.action_dim), generator=generator,
                              device=device) * 2 - 1

        return random_act

    # fresh / checkpoint: the actor and critic as ff_ippo.learner_setup builds
    # them (a checkpoint's params hold both, though only the actor acts).
    from mava_tpu_torch.systems.ppo.ff_ippo import make_networks
    from mava_tpu_torch.systems.ppo.types import Params

    cfg.system.num_agents = env.num_agents
    actor, critic = make_networks(env, cfg, device, cfg.system.seed)
    if policy == "checkpoint":
        from mava_tpu_torch.utils.checkpointing import Checkpointer

        uid = checkpoint_uid or cfg.logger.checkpointing.load_args.get("checkpoint_uid")
        if not uid:
            raise SystemExit(
                "policy=checkpoint needs checkpoint_uid=<ts>, the run directory under "
                "checkpoints/<system>/.")
        load_args = {**cfg.logger.checkpointing.load_args, "checkpoint_uid": uid}
        Checkpointer(model_name=cfg.logger.system_name, **load_args).restore_params(
            Params(actor, critic))

    def act(timestep, generator):
        return actor(timestep.observation).mode()

    return act


def main() -> str:
    kv = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    policy = kv.pop("policy", "random")
    checkpoint_uid = kv.pop("checkpoint_uid", "")
    out = kv.pop("out", "")
    seed = int(kv.pop("render_seed", "0"))
    cfg = load_config("default_ff_ippo", DEFAULTS + [f"{k}={v}" for k, v in kv.items()])
    device = start_experiment(cfg)
    _, eval_env = environments.make(cfg, device)

    act_fn = make_act_fn(cfg, eval_env, policy, checkpoint_uid, device)
    frames, ep_return = rollout_episode(eval_env, act_fn,
                                        torch.Generator(device=device).manual_seed(seed))
    if not out:
        os.makedirs("results/render", exist_ok=True)
        out = f"results/render/{cfg.env.env_name}_{policy}_torch.gif"
    save_gif(frames, out)
    print(f"wrote {out}: {len(frames)} frames, episode return {ep_return:.2f} "
          f"({policy} policy)", flush=True)
    return out


if __name__ == "__main__":
    main()
