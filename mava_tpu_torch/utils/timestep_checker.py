"""Derive total_timesteps <-> num_updates (port of
`mava_tpu/utils/timestep_checker.py`). The counts are global: an update
takes `rollout_length` steps of `num_envs` envs on each of `arch.n_devices`
ranks."""

from __future__ import annotations


def check_total_timesteps(config):
    """Fill in whichever of total_timesteps / num_updates is unset."""
    if config.system.get("total_timesteps") is None and config.system.get(
        "num_updates"
    ) is None:
        raise ValueError("Set one of system.total_timesteps / system.num_updates.")
    n_devices = config.arch.get("n_devices") or 1
    config.arch.n_devices = n_devices
    steps_per_update = n_devices * config.system.rollout_length * config.arch.num_envs
    if config.system.get("total_timesteps") is None:
        config.system.total_timesteps = int(config.system.num_updates * steps_per_update)
    else:
        config.system.num_updates = int(config.system.total_timesteps // steps_per_update)
        print(
            f"Setting num_updates = {config.system.num_updates} from "
            f"total_timesteps = {config.system.total_timesteps}."
        )
    return config
