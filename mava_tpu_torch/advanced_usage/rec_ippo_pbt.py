"""rec-IPPO with population based training over a stacked recurrent population
(port of `mava_tpu/advanced_usage/rec_ippo_pbt.py`): `ff_ippo_pbt`'s exploit and
explore step on `rec_ippo_vmap_seeds`'s learner. Parameters and optimizer
state migrate between members; GRU hidden states, env states and generators
stay each member's own.

CLI: python -m mava_tpu_torch.advanced_usage.rec_ippo_pbt \
    env=smax env/scenario=3s5z arch.num_envs=32 '+system.pbt_population=8' \
    '+system.pbt_lr_range=[1e-4, 1e-3]'
"""

from __future__ import annotations

import sys

from mava_tpu_torch.advanced_usage import rec_ippo_vmap_seeds
from mava_tpu_torch.advanced_usage.ff_ippo_pbt import run_pbt
from mava_tpu_torch.evaluator import make_rec_eval_act_fn
from mava_tpu_torch.utils.config import Config, load_config


def run_experiment(config: Config, centralised_critic: bool = False) -> float:
    return run_pbt(config, centralised_critic, rec_ippo_vmap_seeds, make_rec_eval_act_fn,
                   rec_ippo_vmap_seeds.eval_hidden, "rec ")


def main() -> float:
    cfg = load_config("default_rec_ippo", sys.argv[1:])
    performance = run_experiment(cfg)
    print("rec-IPPO PBT experiment completed.")
    return performance


if __name__ == "__main__":
    main()
