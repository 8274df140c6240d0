"""ff-MASAC on MaHumanoid humanoid-9-8 against `mava_tpu`'s: one whole update
from the JAX learner's state and draws equals the JAX learner's to 1e-5, on
the harness of `test_torch_sac.py`. The centralised critics read the global
state, the two agents' 40-wide views tiled (2 x 80), and the joint action of
the padded (2, 9) rectangle. Apart from `test_torch_sac_articulated.py`
because the JAX learner's two compiles of the humanoid's step take most of
a minute on a CPU.
"""

import torch

from test_torch_sac import check_one_update
from test_torch_sac_articulated import articulated_draws

torch.set_num_threads(1)


def test_one_masac_update_on_mahumanoid_matches_jax_learner():
    out = check_one_update("default_ff_masac", centralised=True, overrides=["env=mahumanoid"],
                           **articulated_draws("mahumanoid"))
    obs = out.learner_state.buffer_state.experience.obs
    assert obs.agents_view.shape[1:] == (2, 40) and obs.global_state.shape[1:] == (1, 80)
    q1 = out.learner_state.params.q.online.q1
    assert q1.torso.layers[0].in_features == 80 + 2 * 9
