"""GAE, PPO losses and the optimizer of the port against `mava_tpu`'s."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mava_tpu.ops import gae as jgae
from mava_tpu.ops import losses as jlosses
from mava_tpu.utils import training as jtraining
from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch.ops import gae as tgae
from mava_tpu_torch.ops import losses as tlosses
from mava_tpu_torch.utils import training as ttraining
from mava_tpu_torch.utils.config import load_config

torch.set_num_threads(1)


def _rollout(seed, t_len=16, e=3, a=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    dones = (rng.random((t_len, e, a)) < 0.2).astype(np.float32)
    last_done = (rng.random((e, a)) < 0.5).astype(np.float32)
    return f(t_len, e, a), f(t_len, e, a), dones, last_done, f(e, a)


@pytest.mark.parametrize("impl", ["assoc", "sequential"])
def test_gae_with_next_done_matches_both_reference_impls(impl):
    rewards, values, dones, last_done, last_value = _rollout(0)
    j_adv, j_tgt = jgae.calculate_gae_with_next_done(
        *map(jnp.asarray, (rewards, values, dones, last_done, last_value)), 0.99, 0.95, impl=impl
    )
    t_adv, t_tgt = tgae.calculate_gae_with_next_done(
        *map(torch.tensor, (rewards, values, dones, last_done, last_value)), 0.99, 0.95
    )
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_tgt.numpy(), np.asarray(j_tgt), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["assoc", "sequential"])
def test_gae_matches_both_reference_impls(impl):
    rewards, values, dones, _, last_value = _rollout(1)
    j_adv, j_tgt = jgae.calculate_gae(
        *map(jnp.asarray, (rewards, values, dones, last_value)), 0.9, 0.8, impl=impl
    )
    t_adv, t_tgt = tgae.calculate_gae(
        *map(torch.tensor, (rewards, values, dones, last_value)), 0.9, 0.8
    )
    np.testing.assert_allclose(t_adv.numpy(), np.asarray(j_adv), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_tgt.numpy(), np.asarray(j_tgt), rtol=1e-6, atol=1e-6)


def test_clipped_ppo_policy_loss_and_grad_match():
    rng = np.random.default_rng(2)
    log_prob = rng.standard_normal(64).astype(np.float32) * 0.3 - 1.0
    old = log_prob + rng.standard_normal(64).astype(np.float32) * 0.3
    gae = rng.standard_normal(64).astype(np.float32)
    jl, jg = jax.value_and_grad(jlosses.clipped_ppo_policy_loss)(
        jnp.asarray(log_prob), jnp.asarray(old), jnp.asarray(gae), 0.2
    )
    lp = torch.tensor(log_prob, requires_grad=True)
    tl = tlosses.clipped_ppo_policy_loss(lp, torch.tensor(old), torch.tensor(gae), 0.2)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lp.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)


def test_clipped_value_loss_and_grad_match():
    rng = np.random.default_rng(3)
    value, old, targets = (rng.standard_normal(64).astype(np.float32) for _ in range(3))
    jl, jg = jax.value_and_grad(jlosses.clipped_value_loss)(
        jnp.asarray(value), jnp.asarray(old), jnp.asarray(targets), 0.2
    )
    v = torch.tensor(value, requires_grad=True)
    tl = tlosses.clipped_value_loss(v, torch.tensor(old), torch.tensor(targets), 0.2)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("decay", [False, True])
@pytest.mark.parametrize("ent_coef_final", [None, 0.001])
def test_optimizer_and_entropy_schedule_match_optax(decay, ent_coef_final):
    """Clip by global norm, then Adam (eps 1e-5), then the (decaying) lr, on
    the same gradients; params within 1e-6 and the same entropy coefficient."""
    overrides = [
        f"system.decay_learning_rates={decay}",
        f"system.ent_coef_final={'null' if ent_coef_final is None else ent_coef_final}",
        "system.num_updates=2", "system.ppo_epochs=2", "system.num_minibatches=2",
    ]
    jcfg = jax_load_config("default_rec_ippo", overrides)
    tcfg = load_config("default_rec_ippo", overrides)
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}

    jopt = jtraining.make_optimizer(
        jtraining.make_learning_rate(jcfg.system.actor_lr, jcfg), jcfg.system.max_grad_norm
    )
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = [torch.nn.Parameter(torch.tensor(params[k])) for k in ("a", "b")]
    topt = ttraining.make_optimizer(
        tparams, ttraining.make_learning_rate(tcfg.system.actor_lr, tcfg),
        tcfg.system.max_grad_norm,
    )
    for step in range(10):
        scale = 10.0 if step % 2 else 0.01  # alternate clipped and unclipped steps
        grads = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        np.testing.assert_allclose(
            ttraining.entropy_coefficient(tcfg, topt),
            float(jtraining.entropy_coefficient(jcfg, jstate)), rtol=1e-6,
        )
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate)
        jparams = optax.apply_updates(jparams, updates)
        topt.step([torch.tensor(grads[k]) for k in ("a", "b")])
        for k, p in zip(("a", "b"), tparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{k} at step {step}")
