"""The port's networks and distributions against the flax modules of `mava_tpu`.

Parameters are made by flax, carried over with `from_flax_params`, and both
sides get the same numpy inputs; outputs and parameter gradients must agree to
rtol = atol = 1e-5 (fp32, different summation order on each side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu import distributions as jdist
from mava_tpu.networks import actor_critic as jac
from mava_tpu.networks.heads import DiscreteActionHead as JHead
from mava_tpu.networks.torsos import MLPTorso as JTorso
from mava_tpu.types import Observation as JObservation
from mava_tpu_torch import distributions as tdist
from mava_tpu_torch.networks import actor_critic as tac
from mava_tpu_torch.networks.heads import DiscreteActionHead
from mava_tpu_torch.networks.torsos import MLPTorso
from mava_tpu_torch.types import Observation
from mava_tpu_torch.utils.convert import from_flax_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
T, E, A, F, H, N_ACT = 5, 3, 2, 6, 16, 5


def _obs(seed, t=T):
    rng = np.random.default_rng(seed)
    view = rng.standard_normal((t, E, A, F)).astype(np.float32)
    mask = rng.random((t, E, A, N_ACT)) < 0.7
    mask[..., 0] = True
    step = np.zeros((t, E, A), np.int32)
    done = rng.random((t, E, A)) < 0.3
    carry = rng.standard_normal((E, A, H)).astype(np.float32)
    return view, mask, step, done, carry


def _jobs(view, mask, step):
    return JObservation(jnp.asarray(view), jnp.asarray(mask), jnp.asarray(step))


def _tobs(view, mask, step):
    return Observation(torch.tensor(view), torch.tensor(mask), torch.tensor(step))


def _load(module, flax_params):
    module.load_state_dict(from_flax_params(jax.device_get(flax_params)), strict=True)
    return module


def _assert_grads(module, flax_grads):
    want = from_flax_params(jax.device_get(flax_grads))
    got = {n: p.grad for n, p in module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **TOL)


def _torsos(jax_side: bool, activation="relu"):
    if jax_side:
        return JTorso([16], activation), JTorso([16], activation)
    return MLPTorso(F, [16], activation), MLPTorso(H, [16], activation)


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_mlp_torso_matches_flax(activation):
    x = np.random.default_rng(0).standard_normal((4, 3, F)).astype(np.float32)
    jt = JTorso([16, 8], activation)
    params = jt.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tt = MLPTorso(F, [16, 8], activation)
    sd = {k.replace("pre_torso.", ""): v for k, v in from_flax_params(
        {"pre_torso": jax.device_get(params)["params"]}).items()}
    tt.load_state_dict(sd, strict=True)
    np.testing.assert_allclose(
        tt(torch.tensor(x)).detach().numpy(), np.asarray(jt.apply(params, jnp.asarray(x))), **TOL
    )


def test_discrete_action_head_and_masked_categorical_match_flax():
    view, mask, step, _, _ = _obs(1)
    emb = np.random.default_rng(2).standard_normal((T, E, A, 16)).astype(np.float32)
    jh = JHead(N_ACT)
    params = jh.init(jax.random.PRNGKey(1), jnp.asarray(emb), _jobs(view, mask, step))
    th = DiscreteActionHead(16, N_ACT)
    th.load_state_dict(
        {k.replace("action_head.", ""): v for k, v in from_flax_params(
            {"action_head": jax.device_get(params)["params"]}).items()}, strict=True)
    jpi = jh.apply(params, jnp.asarray(emb), _jobs(view, mask, step))
    tpi = th(torch.tensor(emb), _tobs(view, mask, step))
    np.testing.assert_allclose(tpi.logits.detach().numpy(), np.asarray(jpi.logits), **TOL)
    actions = np.random.default_rng(3).integers(0, N_ACT, (T, E, A))
    np.testing.assert_allclose(
        tpi.log_prob(torch.tensor(actions)).detach().numpy(),
        np.asarray(jpi.log_prob(jnp.asarray(actions))), **TOL)
    np.testing.assert_allclose(
        tpi.entropy().detach().numpy(), np.asarray(jpi.entropy()), **TOL)
    np.testing.assert_array_equal(tpi.mode().numpy(), np.asarray(jpi.mode()))
    noise = np.asarray(jax.random.gumbel(jax.random.PRNGKey(4), (T, E, A, N_ACT)))
    np.testing.assert_array_equal(
        tpi.sample_from_noise(torch.tensor(noise)).numpy(),
        np.asarray(jpi.sample_from_noise(jnp.asarray(noise))))


def test_categorical_edge_cases_match():
    """Out-of-range actions clamp (reference :63) and fully masked entries add
    0 * log 0 = 0 to the entropy (:67-72)."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, N_ACT)).astype(np.float32)
    mask = rng.random((6, N_ACT)) < 0.5
    mask[:, 2] = True
    actions = np.array([-3, 0, 2, 4, 7, 100])
    jd = jdist.MaskedCategorical(jnp.asarray(logits), jnp.asarray(mask))
    td = tdist.MaskedCategorical(torch.tensor(logits), torch.tensor(mask))
    np.testing.assert_allclose(
        td.log_prob(torch.tensor(actions)).numpy(),
        np.asarray(jd.log_prob(jnp.asarray(actions))), **TOL)
    np.testing.assert_allclose(td.entropy().numpy(), np.asarray(jd.entropy()), **TOL)
    assert td.logits.min().item() == np.finfo(np.float32).min


def _jscanned(collect, impl):
    return jac.ScannedRNN(H, collect_carries=collect, gru_impl=impl)


@pytest.mark.parametrize("impl", ["hoisted", "pallas"])
@pytest.mark.parametrize("collect", [False, True])
def test_scanned_rnn_matches_flax(collect, impl):
    """Outputs and gradients; "pallas" is the Pallas kernel (interpret mode) on
    the JAX side and `GRUSequenceFn` (plain versions on CPU) on the port's."""
    view, _, _, done, carry = _obs(6)
    ins = view
    jr = _jscanned(collect, impl)
    params = jr.init(jax.random.PRNGKey(2), jnp.asarray(carry), (jnp.asarray(ins), jnp.asarray(done)))
    tr = tac.ScannedRNN(F, H, gru_impl=impl)
    tr.load_state_dict({k.removeprefix("rnn."): v for k, v in from_flax_params(
        {"ScannedRNN_0": jax.device_get(params)["params"]}).items()}, strict=True)
    w = np.random.default_rng(7).standard_normal((T, E, A, H)).astype(np.float32)

    def jloss(p):
        final, out = jr.apply(p, jnp.asarray(carry), (jnp.asarray(ins), jnp.asarray(done)))
        ys = out[1] + 0.5 * out[0] if collect else out
        return jnp.sum(ys * w) + jnp.sum(final**2), (final, out)

    (_, (jfinal, jout)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    final, out = tr(torch.tensor(carry), torch.tensor(ins), torch.tensor(done), collect_carries=collect)
    ys = out[1] + 0.5 * out[0] if collect else out
    (torch.sum(ys * torch.tensor(w)) + torch.sum(final**2)).backward()

    np.testing.assert_allclose(final.detach().numpy(), np.asarray(jfinal), **TOL)
    for t_out, j_out in zip(out if collect else [out], jout if collect else [jout]):
        np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **TOL)
    want = {k.removeprefix("rnn."): v for k, v in from_flax_params(
        {"ScannedRNN_0": jax.device_get(jgrads)["params"]}).items()}
    for name, p in tr.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)


def _actor_pair(impl="hoisted"):
    jpre, jpost = _torsos(True)
    ja = jac.RecurrentActor(jpre, jpost, JHead(N_ACT), H, gru_impl=impl)
    tpre, tpost = _torsos(False)
    ta = tac.RecurrentActor(tpre, tpost, DiscreteActionHead(16, N_ACT), H, gru_impl=impl)
    return ja, ta


@pytest.mark.parametrize("impl", ["hoisted", "pallas"])
def test_recurrent_actor_matches_flax(impl):
    view, mask, step, done, carry = _obs(8)
    ja, ta = _actor_pair(impl)
    jx = (_jobs(view, mask, step), jnp.asarray(done))
    params = ja.init(jax.random.PRNGKey(3), jnp.asarray(carry), jx)
    _load(ta, params)
    actions = np.random.default_rng(9).integers(0, N_ACT, (T, E, A))

    def jloss(p):
        h, pi = ja.apply(p, jnp.asarray(carry), jx)
        return jnp.sum(pi.log_prob(jnp.asarray(actions))) + pi.entropy().mean(), (h, pi.logits)

    (jl, (jh, jlogits)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    h, pi = ta(torch.tensor(carry), (_tobs(view, mask, step), torch.tensor(done)))
    loss = pi.log_prob(torch.tensor(actions)).sum() + pi.entropy().mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(pi.logits.detach().numpy(), np.asarray(jlogits), **TOL)
    _assert_grads(ta, jgrads)


@pytest.mark.parametrize("collect", [False, True])
def test_recurrent_value_net_matches_flax(collect):
    view, mask, step, done, carry = _obs(10)
    jpre, jpost = _torsos(True)
    jc = jac.RecurrentValueNet(jpre, jpost, hidden_state_dim=H, collect_carries=collect,
                               gru_impl="hoisted")
    tpre, tpost = _torsos(False)
    tc = tac.RecurrentValueNet(tpre, tpost, H)
    jx = (_jobs(view, mask, step), jnp.asarray(done))
    params = jc.init(jax.random.PRNGKey(4), jnp.asarray(carry), jx)
    _load(tc, params)

    def jloss(p):
        h, out = jc.apply(p, jnp.asarray(carry), jx)
        value = out[1] if collect else out
        return jnp.sum(value**2), (h, out)

    (_, (jh, jout)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    h, out = tc(torch.tensor(carry), (_tobs(view, mask, step), torch.tensor(done)),
                collect_carries=collect)
    value = out[1] if collect else out
    torch.sum(value**2).backward()
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **TOL)
    for t_out, j_out in zip(out if collect else [out], jout if collect else [jout]):
        np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **TOL)
    _assert_grads(tc, jgrads)


def test_init_follows_flax_in_distribution():
    """wh is orthogonal per gate block; wi is lecun-normal (truncated at 2 std,
    variance 1/fan_in); biases are zero."""
    torch.manual_seed(0)
    rnn = tac.ScannedRNN(64, 32)
    for g in range(3):
        block = rnn.wh.detach()[:, g * 32 : (g + 1) * 32]
        np.testing.assert_allclose((block.T @ block).numpy(), np.eye(32), atol=1e-5)
    wi = rnn.wi.detach()
    std = np.sqrt(1.0 / 64) / 0.87962566103423978
    assert wi.abs().max().item() <= 2 * std + 1e-6
    assert abs(wi.std().item() - np.sqrt(1.0 / 64)) < 0.1 * np.sqrt(1.0 / 64)
    assert rnn.bi.abs().sum().item() == 0 and rnn.bhn.abs().sum().item() == 0


def test_resolve_gru_impl():
    assert tac.resolve_gru_impl("auto", torch.device("cpu")) == "hoisted"
    assert tac.resolve_gru_impl(None, torch.device("cuda")) == "pallas"
    assert tac.resolve_gru_impl("cell", torch.device("cuda")) == "cell"
    with pytest.raises(ValueError):
        tac.resolve_gru_impl("triton", torch.device("cpu"))
