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
from mava_tpu.types import ObservationGlobalState as JObservationGlobalState
from mava_tpu_torch import distributions as tdist
from mava_tpu_torch.networks import actor_critic as tac
from mava_tpu_torch.networks.heads import DiscreteActionHead
from mava_tpu_torch.networks.torsos import MLPTorso
from mava_tpu_torch.types import Observation, ObservationGlobalState
from mava_tpu_torch.utils.convert import from_flax_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
T, E, A, F, H, N_ACT = 5, 3, 2, 6, 16, 5
G = A * F  # width of the global state


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


def _global_state(seed, t=T):
    return np.random.default_rng(seed).standard_normal((t, E, A, G)).astype(np.float32)


def _jobs_global(view, mask, step, global_state):
    return JObservationGlobalState(
        jnp.asarray(view), jnp.asarray(mask), jnp.asarray(global_state), jnp.asarray(step))


def _tobs_global(view, mask, step, global_state):
    return ObservationGlobalState(
        torch.tensor(view), torch.tensor(mask), torch.tensor(global_state), torch.tensor(step))


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


@pytest.mark.parametrize("activation", ["relu", "tanh"])
def test_layer_norm_torso_matches_flax(activation):
    """flax `LayerNorm(use_scale=False)`: a bias and no scale, epsilon 1e-6,
    between Dense and activation. Outputs and parameter gradients."""
    rng = np.random.default_rng(20)
    x = (3.0 * rng.standard_normal((4, 3, F))).astype(np.float32)
    w = rng.standard_normal((4, 3, 8)).astype(np.float32)
    jt = JTorso([16, 8], activation, use_layer_norm=True)
    params = jt.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # Biases away from their zero init, so that they are seen to be applied.
    params = jax.tree.map(lambda p: p + 0.1 * rng.standard_normal(p.shape).astype(np.float32), params)
    assert set(params["params"]) == {"Dense_0", "LayerNorm_0", "Dense_1", "LayerNorm_1"}
    assert set(params["params"]["LayerNorm_0"]) == {"bias"}
    tt = MLPTorso(F, [16, 8], activation, use_layer_norm=True)
    strip = lambda tree: {k.removeprefix("torso."): v for k, v in from_flax_params(  # noqa: E731
        {"torso": jax.device_get(tree)["params"]}).items()}
    tt.load_state_dict(strip(params), strict=True)
    jout, jgrads = jax.value_and_grad(
        lambda p: jnp.sum(jt.apply(p, jnp.asarray(x)) * w))(params)
    out = tt(torch.tensor(x))
    loss = torch.sum(out * torch.tensor(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jout), **TOL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jt.apply(params, jnp.asarray(x))), **TOL)
    want = strip(jgrads)
    assert set(want) == {n for n, _ in tt.named_parameters()}
    for name, p in tt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **TOL)


def test_from_flax_params_rejects_a_layer_norm_with_a_scale():
    jt = jac.nn.LayerNorm()
    params = jax.device_get(jt.init(jax.random.PRNGKey(0), jnp.ones((2, 4))))["params"]
    with pytest.raises(KeyError, match="LayerNorm_0"):
        from_flax_params({"torso": {"LayerNorm_0": params}})


@pytest.mark.parametrize("layer_norm", [False, True])
def test_feedforward_actor_matches_flax(layer_norm):
    view, mask, step, _, _ = _obs(21)
    ja = jac.FeedForwardActor(JTorso([16, 16], use_layer_norm=layer_norm), JHead(N_ACT))
    ta = tac.FeedForwardActor(MLPTorso(F, [16, 16], use_layer_norm=layer_norm),
                              DiscreteActionHead(16, N_ACT))
    params = ja.init(jax.random.PRNGKey(5), _jobs(view, mask, step))
    _load(ta, params)
    actions = np.random.default_rng(22).integers(0, N_ACT, (T, E, A))

    def jloss(p):
        pi = ja.apply(p, _jobs(view, mask, step))
        return jnp.sum(pi.log_prob(jnp.asarray(actions))) + pi.entropy().mean(), pi.logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    pi = ta(_tobs(view, mask, step))
    loss = pi.log_prob(torch.tensor(actions)).sum() + pi.entropy().mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(pi.logits.detach().numpy(), np.asarray(jlogits), **TOL)
    _assert_grads(ta, jgrads)


@pytest.mark.parametrize("centralised", [False, True])
def test_feedforward_value_net_matches_flax(centralised):
    view, mask, step, _, _ = _obs(23)
    global_state = _global_state(24)
    jc = jac.FeedForwardValueNet(JTorso([16, 16]), centralised_critic=centralised)
    tc = tac.FeedForwardValueNet(MLPTorso(G if centralised else F, [16, 16]), centralised)
    jobs = _jobs_global(view, mask, step, global_state)
    params = jc.init(jax.random.PRNGKey(6), jobs)
    _load(tc, params)
    w = np.random.default_rng(25).standard_normal((T, E, A)).astype(np.float32)
    jvalue, jgrads = jax.value_and_grad(
        lambda p: jnp.sum(jc.apply(p, jobs) ** 2 * w), has_aux=False)(params)
    value = tc(_tobs_global(view, mask, step, global_state))
    assert value.shape == (T, E, A)
    torch.sum(value**2 * torch.tensor(w)).backward()
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jc.apply(params, jobs)), **TOL)
    _assert_grads(tc, jgrads)


@pytest.mark.parametrize("collect", [False, True])
def test_centralised_recurrent_value_net_matches_flax(collect):
    view, mask, step, done, carry = _obs(26)
    global_state = _global_state(27)
    jpre, jpost = _torsos(True)
    jc = jac.RecurrentValueNet(jpre, jpost, centralised_critic=True, hidden_state_dim=H,
                               collect_carries=collect, gru_impl="hoisted")
    tc = tac.RecurrentValueNet(MLPTorso(G, [16]), MLPTorso(H, [16]), H, centralised_critic=True)
    jx = (_jobs_global(view, mask, step, global_state), jnp.asarray(done))
    params = jc.init(jax.random.PRNGKey(7), jnp.asarray(carry), jx)
    _load(tc, params)

    def jloss(p):
        h, out = jc.apply(p, jnp.asarray(carry), jx)
        value = out[1] if collect else out
        return jnp.sum(value**2), (h, out)

    (_, (jh, jout)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    h, out = tc(torch.tensor(carry),
                (_tobs_global(view, mask, step, global_state), torch.tensor(done)),
                collect_carries=collect)
    value = out[1] if collect else out
    torch.sum(value**2).backward()
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **TOL)
    for t_out, j_out in zip(out if collect else [out], jout if collect else [jout]):
        np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), **TOL)
    _assert_grads(tc, jgrads)


@pytest.mark.parametrize("kind", ["feedforward", "recurrent"])
def test_centralised_critics_need_a_global_state(kind):
    """On a plain `Observation` both sides raise the same error."""
    view, mask, step, done, carry = _obs(28)
    if kind == "feedforward":
        tcall = lambda: tac.FeedForwardValueNet(MLPTorso(G, [16]), True)(_tobs(view, mask, step))  # noqa: E731
        jnet = jac.FeedForwardValueNet(JTorso([16]), centralised_critic=True)
        jcall = lambda: jnet.init(jax.random.PRNGKey(0), _jobs(view, mask, step))  # noqa: E731
    else:
        tnet = tac.RecurrentValueNet(MLPTorso(G, [16]), MLPTorso(H, [16]), H, centralised_critic=True)
        tcall = lambda: tnet(torch.tensor(carry), (_tobs(view, mask, step), torch.tensor(done)))  # noqa: E731
        jnet = jac.RecurrentValueNet(*_torsos(True), centralised_critic=True, hidden_state_dim=H)
        jcall = lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(carry),  # noqa: E731
                                  (_jobs(view, mask, step), jnp.asarray(done)))
    for call in (tcall, jcall):
        with pytest.raises(ValueError, match="Centralised critic requires a global state."):
            call()


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
