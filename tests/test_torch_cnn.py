"""The port's `CNNTorso` and the networks built on it against the flax modules
of `mava_tpu`.

Parameters are made by flax, carried over with `from_flax_params` (loaded
`strict=True`), and both sides get the same numpy inputs with leading dims
(T, E, A). Outputs and parameter gradients must agree to rtol = atol = 1e-5
(fp32; the two sides sum a convolution in different orders). The bf16 mode is
held to flax's bf16 at rtol = atol = 2e-2: both round the input, the kernels
and the biases to bf16 the same way, but each convolution's and LayerNorm's
output is rounded to bf16 (8 bits of mantissa, 2^-8 = 0.4 % a rounding)
after sums accumulated in another order, and two such roundings apart the two
sides can stand a few bf16 ulps apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mava_tpu.networks import actor_critic as jac
from mava_tpu.networks.heads import DiscreteActionHead as JHead
from mava_tpu.networks.torsos import CNNTorso as JCNN
from mava_tpu.networks.torsos import MLPTorso as JMLP
from mava_tpu.types import Observation as JObservation
from mava_tpu.types import ObservationGlobalState as JObservationGlobalState
from mava_tpu_torch.networks import actor_critic as tac
from mava_tpu_torch.networks.factory import make_torso
from mava_tpu_torch.networks.heads import DiscreteActionHead
from mava_tpu_torch.networks.torsos import CNNTorso, MLPTorso, same_padding
from mava_tpu_torch.types import Observation, ObservationGlobalState
from mava_tpu_torch.utils.convert import from_flax_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
T, E, A, H, N_ACT = 3, 2, 3, 16, 5
VIEW = (5, 5, 4)  # rows, cols, channels of one agent's view
STATE = (5, 5, 3)  # the grid global state of Cleaner and MaConnector

# (channels, kernels, strides, activation, layer norm, view): the shipped
# `network=cnn` torso, LayerNorm with tanh, an even kernel, a stride of 2.
CASES = {
    "shipped": ([32, 32], [3, 3], [1, 1], "relu", False, VIEW),
    "layer_norm-tanh": ([8, 6], [3, 3], [1, 1], "tanh", True, VIEW),
    "even_kernel": ([8, 6], [2, 4], [1, 1], "relu", False, (6, 5, 3)),
    "stride_2": ([8, 6], [3, 3], [2, 1], "relu", True, (7, 6, 3)),
}


class _Holder(torch.nn.Module):
    """Gives a lone torso the name its flax parameters carry over to."""

    def __init__(self, torso):
        super().__init__()
        self.torso = torso


def _view(seed, shape=VIEW, lead=(T, E, A)):
    return np.random.default_rng(seed).standard_normal((*lead, *shape)).astype(np.float32)


def _torso_pair(case, dtype="float32"):
    channels, kernels, strides, act, ln, view = CASES[case]
    jt = JCNN(channels, kernels, strides, act, ln, compute_dtype=dtype)
    tt = CNNTorso(view, channels, kernels, strides, act, ln, compute_dtype=dtype)
    return jt, tt, view


def _load(module, flax_params):
    module.load_state_dict(from_flax_params(jax.device_get(flax_params)), strict=True)
    return module


def _assert_grads(module, flax_grads, tol=TOL):
    want = from_flax_params(jax.device_get(flax_grads))
    got = {n: p.grad for n, p in module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cnn_torso_matches_flax(case):
    jt, tt, view = _torso_pair(case)
    x = _view(1, view)
    params = jt.init(jax.random.PRNGKey(0), x)
    holder = _load(_Holder(tt), {"torso": params["params"]})
    # A mean over the leading dims, as the losses take one.
    w = np.random.default_rng(2).standard_normal((T, E, A, tt.out_features)).astype(np.float32)
    w /= T * E * A
    jgrads = jax.grad(lambda p: jnp.sum(jt.apply(p, x) * w))(params)
    y = tt(torch.tensor(x))
    assert y.shape == (T, E, A, tt.out_features) and y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jt.apply(params, x)), **TOL)
    torch.sum(y * torch.tensor(w)).backward()
    _assert_grads(holder, {"torso": jgrads["params"]})


@pytest.mark.parametrize("size,kernel,stride", [(5, 3, 1), (6, 2, 1), (6, 4, 1), (7, 3, 2),
                                                (8, 3, 2), (5, 1, 3)])
def test_same_padding_is_xlas(size, kernel, stride):
    """The padding and output size agree with `jax.lax`'s "SAME" rule."""
    ((low, high),) = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert same_padding(size, kernel, stride) == (low, high, -(-size // stride))


def test_out_features_follow_the_strides():
    tt = CNNTorso((7, 6, 3), [8, 6], [3, 3], [2, 1])
    assert tt.out_shape == (4, 3, 6) and tt.out_features == 72


@pytest.mark.parametrize("case", ["shipped", "layer_norm-tanh"])
def test_bf16_mode_matches_flax_bf16(case):
    """Parameters stay float32, the output is float32, and it is flax's bf16
    output within the bf16 tolerance (module docstring); it is not the fp32
    output, so the mode is really on."""
    jt, tt, view = _torso_pair(case, "bfloat16")
    x = _view(3, view)
    params = jt.init(jax.random.PRNGKey(1), x)
    holder = _load(_Holder(tt), {"torso": params["params"]})
    assert all(p.dtype == torch.float32 for p in tt.parameters())
    w = np.random.default_rng(4).standard_normal((T, E, A, tt.out_features)).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(jt.apply(p, x) * w))(params)
    y = tt(torch.tensor(x))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jt.apply(params, x)), **BF16_TOL)
    torch.sum(y * torch.tensor(w)).backward()
    assert all(p.grad.dtype == torch.float32 for p in tt.parameters())
    # A gradient sums bf16 cotangents over every position of every sample, and
    # bf16 itself moves these gradients 1-9 % from their fp32 values on either
    # side. A bias's sum is where the two differ most: XLA reduces it in bf16,
    # PyTorch accumulates it in fp32 (2-3 % apart here). So each gradient is
    # held as a whole, to 5e-2 of its norm.
    want = from_flax_params(jax.device_get({"torso": jgrads["params"]}))
    for name, p in holder.named_parameters():
        err = torch.linalg.vector_norm(p.grad - want[name]) / torch.linalg.vector_norm(want[name])
        assert err.item() <= 5e-2, (name, err.item())
    fp32 = CNNTorso(view, *CASES[case][:5])
    fp32.load_state_dict(tt.state_dict())
    assert not torch.equal(fp32(torch.tensor(x)), y)


def test_cnn_init_follows_flax_in_distribution():
    """flax's default conv kernel init: lecun_normal on fan_in = kh * kw * in
    (a normal truncated at 2 std, variance 1/fan_in); biases zero."""
    torch.manual_seed(0)
    tt = CNNTorso((6, 6, 32), [64, 8], [3, 1], [1, 1], use_layer_norm=True)
    w = tt.convs[0].weight.detach()
    fan_in = 3 * 3 * 32
    std = np.sqrt(1.0 / fan_in)
    assert w.shape == (64, 32, 3, 3)
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(w.std().item() - std) < 0.05 * std
    assert abs(w.mean().item()) < 0.05 * std
    assert all(c.bias.abs().sum().item() == 0 for c in tt.convs)
    assert all(b.abs().sum().item() == 0 for b in tt.norm_biases)


def test_make_torso_takes_shapes():
    cnn = make_torso({"type": "CNNTorso", "channel_sizes": [4], "kernel_sizes": [3],
                      "strides": [1], "activation": "relu", "use_layer_norm": False,
                      "compute_dtype": "bfloat16"}, (5, 4, 2))
    assert isinstance(cnn, CNNTorso) and cnn.out_features == 80
    assert cnn.compute_dtype == torch.bfloat16
    mlp = {"type": "MLPTorso", "layer_sizes": [8]}
    assert make_torso(mlp, 6).layers[0].in_features == 6
    assert make_torso(mlp, (6,)).layers[0].in_features == 6
    with pytest.raises(ValueError, match="vector inputs"):
        make_torso(mlp, VIEW)
    with pytest.raises(ValueError, match="rows, cols, channels"):
        make_torso({"type": "CNNTorso", "channel_sizes": [4], "kernel_sizes": [3],
                    "strides": [1]}, (6,))


# ------------------------------------------------------------------ networks
def _obs(seed, global_state=False):
    rng = np.random.default_rng(seed)
    view = rng.random((T, E, A, *VIEW)).astype(np.float32)
    mask = rng.random((T, E, A, N_ACT)) < 0.7
    mask[..., 0] = True
    step = np.zeros((T, E, A), np.int32)
    done = rng.random((T, E, A)) < 0.3
    carry = rng.standard_normal((E, A, H)).astype(np.float32)
    state = rng.random((T, E, A, *STATE)).astype(np.float32)
    jobs = JObservationGlobalState(*(jnp.asarray(x) for x in (view, mask, state, step)))
    tobs = ObservationGlobalState(*(torch.tensor(x) for x in (view, mask, state, step)))
    if not global_state:
        jobs = JObservation(jobs.agents_view, jobs.action_mask, jobs.step_count)
        tobs = Observation(tobs.agents_view, tobs.action_mask, tobs.step_count)
    return jobs, tobs, done, carry


def _cnn(shape, jax_side):
    args = ([8, 8], [3, 3], [1, 1])
    return JCNN(*args) if jax_side else CNNTorso(shape, *args)


def test_feedforward_actor_and_value_net_with_cnn_match_flax():
    """`network=cnn`: the actor on the agent's view, the centralised critic on
    the grid global state."""
    jobs, tobs, _, _ = _obs(5, global_state=True)
    actions = np.random.default_rng(6).integers(0, N_ACT, (T, E, A))
    ja = jac.FeedForwardActor(_cnn(VIEW, True), JHead(N_ACT))
    tpre = _cnn(VIEW, False)
    ta = tac.FeedForwardActor(tpre, DiscreteActionHead(tpre.out_features, N_ACT))
    params = ja.init(jax.random.PRNGKey(5), jobs)
    _load(ta, params)

    def jloss(p):
        pi = ja.apply(p, jobs)
        return jnp.sum(pi.log_prob(jnp.asarray(actions))) + pi.entropy().mean(), pi.logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    pi = ta(tobs)
    loss = pi.log_prob(torch.tensor(actions)).sum() + pi.entropy().mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(pi.logits.detach().numpy(), np.asarray(jlogits), **TOL)
    _assert_grads(ta, jgrads)

    jc = jac.FeedForwardValueNet(_cnn(STATE, True), centralised_critic=True)
    tc = tac.FeedForwardValueNet(_cnn(STATE, False), centralised_critic=True)
    params = jc.init(jax.random.PRNGKey(6), jobs)
    _load(tc, params)
    jvalue, jgrads = jax.value_and_grad(lambda p: jnp.sum(jc.apply(p, jobs) ** 2))(params)
    value = tc(tobs)
    assert value.shape == (T, E, A)
    torch.sum(value**2).backward()
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jc.apply(params, jobs)), **TOL)
    _assert_grads(tc, jgrads)


@pytest.mark.parametrize("impl", ["hoisted", "pallas"])
def test_recurrent_actor_and_centralised_critic_with_rcnn_match_flax(impl):
    """`network=rcnn`: CNN pre-torso -> GRU (the op's plain versions on CPU
    tensors with "pallas", the Pallas kernel in interpret mode on the JAX
    side) -> MLP post-torso; the critic centralised on the grid state."""
    jobs, tobs, done, carry = _obs(7, global_state=True)
    actions = np.random.default_rng(8).integers(0, N_ACT, (T, E, A))
    jx, tx = (jobs, jnp.asarray(done)), (tobs, torch.tensor(done))

    ja = jac.RecurrentActor(_cnn(VIEW, True), JMLP([16]), JHead(N_ACT), H, gru_impl=impl)
    ta = tac.RecurrentActor(_cnn(VIEW, False), MLPTorso(H, [16]), DiscreteActionHead(16, N_ACT),
                            H, gru_impl=impl)
    params = ja.init(jax.random.PRNGKey(3), jnp.asarray(carry), jx)
    _load(ta, params)

    def jloss(p):
        h, pi = ja.apply(p, jnp.asarray(carry), jx)
        return jnp.sum(pi.log_prob(jnp.asarray(actions))) + pi.entropy().mean(), (h, pi.logits)

    (jl, (jh, jlogits)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    h, pi = ta(torch.tensor(carry), tx)
    loss = pi.log_prob(torch.tensor(actions)).sum() + pi.entropy().mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(pi.logits.detach().numpy(), np.asarray(jlogits), **TOL)
    _assert_grads(ta, jgrads)

    jc = jac.RecurrentValueNet(_cnn(STATE, True), JMLP([16]), hidden_state_dim=H,
                               centralised_critic=True, collect_carries=True, gru_impl=impl)
    tc = tac.RecurrentValueNet(_cnn(STATE, False), MLPTorso(H, [16]), H, impl,
                               centralised_critic=True)
    params = jc.init(jax.random.PRNGKey(4), jnp.asarray(carry), jx)
    _load(tc, params)

    def jvalue_loss(p):
        h, (carries, value) = jc.apply(p, jnp.asarray(carry), jx)
        return jnp.sum(value**2) + jnp.sum(carries), (h, value)

    (_, (jh, jvalue)), jgrads = jax.value_and_grad(jvalue_loss, has_aux=True)(params)
    h, (carries, value) = tc(torch.tensor(carry), tx, collect_carries=True)
    (torch.sum(value**2) + torch.sum(carries)).backward()
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jvalue), **TOL)
    _assert_grads(tc, jgrads)
