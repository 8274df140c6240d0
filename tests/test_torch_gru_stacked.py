"""The port's stacked GRU op (`gru_sequence_stacked`, its forward and backward)
against `jax.vmap` of the JAX Pallas kernel (`mava_tpu/ops/pallas_gru.py`,
interpret mode on the CPU) and of its VJP, which is what the JAX package runs
when a whole recurrent learner is vmapped over seeds
(`mava_tpu/advanced_usage/rec_ippo_vmap_seeds.py:181`).

On CPU tensors the stacked op runs the plain versions entry by entry; the
stacked CUDA kernels are held to those on the card (`test_torch_gru_cuda.py`,
`chip_smoke.py`). S = 3 entries, with a keep per entry and with one shared:
forward to 1e-6, gradients to rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mava_tpu.ops.pallas_gru import gru_sequence as jax_gru_sequence
from mava_tpu_torch.ops import gru

torch.set_num_threads(1)
S = 3


def _inputs(t_len, b, h, seed, per_entry_keep=True, reset_p=0.3):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lead = (S,) if per_entry_keep else ()
    resets = rng.random((*lead, t_len, b)) < reset_p
    keep = np.broadcast_to(1.0 - resets[..., None].astype(np.float32), (*lead, t_len, b, h))
    args = (f32(S, t_len, b, 3 * h), keep, f32(S, b, h), f32(S, h, 3 * h) / np.sqrt(h),
            0.1 * f32(S, h))
    return tuple(np.ascontiguousarray(a, dtype=np.float32) for a in args)


def _keep_axis(args):
    return 0 if args[1].ndim == 4 else None


@pytest.mark.parametrize("per_entry_keep", [True, False], ids=["per-entry-keep", "shared-keep"])
@pytest.mark.parametrize("t_len,b,h", [(6, 4, 8), (5, 7, 16), (1, 3, 8)])
def test_stacked_forward_matches_jax_vmap(t_len, b, h, per_entry_keep):
    args = _inputs(t_len, b, h, seed=t_len + 10 * b + h, per_entry_keep=per_entry_keep)
    hs = gru.gru_sequence_stacked(*[torch.tensor(a) for a in args]).numpy()
    vmapped = jax.vmap(jax_gru_sequence, in_axes=(0, _keep_axis(args), 0, 0, 0))
    np.testing.assert_allclose(hs, np.asarray(vmapped(*[jnp.asarray(a) for a in args])),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("per_entry_keep", [True, False], ids=["per-entry-keep", "shared-keep"])
@pytest.mark.parametrize("t_len,b,h,reset_p", [(6, 4, 8, 0.3), (5, 7, 16, 0.5), (4, 2, 8, 1.0)],
                         ids=["resets", "ragged-rows", "all-reset"])
def test_stacked_backward_matches_jax_vmap_of_vjp(t_len, b, h, reset_p, per_entry_keep):
    args = _inputs(t_len, b, h, seed=100 + t_len * b, per_entry_keep=per_entry_keep,
                   reset_p=reset_p)
    w = np.arange(1, S * t_len * b * h + 1, dtype=np.float32).reshape(S, t_len, b, h)
    w /= w.size

    targs = [torch.tensor(a, requires_grad=i != 1) for i, a in enumerate(args)]
    hs = gru.gru_sequence_stacked(*targs)
    g_hs = torch.cos(hs.detach()) * torch.tensor(w)  # d sum(sin(hs) * w) / d hs
    hs.backward(g_hs)
    assert targs[1].grad is None  # keep is the reset mask: no gradient

    def entry_vjp(g, keep, h0, wh, bhn, cot):
        _, vjp = jax.vjp(lambda *p: jax_gru_sequence(p[0], keep, *p[1:]), g, h0, wh, bhn)
        return vjp(cot)

    jgrads = jax.vmap(entry_vjp, in_axes=(0, _keep_axis(args), 0, 0, 0, 0))(
        *[jnp.asarray(a) for a in args], jnp.asarray(g_hs.numpy()))
    for tg, jg, name in zip([targs[i].grad for i in (0, 2, 3, 4)], jgrads,
                            ("dgates_i", "dh0", "dWh", "db_hn")):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6, err_msg=name)


def test_stacked_backward_is_each_entrys_backward():
    """Entry s of the stacked backward is the unstacked backward of entry s,
    bitwise (the plain versions), and the stacked plain kernels K2p, K2a and K2b
    one by one are the unstacked ones entry by entry."""
    args = [torch.tensor(a) for a in _inputs(7, 5, 16, seed=3)]
    hs = gru.gru_sequence_stacked_forward(*args)
    g_hs = torch.sin(hs)
    grads = gru.gru_sequence_stacked_backward(*args, hs, g_hs)
    gates = gru.gru_backward_gates_stacked(*args, hs)
    dgates, dgh, dh0 = gru.gru_backward_recurrence_stacked(*args, hs, g_hs, gates)
    split = gru.reduce_split(7, 5, 16)
    partials = gru.gru_backward_reduce_partials_stacked(args[1], args[2], hs, dgh)
    dwh, dbhn = gru.gru_backward_reduce_sum_stacked(partials, 16)
    for s in range(S):
        entry = [a[s] for a in args]
        want = gru.gru_sequence_backward(*entry, hs[s], g_hs[s])
        assert all(torch.equal(g[s], w) for g, w in zip(grads, want))
        gates_s = gru.gru_backward_gates(*entry, hs[s])
        assert torch.equal(gates[s], gates_s)
        rec = gru.gru_backward_recurrence(*entry, hs[s], g_hs[s], gates_s)
        assert all(torch.equal(g[s], w) for g, w in zip((dgates, dgh, dh0), rec))
        assert torch.equal(partials[s], gru.gru_backward_reduce_partials(
            entry[1], entry[2], hs[s], rec[1]))
        assert split.slices == partials.shape[1]
        for g, w in zip((dwh, dbhn), gru.gru_backward_reduce_sum(partials[s], 16)):
            assert torch.equal(g[s], w)
    torch.testing.assert_close(dwh, grads[2], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dbhn, grads[3], rtol=1e-5, atol=1e-6)


def test_stacked_op_has_a_gradient_and_counts_no_cpu_launches():
    """Asking the stacked op for a gradient no longer raises; on CPU tensors the
    plain versions run and no kernel launch is counted."""
    args = [torch.tensor(a, requires_grad=i != 1)
            for i, a in enumerate(_inputs(4, 3, 8, seed=1))]
    gru.reset_launch_counts()
    gru.gru_sequence_stacked(*args).sum().backward()
    assert all(args[i].grad is not None for i in (0, 2, 3, 4))
    assert all(v == 0 for v in gru.kernel_launches.values())
    assert {"bwd_gates_stacked", "bwd_recurrence_stacked", "bwd_reduce_stacked",
            "bwd_reduce_sum_stacked"} <= set(gru.kernel_launches)


@pytest.mark.parametrize("bad", ["keep", "h0", "stack"])
def test_stacked_shapes_are_checked(bad):
    args = [torch.tensor(a) for a in _inputs(4, 3, 8, seed=2)]
    if bad == "keep":
        args[1] = args[1][:2]  # a keep for 2 of the 3 entries
    elif bad == "h0":
        args[2] = args[2][:, :2]
    else:
        args[3] = args[3][:2]
    with pytest.raises(ValueError, match="has shape"):
        gru.gru_sequence_stacked(*args)


@pytest.mark.parametrize("kernel", ["bwd_gates", "bwd_recurrence", "bwd_reduce", "fwd"])
def test_stacked_bound_is_stack_times_the_unstacked(kernel):
    """`chip_smoke.bound_ms(..., stack=S)` of a stacked kernel with a keep per
    entry is S times the unstacked work; K1 with a shared keep reads it once."""
    name = kernel + "_stacked"
    flop, nbytes = chip_smoke.kernel_work(kernel, 128, 64, 128)
    assert chip_smoke.kernel_work(name, 128, 64, 128, stack=4, shared_keep=False) == \
        (4 * flop, 4 * nbytes)
    shared = chip_smoke.kernel_work(name, 128, 64, 128, stack=4)
    assert shared[1] == 4 * nbytes - (3 * 4 * 128 * 64 * 128 if kernel == "fwd" else 0)
