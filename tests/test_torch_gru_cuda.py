"""The GRU kernels (`mava_tpu_torch/csrc/gru_sequence.cu`) against their plain
PyTorch versions, on a CUDA device.

This file imports neither JAX nor `mava_tpu`, so it also runs where JAX is not
installed; `tests/conftest.py` imports JAX, so there run it without conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gru_cuda.py -q

Without a CUDA device the tests skip: the kernels have no CPU mode.
"""

import numpy as np
import pytest
import torch

from mava_tpu_torch.ops import gru

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu
TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 vs fp32, different summation order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the GRU kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(t_len, b, h, seed, device, reset_p=0.2):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    keep = np.broadcast_to((rng.random((t_len, b, 1)) >= reset_p).astype(np.float32), (t_len, b, h))
    args = (f32(t_len, b, 3 * h), keep, f32(b, h), f32(h, 3 * h) / np.sqrt(h), 0.1 * f32(h))
    args = [torch.tensor(np.ascontiguousarray(a, dtype=np.float32), device=device) for a in args]
    return args, torch.tensor(f32(t_len, b, h), device=device)


SHAPES = [(128, 16, 128), (128, 32, 128), (7, 5, 128), (9, 3, 256), (1, 1, 8),
          (33, 17, 128), (5, 40, 256), (6, 4, 72), (3, 2, 512)]


@pytest.mark.parametrize("reset_p", [0.2, 0.0], ids=["resets", "keep1"])
@pytest.mark.parametrize("t_len,b,h", SHAPES)
def test_kernels_match_plain_versions(cuda, t_len, b, h, reset_p):
    args, g_hs = _inputs(t_len, b, h, seed=b, device=cuda, reset_p=reset_p)
    before = (gru.fwd_launches, gru.bwd_launches)
    hs = gru.gru_sequence_forward(*args)
    torch.testing.assert_close(hs, gru.gru_sequence_reference(*args), **TOL)
    got = gru.gru_sequence_backward(*args, hs, g_hs)
    want = gru.gru_sequence_backward_reference(*args, hs, g_hs)
    for name, g, w in zip(("dgates_i", "dh0", "dWh", "db_hn"), got, want):
        torch.testing.assert_close(g, w, **TOL, msg=name)
    # No atomics and a fixed order of every sum: bitwise the same from run to run.
    again = gru.gru_sequence_backward(*args, hs, g_hs)
    for name, g, a in zip(("dgates_i", "dh0", "dWh", "db_hn"), got, again):
        assert torch.equal(a, g), name
    assert (gru.fwd_launches, gru.bwd_launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("t_len,b,h", SHAPES)
def test_route_taken_and_its_passes(cuda, monkeypatch, t_len, b, h):
    """The library has resident kernels exactly where `kernel_route` says so, and
    K2p and K2a match their plain versions pass by pass; the streaming kernels
    take every shape."""
    route = gru.kernel_route(t_len, b, h)
    built = gru.built_route(h)
    if route.route == "resident":
        assert built == (route.cluster, route.fwd_threads, route.fwd_smem, route.bwd_threads,
                         route.bwd_smem)
    else:
        assert built is None
    args, g_hs = _inputs(t_len, b, h, seed=t_len, device=cuda)
    hs = gru.gru_sequence_reference(*args)
    gates = gru.gru_backward_gates_reference(*args, hs)
    torch.testing.assert_close(gru.gru_backward_gates(*args, hs), gates, **TOL)
    counts = dict(gru.kernel_launches)
    got = gru.gru_backward_recurrence(*args, hs, g_hs, gates)
    want = gru.gru_backward_recurrence_reference(gates, args[1], args[2], args[3], hs, g_hs)
    for name, g, w in zip(("dgates_i", "dgh", "dh0"), got, want):
        torch.testing.assert_close(g, w, **TOL, msg=name)
    assert gru.kernel_launches["bwd_recurrence"] == counts["bwd_recurrence"] + 1
    assert gru.kernel_launches["bwd_gates"] == counts["bwd_gates"]
    monkeypatch.setattr(gru, "forced_route", gru.STREAMING)
    torch.testing.assert_close(gru.gru_sequence_forward(*args), hs, **TOL)
    streamed = gru.gru_sequence_backward(*args, hs, g_hs)
    for g, w in zip(streamed, gru.gru_sequence_backward_reference(*args, hs, g_hs)):
        torch.testing.assert_close(g, w, **TOL)


TILE_SHAPES = [(128, 256, 128), (128, 64, 256)]


@pytest.mark.parametrize("slices", ["rule", "one", "more-than-chunks"])
@pytest.mark.parametrize("t_len,b,h", TILE_SHAPES + [(33, 17, 72)])
def test_tile_kernels_with_many_rows(cuda, t_len, b, h, slices):
    """K2p and K2b (each of its kernels, and both) against their plain versions
    where T*B is 4x and 16x the slice's, for K2b's own row split, for one slice
    and for more slices than chunks of rows; dWh and db_hn bitwise equal over
    three runs."""
    chunks = -(-t_len * b // gru.REDUCE_CHUNK)
    slices = {"rule": None, "one": 1, "more-than-chunks": chunks + 3}[slices]
    args, g_hs = _inputs(t_len, b, h, seed=b, device=cuda)
    hs = gru.gru_sequence_forward(*args)
    gates = gru.gru_backward_gates_reference(*args, hs)
    torch.testing.assert_close(gru.gru_backward_gates(*args, hs), gates, **TOL)
    if gru.kernel_route(t_len, b, h).route == "resident":
        dgh = gru.gru_backward_recurrence(*args, hs, g_hs, gates)[1]
    else:
        dgh = gru.gru_backward_recurrence_reference(gates, args[1], args[2], args[3], hs, g_hs)[1]
    counts = dict(gru.kernel_launches)
    split = gru.reduce_split(t_len, b, h, slices)
    # A slice is one running fp32 sum, whose rounding error grows with its length:
    # the rule's slices (at most 1024 rows here) are held to TOL, a forced single
    # slice over 16x the rows of the slice's shapes gets 16x the room.
    tol = dict(rtol=1e-4, atol=1e-4 * max(1.0, min(t_len * b, split.rows_per_slice) / 2048))
    assert slices is not None or tol == TOL
    partials = gru.gru_backward_reduce_partials(args[1], args[2], hs, dgh, slices)
    want = gru.gru_backward_reduce_partials_reference(args[1], args[2], hs, dgh, split)
    torch.testing.assert_close(partials, want, **tol)
    for g, w in zip(gru.gru_backward_reduce_sum(want, h),
                    gru.gru_backward_reduce_sum_reference(want, h)):
        torch.testing.assert_close(g, w, **TOL)
    runs = [gru.gru_backward_reduce(args[1], args[2], hs, dgh, slices) for _ in range(3)]
    for name, g, w in zip(("dWh", "db_hn"), runs[0],
                          gru.gru_backward_reduce_reference(args[1], args[2], hs, dgh)):
        torch.testing.assert_close(g, w, **tol, msg=name)
    for run in runs[1:]:
        assert all(torch.equal(a, g) for a, g in zip(run, runs[0]))
    assert gru.kernel_launches["bwd_reduce"] == counts["bwd_reduce"] + 4
    assert gru.kernel_launches["bwd_reduce_sum"] == counts["bwd_reduce_sum"] + 4


def test_reduce_config_matches_the_library(cuda):
    assert gru.built_reduce_config() == (gru.REDUCE_TILE, gru.REDUCE_CHUNK)


def test_autograd_through_kernels(cuda):
    args, g_hs = _inputs(16, 6, 32, seed=1, device=cuda)
    leaves = [a.clone().requires_grad_(i != 1) for i, a in enumerate(args)]
    (gru.gru_sequence(*leaves) * g_hs).sum().backward()
    ref = [a.clone().requires_grad_(i != 1) for i, a in enumerate(args)]
    (gru.gru_sequence_reference(*ref) * g_hs).sum().backward()
    assert leaves[1].grad is None
    for i in (0, 2, 3, 4):
        torch.testing.assert_close(leaves[i].grad, ref[i].grad, **TOL)


def test_cuda_wrapper_rejects_bad_inputs(cuda):
    args, _ = _inputs(4, 3, 8, seed=2, device=cuda)
    with pytest.raises(ValueError):
        gru.gru_sequence_forward(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(TypeError):
        gru.gru_sequence_forward(args[0].double(), *args[1:])


def _stacked_inputs(stack, t_len, b, h, seed, device):
    """Per-entry gates_i, h0, Wh and b_hn stacked on a leading axis, one shared keep."""
    entries = [_inputs(t_len, b, h, seed=seed + s, device=device)[0] for s in range(stack)]
    stacked = [torch.stack([e[i] for e in entries]).contiguous() for i in (0, 2, 3, 4)]
    return stacked[0], entries[0][1], stacked[1], stacked[2], stacked[3]


# rec-IQL's target pass (S=2, T=20, B=256: 32 sequences x 8 agents), a ragged B and
# the streaming route.
STACKED_SHAPES = [(2, 20, 256, 128), (2, 20, 37, 128), (3, 9, 5, 64), (2, 6, 11, 72)]


@pytest.mark.parametrize("stack,t_len,b,h", STACKED_SHAPES)
def test_stacked_forward_matches_plain_version(cuda, stack, t_len, b, h):
    args = _stacked_inputs(stack, t_len, b, h, seed=b, device=cuda)
    counts = dict(gru.kernel_launches)
    fwd_calls = gru.fwd_launches
    hs = gru.gru_sequence_stacked(*args)
    torch.cuda.synchronize()
    assert hs.shape == (stack, t_len, b, h)
    torch.testing.assert_close(hs, gru.gru_sequence_stacked_reference(*args), **TOL)
    assert gru.kernel_launches["fwd_stacked"] == counts["fwd_stacked"] + 1
    assert gru.kernel_launches["fwd"] == counts["fwd"] and gru.fwd_launches == fwd_calls


@pytest.mark.parametrize("route", ["resident", "streaming"])
def test_stacked_forward_on_both_routes(cuda, monkeypatch, route):
    """The resident shape of the target pass, forced onto the streaming kernels too."""
    if route == "streaming":
        monkeypatch.setattr(gru, "forced_route", gru.STREAMING)
    args = _stacked_inputs(2, 20, 40, 128, seed=3, device=cuda)
    torch.testing.assert_close(gru.gru_sequence_stacked(*args),
                               gru.gru_sequence_stacked_reference(*args), **TOL)


@pytest.mark.parametrize("route", ["resident", "streaming"])
@pytest.mark.parametrize("t_len,b,h", [(20, 256, 128), (7, 5, 128), (6, 4, 72)])
def test_stack_of_one_is_the_unstacked_kernel_bitwise(cuda, monkeypatch, route, t_len, b, h):
    if route == "streaming":
        monkeypatch.setattr(gru, "forced_route", gru.STREAMING)
    args = _stacked_inputs(1, t_len, b, h, seed=t_len, device=cuda)
    stacked = gru.gru_sequence_stacked(*args)
    plain_args = (args[0][0], args[1], args[2][0], args[3][0], args[4][0])
    assert torch.equal(stacked[0], gru.gru_sequence_forward(*plain_args))
    # Entry s of a stack is entry s alone: the other entries do not reach it.
    two = _stacked_inputs(2, t_len, b, h, seed=t_len, device=cuda)
    assert torch.equal(gru.gru_sequence_stacked(*two)[0], stacked[0])


def test_stacked_op_has_a_gradient_and_checks_inputs(cuda):
    """The stacked op differentiates through the stacked backward kernels (it was
    forward-only before the seed programs), and checks its inputs' shapes."""
    args = [a.clone().requires_grad_(i != 1)
            for i, a in enumerate(_stacked_inputs(2, 5, 3, 64, seed=1, device=cuda))]
    counts = dict(gru.kernel_launches)
    hs = gru.gru_sequence_stacked(*args)
    hs.sum().backward()
    want = gru.gru_sequence_stacked_backward_reference(
        *[a.detach() for a in args], hs.detach(), torch.ones_like(hs))
    for got, w in zip([args[i].grad for i in (0, 2, 3, 4)], want):
        torch.testing.assert_close(got, w, **TOL)
    for name in ("bwd_gates_stacked", "bwd_recurrence_stacked", "bwd_reduce_stacked",
                 "bwd_reduce_sum_stacked"):
        assert gru.kernel_launches[name] == counts[name] + 1, name
    with torch.no_grad():
        assert not gru.gru_sequence_stacked(*args).requires_grad
    with pytest.raises(ValueError):
        gru.gru_sequence_stacked(args[0], args[1], args[2][:1], args[3], args[4])
    with pytest.raises(ValueError):
        gru.gru_sequence_stacked(args[0][0], args[1], args[2][0], args[3][0], args[4][0])


def _seed_inputs(stack, t_len, b, h, seed, device, shared_keep=False):
    """Stacked inputs with a keep per entry (the seed programs) or one shared, and g_hs."""
    entries = [_inputs(t_len, b, h, seed=seed + s, device=device) for s in range(stack)]
    args = [torch.stack([e[0][i] for e in entries]).contiguous() for i in range(5)]
    if shared_keep:
        args[1] = entries[0][0][1]
    return args, torch.stack([e[1] for e in entries]).contiguous()


# The seed programs' SMAX 3s5z shapes (16 envs x 8 agents: B = 128 critic, 64
# losses), ragged and streaming shapes.
SEED_SHAPES = [(4, 128, 128, 128), (8, 128, 64, 128), (3, 7, 5, 128), (2, 9, 3, 256),
               (3, 6, 4, 72), (2, 5, 40, 64)]


@pytest.mark.parametrize("route", ["resident", "streaming"])
@pytest.mark.parametrize("shared_keep", [False, True], ids=["per-entry-keep", "shared-keep"])
@pytest.mark.parametrize("stack,t_len,b,h", SEED_SHAPES)
def test_stacked_backward_kernels_match_plain_versions(cuda, monkeypatch, stack, t_len, b, h,
                                                       shared_keep, route):
    if route == "streaming":
        monkeypatch.setattr(gru, "forced_route", gru.STREAMING)
    args, g_hs = _seed_inputs(stack, t_len, b, h, seed=b, device=cuda, shared_keep=shared_keep)
    counts = dict(gru.kernel_launches)
    hs = gru.gru_sequence_stacked_forward(*args)
    torch.testing.assert_close(hs, gru.gru_sequence_stacked_reference(*args), **TOL)
    got = gru.gru_sequence_stacked_backward(*args, hs, g_hs)
    want = gru.gru_sequence_stacked_backward_reference(*args, hs, g_hs)
    for name, g, w in zip(("dgates_i", "dh0", "dWh", "db_hn"), got, want):
        torch.testing.assert_close(g, w, **TOL, msg=name)
    again = gru.gru_sequence_stacked_backward(*args, hs, g_hs)
    for name, g, a in zip(("dgates_i", "dh0", "dWh", "db_hn"), got, again):
        assert torch.equal(a, g), name
    resident = route == "resident" and gru.kernel_route(t_len, b, h).route == "resident"
    assert gru.kernel_launches["bwd_gates_stacked"] == counts["bwd_gates_stacked"] + 2 * resident
    for name in ("bwd_recurrence_stacked", "bwd_reduce_stacked", "bwd_reduce_sum_stacked"):
        assert gru.kernel_launches[name] == counts[name] + 2, name
    for name in ("fwd", "bwd_gates", "bwd_recurrence", "bwd_reduce", "bwd_reduce_sum"):
        assert gru.kernel_launches[name] == counts[name], name


@pytest.mark.parametrize("stack,t_len,b,h", SEED_SHAPES[2:])
def test_stacked_entry_is_the_unstacked_kernels_bitwise(cuda, stack, t_len, b, h):
    """Entry s of each stacked kernel is the unstacked kernel on entry s's inputs,
    bitwise: the stacked kernels are the unstacked code with the entry's offsets."""
    args, g_hs = _seed_inputs(stack, t_len, b, h, seed=t_len, device=cuda)
    hs = gru.gru_sequence_stacked_forward(*args)
    grads = gru.gru_sequence_stacked_backward(*args, hs, g_hs)
    for s in range(stack):
        entry = [a[s] for a in args]
        assert torch.equal(hs[s], gru.gru_sequence_forward(*entry))
        for g, w in zip(grads, gru.gru_sequence_backward(*entry, hs[s], g_hs[s])):
            assert torch.equal(g[s], w)


def test_max_active_clusters_of_the_resident_kernels(cuda):
    for kernel in ("fwd", "bwd_recurrence"):
        assert gru.max_active_clusters(128, kernel, 256, 2) >= 1


def _pair_inputs(seeds, t_len, b, h, seed, device):
    """rec-IQL's stacked target pass: 2S entries (the S online networks, then the
    S targets), each pair with its seed's keep, (2S, T, B, H)."""
    args, _ = _seed_inputs(2 * seeds, t_len, b, h, seed=seed, device=device)
    args[1] = torch.cat([args[1][:seeds]] * 2).contiguous()
    return args


# The off-policy seed programs' shapes (rec-IQL on SMAX 3s5z: 32 sequences of 20
# steps x 8 agents) at S = 2 and 4, and a ragged B.
OFF_POLICY_SEEDS = [(2, 20, 256, 128), (4, 20, 256, 128), (2, 20, 37, 128)]


@pytest.mark.parametrize("seeds,t_len,b,h", OFF_POLICY_SEEDS)
def test_target_pass_over_2s_with_per_pair_keep(cuda, seeds, t_len, b, h):
    """The stacked K1 over 2S entries with each pair's keep: within 1e-4 of its
    plain version, bitwise repeatable, and each pair's entries the unstacked
    kernel on that entry's inputs, bitwise."""
    args = _pair_inputs(seeds, t_len, b, h, seed=seeds * 100 + b, device=cuda)
    counts = dict(gru.kernel_launches)
    hs = gru.gru_sequence_stacked(*args)
    torch.testing.assert_close(hs, gru.gru_sequence_stacked_reference(*args), **TOL)
    assert torch.equal(hs, gru.gru_sequence_stacked(*args))
    assert gru.kernel_launches["fwd_stacked"] == counts["fwd_stacked"] + 2
    assert gru.kernel_launches["fwd"] == counts["fwd"]
    for s in (0, seeds - 1, seeds, 2 * seeds - 1):
        assert torch.equal(hs[s], gru.gru_sequence_forward(*[a[s] for a in args]))
    assert torch.equal(args[1][0], args[1][seeds])


@pytest.mark.parametrize("seeds,t_len,b,h", OFF_POLICY_SEEDS)
def test_loss_pass_backward_over_s(cuda, seeds, t_len, b, h):
    """The stacked backward of rec-IQL's loss pass over S entries: within 1e-4
    of its plain version and bitwise repeatable, one launch of each kernel."""
    args, g_hs = _seed_inputs(seeds, t_len, b, h, seed=seeds + b, device=cuda)
    hs = gru.gru_sequence_stacked_forward(*args)
    counts = dict(gru.kernel_launches)
    got = gru.gru_sequence_stacked_backward(*args, hs, g_hs)
    for name in ("bwd_gates_stacked", "bwd_recurrence_stacked", "bwd_reduce_stacked",
                 "bwd_reduce_sum_stacked"):
        assert gru.kernel_launches[name] == counts[name] + 1, name
    want = gru.gru_sequence_stacked_backward_reference(*args, hs, g_hs)
    for name, g, w, a in zip(("dgates_i", "dh0", "dWh", "db_hn"), got, want,
                             gru.gru_sequence_stacked_backward(*args, hs, g_hs)):
        torch.testing.assert_close(g, w, **TOL, msg=name)
        assert torch.equal(a, g), name
