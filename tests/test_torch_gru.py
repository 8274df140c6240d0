"""The port's GRU sequence op (`mava_tpu_torch/ops/gru.py`) against the JAX
Pallas kernel (`mava_tpu/ops/pallas_gru.py`, interpret mode on the CPU) and its
scan reference.

On CPU tensors the op runs its plain PyTorch versions; the CUDA kernels are
checked on the card by `test_torch_gru_cuda.py` and `chip_smoke.py`. Also here:
the choice of kernels by shape, the roofline bounds and the library yardstick
that `chip_smoke.py` reports.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mava_tpu.ops.pallas_gru import gru_sequence as jax_gru_sequence
from mava_tpu_torch.ops import gru
from test_pallas_gru import _ref_gru

torch.set_num_threads(1)


def _inputs(t_len, b, h, seed, reset_p=0.3):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    resets = rng.random((t_len, b)) < reset_p
    keep = np.broadcast_to(1.0 - resets[..., None].astype(np.float32), (t_len, b, h))
    args = (f32(t_len, b, 3 * h), keep, f32(b, h), f32(h, 3 * h) / np.sqrt(h), 0.1 * f32(h))
    return tuple(np.ascontiguousarray(a, dtype=np.float32) for a in args)


def _torch(args, requires_grad=False):
    return [torch.tensor(a, requires_grad=requires_grad and i != 1) for i, a in enumerate(args)]


def _loss_weights(t_len, b, h):
    return np.arange(1, t_len * b * h + 1, dtype=np.float32).reshape(t_len, b, h) / (t_len * b * h)


@pytest.mark.parametrize("t_len,b,h", [(7, 5, 8), (4, 3, 16), (1, 2, 8), (8, 9, 16)])
def test_forward_matches_jax(t_len, b, h):
    args = _inputs(t_len, b, h, seed=t_len + 10 * b + h)
    hs = gru.gru_sequence(*_torch(args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(hs, np.asarray(jax_gru_sequence(*jargs)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(hs, np.asarray(_ref_gru(*jargs)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "t_len,b,h,reset_p",
    [(6, 4, 8, 0.3), (5, 7, 16, 0.5), (1, 3, 8, 0.0), (8, 2, 16, 1.0)],
    ids=["resets", "ragged-rows", "T1", "all-reset"],
)
def test_backward_matches_jax_grad(t_len, b, h, reset_p):
    args = _inputs(t_len, b, h, seed=100 + t_len * b, reset_p=reset_p)
    w = _loss_weights(t_len, b, h)

    targs = _torch(args, requires_grad=True)
    hs = gru.GRUSequenceFn.apply(*targs)
    torch.sum(torch.sin(hs) * torch.tensor(w)).backward()
    assert targs[1].grad is None  # keep is the reset mask: no gradient

    def loss(g, h0, wh, bhn):
        out = jax_gru_sequence(g, jnp.asarray(args[1]), h0, wh, bhn)
        return jnp.sum(jnp.sin(out) * w)

    jgrads = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(args[i]) for i in (0, 2, 3, 4)]
    )
    for tg, jg, name in zip([targs[i].grad for i in (0, 2, 3, 4)], jgrads,
                            ("dgates_i", "dh0", "dWh", "db_hn")):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6, err_msg=name)


def test_backward_reference_matches_autograd_of_forward():
    """The plain backward (recompute, reverse loop) equals PyTorch autograd
    through the plain forward: rtol 1e-5, atol 1e-6."""
    args = _torch(_inputs(9, 6, 16, seed=7))
    leaves = [a.clone().requires_grad_(i != 1) for i, a in enumerate(args)]
    hs = gru.gru_sequence_reference(*leaves)
    g_hs = torch.tensor(_loss_weights(9, 6, 16))
    auto = torch.autograd.grad(hs, [leaves[i] for i in (0, 2, 3, 4)], g_hs)
    manual = gru.gru_sequence_backward_reference(*args, hs.detach(), g_hs)
    for a, m in zip(auto, manual):
        np.testing.assert_allclose(m.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)


def test_cpu_tensors_never_launch_kernels():
    before = (gru.fwd_launches, gru.bwd_launches)
    targs = _torch(_inputs(5, 4, 8, seed=3), requires_grad=True)
    gru.gru_sequence(*targs).sum().backward()
    assert (gru.fwd_launches, gru.bwd_launches) == before == (0, 0)


@pytest.mark.parametrize("fault", ["float64", "non-contiguous", "bad-shape", "mixed-device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(fault):
    args = _torch(_inputs(4, 3, 8, seed=5))
    if fault == "float64":
        args[0] = args[0].double()
    elif fault == "non-contiguous":
        args[1] = args[1].transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "bad-shape":
        args[3] = args[3][:, :-3]
    else:
        args[2] = args[2].to("meta")
    with pytest.raises((TypeError, ValueError)):
        gru.gru_sequence_forward(*args)


# ---------------------------------------------------------------- the backward's three passes
@pytest.mark.parametrize(
    "t_len,b,h,reset_p",
    [(6, 4, 8, 0.3), (5, 7, 16, 0.5), (1, 3, 8, 0.0), (8, 2, 16, 1.0)],
    ids=["resets", "ragged-rows", "T1", "all-reset"],
)
def test_backward_passes_compose_to_the_backward(t_len, b, h, reset_p):
    """K2p, K2a and K2b's plain versions, one after the other, equal the plain
    reverse loop and the JAX gradient: rtol 1e-5, atol 1e-6."""
    args = _inputs(t_len, b, h, seed=100 + t_len * b, reset_p=reset_p)
    targs = _torch(args)
    g_hs = torch.tensor(_loss_weights(t_len, b, h))
    hs = gru.gru_sequence_reference(*targs)
    gates = gru.gru_backward_gates(*targs, hs)
    assert gates.shape == (t_len, b, 4 * h)
    dgates, dgh, dh0 = gru.gru_backward_recurrence(*targs, hs, g_hs, gates)
    dwh, dbhn = gru.gru_backward_reduce(targs[1], targs[2], hs, dgh)
    whole = gru.gru_sequence_backward_reference(*targs, hs, g_hs)

    def loss(g, h0, wh, bhn):
        out = jax_gru_sequence(g, jnp.asarray(args[1]), h0, wh, bhn)
        return jnp.sum(out * _loss_weights(t_len, b, h))

    jgrads = jax.grad(loss, argnums=(0, 1, 2, 3))(*[jnp.asarray(args[i]) for i in (0, 2, 3, 4)])
    for got, want, jg, name in zip((dgates, dh0, dwh, dbhn), whole, jgrads,
                                   ("dgates_i", "dh0", "dWh", "db_hn")):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6, err_msg=name)


def test_recurrence_on_cpu_needs_the_gates():
    targs = _torch(_inputs(4, 3, 8, seed=5))
    hs = gru.gru_sequence_reference(*targs)
    with pytest.raises(ValueError):
        gru.gru_backward_recurrence(*targs, hs, torch.ones_like(hs))


# ---------------------------------------------------------------- routes
ROUTE_SHAPES = [(128, 16, 128), (128, 32, 128), (7, 5, 128), (9, 3, 256), (1, 1, 8), (6, 4, 72),
                (3, 2, 512), (2, 2, 1024)]


@pytest.mark.parametrize("t_len,b,h", ROUTE_SHAPES)
def test_kernel_route(t_len, b, h):
    """Every admitted shape has a route; H = 128 and H = 256 are resident; a
    block's shared memory fits the card; the cluster divides the hidden units."""
    route = gru.kernel_route(t_len, b, h)
    assert route.route == ("resident" if h in (128, 256) else "streaming")
    assert max(route.fwd_smem, route.bwd_smem) <= gru.SMEM_LIMIT == 232_448
    assert 1 <= route.cluster <= 8 and h % route.cluster == 0
    assert 32 <= route.fwd_threads <= 1024 and 32 <= route.bwd_threads <= 1024
    rows = gru.CLUSTER_ROWS if route.route == "resident" else gru.STREAM_ROWS
    assert route.blocks == route.cluster * -(-b // rows)
    # The route is a function of the shape alone.
    assert route == gru.kernel_route(t_len, b, h)


def test_kernel_route_rejects_what_the_op_rejects():
    for shape in [(0, 1, 8), (1, 0, 8), (1, 1, 0), (1, 1, gru.MAX_HIDDEN + 1)]:
        with pytest.raises(ValueError):
            gru.kernel_route(*shape)


# ---------------------------------------------------------------- bounds and the yardstick
def test_bound_calculator():
    """K1 at the slice's shape: 201.3 MFLOP and 5.45 MB, bound by operations."""
    flop, nbytes = chip_smoke.kernel_work("fwd", 128, 16, 128)
    assert round(flop / 1e6, 1) == 201.3 and round(nbytes / 1e6, 2) == 5.45
    ms, by = chip_smoke.bound_ms("fwd", 128, 16, 128)
    assert by == "operations" and ms == pytest.approx(201.326592e6 / 67e12 * 1e3)
    ms, by = chip_smoke.bound_ms("bwd_recurrence", 128, 16, 128)
    assert by == "bytes" and ms == pytest.approx(13.84448e6 / 3.35e12 * 1e3)
    for kernel in ("bwd_gates", "bwd_reduce"):
        assert chip_smoke.bound_ms(kernel, 128, 32, 128)[0] > chip_smoke.bound_ms(kernel, 128, 16, 128)[0]


@pytest.mark.parametrize("t_len,b,h", [(6, 4, 8), (9, 5, 16)])
def test_library_yardstick_computes_the_same_function(t_len, b, h):
    """`torch.nn.GRU`, set up as the chip script sets it up, equals the op at
    keep == 1: forward 1e-5; gradients rtol 1e-4, atol 1e-5."""
    args = _torch(_inputs(t_len, b, h, seed=t_len * b, reset_p=0.0))
    assert bool((args[1] == 1).all())
    g_hs = torch.tensor(_loss_weights(t_len, b, h))
    rnn = chip_smoke.cudnn_gru(args[3], args[4])
    hs, grads, _ = chip_smoke.cudnn_gru_backward(rnn, args[0], args[2], g_hs)
    want = gru.gru_sequence_reference(*args)
    np.testing.assert_allclose(hs.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    wants = gru.gru_sequence_backward_reference(*args, want, g_hs)
    for got, ref, name in zip(grads, wants, ("dgates_i", "dh0", "dWh", "db_hn")):
        np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


# ---------------------------------------------------------------- K2b's row split
SPLIT_SHAPES = [(128, 16, 128), (128, 32, 128), (128, 256, 128), (128, 64, 256), (7, 5, 128),
                (33, 17, 128), (6, 4, 72), (9, 3, 256), (3, 2, 512), (2, 2, 1024), (1, 1, 8)]


@pytest.mark.parametrize("slices", [None, 1, 5, 10_000], ids=["rule", "S1", "S5", "S>chunks"])
@pytest.mark.parametrize("t_len,b,h", SPLIT_SHAPES)
def test_reduce_split_covers_every_row_exactly_once(t_len, b, h, slices):
    """The slices of K2b are disjoint, in order, and together hold rows 0 .. T*B;
    the rule is a function of the shape alone and keeps two passes a slice."""
    n = t_len * b
    split = gru.reduce_split(t_len, b, h, slices)
    assert split == gru.reduce_split(t_len, b, h, slices)
    assert split.slices >= 1 and split.rows_per_slice % gru.REDUCE_CHUNK == 0
    assert split.tiles == -(-h // gru.REDUCE_TILE) * -(-3 * h // gru.REDUCE_TILE)
    covered = np.zeros(n, dtype=np.int64)
    stop_before = 0
    for s in range(split.slices):
        lo, hi = gru.reduce_slice_rows(split, n, s)
        assert lo == stop_before and lo <= hi <= n
        covered[lo:hi] += 1
        stop_before = hi
    assert (covered == 1).all()
    if slices is None:
        assert all(gru.reduce_slice_rows(split, n, s)[0] < n for s in range(split.slices))
        assert split.slices == 1 or (
            split.rows_per_slice >= gru.REDUCE_MIN_CHUNKS * gru.REDUCE_CHUNK)
    else:
        assert split.slices == slices


@pytest.mark.parametrize("t_len,b,h", [(128, 16, 128), (128, 32, 128), (128, 256, 128),
                                       (128, 64, 256)])
def test_reduce_split_fills_the_card_at_the_slice_shapes(t_len, b, h):
    """At the shapes the chip script times, tiles x slices is at least two waves
    of the card's 132 SMs, and the scratch stays well inside the 50 MB L2."""
    split = gru.reduce_split(t_len, b, h)
    assert split.tiles * split.slices >= 2 * gru.SM_COUNT == 264
    assert 4 * split.slices * (h * 3 * h + h) < 25e6


def test_reduce_split_rejects_bad_counts():
    with pytest.raises(ValueError):
        gru.reduce_split(4, 4, 8, slices=0)
    with pytest.raises(ValueError):
        gru.reduce_split(0, 4, 8)


@pytest.mark.parametrize("slices", [None, 1, 3, 40], ids=["rule", "S1", "S3", "S>chunks"])
@pytest.mark.parametrize("t_len,b,h", [(7, 5, 72), (5, 3, 256), (11, 13, 16)],
                         ids=["H72", "H256", "ragged"])
def test_split_reduce_matches_the_product_and_the_jax_gradient(t_len, b, h, slices):
    """Per-slice partial sums added in slice order (the plain versions of K2b's two
    kernels) equal the plain product and, after the plain K2p and K2a, the JAX
    kernel's dWh and db_hn (interpret mode): rtol 1e-5, atol 1e-6."""
    args = _inputs(t_len, b, h, seed=h + t_len)
    targs = _torch(args)
    g_hs = torch.tensor(_loss_weights(t_len, b, h))
    hs = gru.gru_sequence_reference(*targs)
    gates = gru.gru_backward_gates(*targs, hs)
    _, dgh, _ = gru.gru_backward_recurrence(*targs, hs, g_hs, gates)
    split = gru.reduce_split(t_len, b, h, slices)
    partials = gru.gru_backward_reduce_partials(targs[1], targs[2], hs, dgh, slices)
    assert partials.shape == (split.slices, h * 3 * h + h)
    dwh, dbhn = gru.gru_backward_reduce_sum(partials, h)
    want = gru.gru_backward_reduce_reference(targs[1], targs[2], hs, dgh)

    def loss(wh, bhn):
        out = jax_gru_sequence(jnp.asarray(args[0]), jnp.asarray(args[1]), jnp.asarray(args[2]),
                               wh, bhn)
        return jnp.sum(out * _loss_weights(t_len, b, h))

    jgrads = jax.grad(loss, argnums=(0, 1))(jnp.asarray(args[3]), jnp.asarray(args[4]))
    for got, ref, jg, name in zip((dwh, dbhn), want, jgrads, ("dWh", "db_hn")):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6, err_msg=name)


def test_reduce_wrappers_check_their_inputs():
    targs = _torch(_inputs(4, 3, 8, seed=5))
    hs = gru.gru_sequence_reference(*targs)
    dgh = torch.ones(4, 3, 24)
    with pytest.raises(ValueError):
        gru.gru_backward_reduce_partials(targs[1], targs[2], hs, dgh[:, :, :-1])
    with pytest.raises(ValueError):
        gru.gru_backward_reduce_sum(torch.ones(2, 8 * 24), 8)  # db_hn's columns are missing
    with pytest.raises(TypeError):
        gru.gru_backward_reduce(targs[1], targs[2], hs, dgh.double())


@pytest.mark.parametrize("t_len,b,h", [(128, 16, 128), (128, 32, 128), (33, 17, 72)])
def test_bound_of_the_reduce_does_not_depend_on_the_split(t_len, b, h):
    """`bwd_reduce` is the work of the function: inputs once, outputs once, no
    scratch. Only the second kernel's own work grows with the slices."""
    base = chip_smoke.kernel_work("bwd_reduce", t_len, b, h)
    n = t_len * b
    assert base == (2 * n * h * 3 * h + 2 * n * 3 * h,
                    4 * (2 * n * h + b * h + n * 3 * h + h * 3 * h + h))
    for slices in (1, gru.reduce_split(t_len, b, h).slices, 64):
        assert chip_smoke.kernel_work("bwd_reduce", t_len, b, h, slices) == base
        assert chip_smoke.bound_ms("bwd_reduce", t_len, b, h, slices) == chip_smoke.bound_ms(
            "bwd_reduce", t_len, b, h)
    m = h * 3 * h + h
    assert chip_smoke.kernel_work("bwd_reduce_sum", t_len, b, h, 32) == (31 * m, 4 * 33 * m)
    assert chip_smoke.bound_ms("bwd_reduce_sum", t_len, b, h, 32)[1] == "bytes"
    assert set(name for _, name, _, _ in chip_smoke.KERNELS) == set(gru.KERNELS)


@pytest.mark.parametrize("stack,t_len,b,h", [(2, 20, 256, 128), (3, 9, 5, 64)])
def test_bound_of_the_stacked_forward(stack, t_len, b, h):
    """S forwards' work, with the shared `keep` read once."""
    flop, nbytes = chip_smoke.kernel_work("fwd", t_len, b, h)
    assert chip_smoke.kernel_work("fwd_stacked", t_len, b, h, stack=stack) == (
        stack * flop, stack * nbytes - (stack - 1) * 4 * t_len * b * h)
    assert chip_smoke.kernel_work("fwd_stacked", t_len, b, h, stack=1) == (flop, nbytes)
    ms, _ = chip_smoke.bound_ms("fwd_stacked", t_len, b, h, stack=stack)
    assert ms == max(stack * flop / chip_smoke.PEAK_FP32_FLOPS * 1e3,
                     (stack * nbytes - (stack - 1) * 4 * t_len * b * h)
                     / chip_smoke.PEAK_BYTES_PER_S * 1e3)
