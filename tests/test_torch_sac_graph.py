"""The SAC train phase as its draws and a body on device tensors
(`systems/sac/ff_isac.py`, `advanced_usage/ff_isac_vmap_seeds.py`,
`utils/cuda_graphs.py` `CapturedPhase`), and the optimizers' device-side count
(`utils/training.py`).

On the CPU: an update drawn by the learner is bitwise the update fed the
draws that the epochs' loop made before the split, drawn here from a copy of
the learner's generator in that loop's order (act normals, then epoch by
epoch the rows, the Q step's normals and, on an actor epoch, the actor's and
alpha's); the optimizers with the device count are bitwise the step that
formed its bias corrections from the host count, at every count sampled up
to 1,000,000, and a checkpoint brings both counts back; the body makes no
host read (no `.item()`, no tensor from Python values, no data-dependent
shape) and the same op sequence at every call. On the card (`gpu`): the
replayed phase is bitwise the phase run op by op, one graph a learner, a
restore captures once more, and the host counters advance as op by op.

This file imports neither JAX nor `mava_tpu`; the tests marked `gpu` skip
without a CUDA device. On the card (where JAX is not installed) run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sac_graph.py -q
"""

from typing import Callable, Optional, Union

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mava_tpu_torch import envs
from mava_tpu_torch.advanced_usage import ff_isac_vmap_seeds
from mava_tpu_torch.advanced_usage.common import Draws as StackedDraws
from mava_tpu_torch.distributions import normal
from mava_tpu_torch.parallel import mesh as mesh_module
from mava_tpu_torch.systems.sac import ff_isac
from mava_tpu_torch.systems.sac.types import Draws
from mava_tpu_torch.utils.checkpointing import restore_into, to_host
from mava_tpu_torch.utils.config import load_config
from mava_tpu_torch.utils.training import ClippedAdam, SweptClippedAdam, _per_entry

torch.set_num_threads(1)
TINY = [
    "arch.num_envs=3",
    "system.rollout_length=2",
    "system.explore_steps=6",
    "system.epochs=4",
    "system.policy_update_delay=2",
    "system.buffer_size=7",
    "system.batch_size=4",
    "network.actor_network.pre_torso.layer_sizes=[16]",
    "network.critic_network.pre_torso.layer_sizes=[16]",
    "env.kwargs.time_limit=5",
    "logger.use_console=False",
]
# The ops that read a value back to the host, or copy one from it.
HOST_BOUND = {"aten._local_scalar_dense", "aten.item", "aten.is_nonzero", "aten.nonzero",
              "aten.lift_fresh", "aten.equal"}


def config(centralised: bool, device, overrides=()):
    cfg = load_config("default_ff_masac" if centralised else "default_ff_isac",
                      TINY + list(overrides) + [f"+arch.device={torch.device(device).type}"])
    cfg.arch.n_devices = 1
    cfg.system.scan_steps = 1
    return cfg


def stock(centralised: bool = False, device="cpu", overrides=()):
    """(config, env, explore, learn, state) of a tiny stock learner from seed 1."""
    cfg = config(centralised, device, overrides)
    env, _ = envs.make(cfg, device, add_global_state=centralised)
    explore, learn, _, state = ff_isac.learner_setup(
        env, torch.Generator(device=device).manual_seed(1), cfg, torch.device(device),
        centralised)
    return cfg, env, explore, learn, state


def stacked(num: int, shared: bool, centralised: bool = False, device="cpu", overrides=()):
    """(config, env, explore, learn, state) of a tiny stacked learner of `num`
    entries; `shared` makes it a sweep (one entry's draws for every entry)."""
    cfg = config(centralised, device, overrides)
    env, _ = envs.make(cfg, device, add_global_state=centralised)
    lrs = [1e-3 * (i + 1) for i in range(num)] if shared else None
    explore, learn, _, state = ff_isac_vmap_seeds.learner_setup(
        env, torch.Generator(device=device).manual_seed(1), cfg, torch.device(device), num,
        centralised, sweep_lrs=lrs)
    return cfg, env, explore, learn, state


def copy_of(generator: torch.Generator) -> torch.Generator:
    gen = torch.Generator(device=generator.device)
    gen.set_state(generator.get_state())
    return gen


def ring_size(cfg, state) -> int:
    """The items one update samples from: the ring after the update's act steps."""
    written = state.buffer_state.current_index + cfg.system.rollout_length * cfg.arch.num_envs
    return cfg.system.buffer_size if state.buffer_state.is_full else min(
        written, cfg.system.buffer_size)


def epochs_loop_draws(cfg, env, state, draw: Callable, env_draw: Callable, entry_axis: bool):
    """One update's draws in the order the epochs' loop made them before the
    train phase was split: the act normals, each act step's env draw (the
    auto-resets'), then epoch by epoch the rows, the Q normals and, on an
    actor epoch, the actor's and alpha's normals. The actor and alpha fields
    hold zeros on the other epochs, which the update does not read.
    `entry_axis` puts the epoch axis after a stacked learner's entry axis."""
    sys_cfg = cfg.system
    e, a, act = cfg.arch.num_envs, env.num_agents, env.action_dim
    sample = (sys_cfg.batch_size, a, act)
    act_noise = draw(normal, (sys_cfg.rollout_length, e, a, act))
    env_noise = [env_draw() for _ in range(sys_cfg.rollout_length)]
    size = ring_size(cfg, state)
    rows, q_noise, actor_noise, alpha_noise = [], [], [], []
    for epoch in range(sys_cfg.epochs):
        rows.append(draw(randint(size), (sys_cfg.batch_size,)))
        q_noise.append(draw(normal, sample))
        if epoch % sys_cfg.policy_update_delay == 0:
            shape = (sys_cfg.policy_update_delay, *sample)
            actor_noise.append(draw(normal, shape))
            alpha_noise.append(draw(normal, shape))
        else:
            actor_noise.append(torch.zeros_like(actor_noise[-1]))
            alpha_noise.append(torch.zeros_like(alpha_noise[-1]))
    dim = 1 if entry_axis else 0
    return Draws(act_noise=act_noise, env_noise=env_noise, rows=torch.stack(rows, dim),
                 q_noise=torch.stack(q_noise, dim), actor_noise=torch.stack(actor_noise, dim),
                 alpha_noise=torch.stack(alpha_noise, dim))


def randint(high: int):
    def draw(shape, generator, device):
        return torch.randint(0, high, shape, generator=generator, device=device)
    return draw


def parameters(state):
    nets = (state.params.actor, *state.params.q.online, *state.params.q.targets)
    return [p.detach() for net in nets for p in net.parameters()] + [state.params.log_alpha]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def assert_same_update(out, handed):
    assert_same(parameters(out.learner_state), parameters(handed.learner_state))
    assert sorted(out.train_metrics) == sorted(handed.train_metrics)
    for k in out.train_metrics:
        assert torch.equal(out.train_metrics[k], handed.train_metrics[k]), k
    for opt, other in zip(out.learner_state.opt_states, handed.learner_state.opt_states):
        assert opt.count == other.count
        assert_same(opt.mu + opt.nu, other.mu + other.nu)


# ------------------------------------------------------------------ the stream
@pytest.mark.parametrize("centralised", [False, True], ids=["isac", "masac"])
def test_stock_update_draws_in_the_epochs_loop_order(centralised):
    cfg, env, explore, learn, state = stock(centralised)
    _, _, _, learn_handed, state_handed = stock(centralised)
    state, _ = explore(state)
    state_handed, _ = explore(state_handed)
    gen = copy_of(state.key)
    drawn = epochs_loop_draws(cfg, env, state, lambda fn, shape: fn(shape, gen, "cpu"),
                              lambda: env.step_noise(cfg.arch.num_envs, gen), entry_axis=False)
    out = learn(state)
    handed = learn_handed(state_handed, [drawn])
    assert_same_update(out, handed)
    # The learner's own draws took its generator exactly as far as the loop's.
    assert torch.equal(out.learner_state.key.get_state(), gen.get_state())
    assert torch.equal(handed.learner_state.key.get_state(), state_handed.key.get_state())


@pytest.mark.parametrize("shared", [False, True], ids=["seeds", "sweep"])
@pytest.mark.parametrize("centralised", [False, True], ids=["isac", "masac"])
def test_stacked_update_draws_in_the_epochs_loop_order(shared, centralised):
    cfg, env, explore, learn, state = stacked(2, shared, centralised)
    _, _, _, learn_handed, state_handed = stacked(2, shared, centralised)
    state, _ = explore(state)
    state_handed, _ = explore(state_handed)
    gen = copy_of(state.key)
    draw = StackedDraws(2, shared, gen, "cpu")
    drawn = epochs_loop_draws(cfg, env, state, draw, lambda: draw.env(env, cfg.arch.num_envs),
                              entry_axis=True)
    out = learn(state)
    handed = learn_handed(state_handed, [drawn])
    assert_same_update(out, handed)
    assert torch.equal(out.learner_state.key.get_state(), gen.get_state())


def test_cpu_learner_builds_no_graph():
    _, _, explore, learn, state = stock()
    state, _ = explore(state)
    for _ in range(2):
        state = learn(state).learner_state
    assert learn.train.graph is None and learn.train.captures == 0


# ------------------------------------------------------------------ the optimizers
class PreSplitClippedAdam:
    """The optimizer step as it was before the device count: the bias
    corrections formed from the host count, `1 - tensor(b) ** count`."""

    def __init__(self, params, lr: Union[float, Callable], max_grad_norm: float,
                 eps: float = 1e-5, b1: float = 0.9, b2: float = 0.999,
                 peak_lr: Optional[torch.Tensor] = None, decay_updates: Optional[int] = None):
        self.params = list(params)
        self.lr, self.max_grad_norm, self.eps, self.b1, self.b2 = lr, max_grad_norm, eps, b1, b2
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.peak_lr, self.decay_updates = peak_lr, decay_updates

    @torch.no_grad()
    def step(self, grads):
        swept = self.peak_lr is not None
        if swept:
            g_norm = torch.sqrt(sum(torch.sum(g * g, dim=tuple(range(1, g.dim())))
                                    for g in grads))
            keep = g_norm < self.max_grad_norm
            grads = [torch.where(_per_entry(keep, g), g,
                                 (g / _per_entry(g_norm, g)) * self.max_grad_norm)
                     for g in grads]
            frac = 1.0
            if self.decay_updates is not None:
                frac = max(0.0, 1.0 - self.count / self.decay_updates)
            lr = (self.peak_lr * frac).to(self.params[0].dtype)
        else:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < self.max_grad_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.max_grad_norm) for g in grads]
            lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        dtype, dev = self.params[0].dtype, self.params[0].device
        bc1 = 1 - torch.tensor(self.b1, dtype=dtype, device=dev) ** self.count
        bc2 = 1 - torch.tensor(self.b2, dtype=dtype, device=dev) ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-(_per_entry(lr, p) if swept else lr) * update)


def _tensors(rng, shapes):
    return [torch.tensor(rng.standard_normal(s), dtype=torch.float32) for s in shapes]


@pytest.mark.parametrize("lr", ["constant", "scheduled"])
def test_clipped_adam_is_the_pre_split_step(lr):
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (3,), (1, 2)]
    rate = 3e-3 if lr == "constant" else (lambda count: 3e-3 * max(0.0, 1.0 - count / 300))
    base = _tensors(rng, shapes)
    new = ClippedAdam([b.clone() for b in base], rate, max_grad_norm=1.5, eps=1e-8)
    old = PreSplitClippedAdam([b.clone() for b in base], rate, max_grad_norm=1.5, eps=1e-8)
    for _ in range(200):
        grads = [g * rng.uniform(0.05, 3.0) for g in _tensors(rng, shapes)]
        new.step(grads)
        old.step(grads)
        assert_same(new.params + new.mu + new.nu, old.params + old.mu + old.nu)
    assert new.count == old.count == 200 and new.device_count.item() == 200


@pytest.mark.parametrize("decay", [None, 250])
def test_swept_clipped_adam_is_the_pre_split_step(decay):
    rng = np.random.default_rng(1)
    shapes = [(3, 4, 2), (3, 2)]
    lrs = [1e-4, 1e-3, 3e-2]
    base = _tensors(rng, shapes)
    new = SweptClippedAdam([b.clone() for b in base], lrs, 0.8, decay_updates=decay, eps=1e-8)
    old = PreSplitClippedAdam([b.clone() for b in base], None, 0.8, eps=1e-8,
                              peak_lr=new.peak_lr.clone(), decay_updates=decay)
    for _ in range(200):
        grads = [g * rng.uniform(0.05, 3.0) for g in _tensors(rng, shapes)]
        new.step(grads)
        old.step(grads)
        assert_same(new.params + new.mu + new.nu, old.params + old.mu + old.nu)
    assert new.count == old.count == 200


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bias_corrections_match_the_host_count_form(dtype):
    """Every count to 5,000 and every 97th to 1,000,000 (a 500k-step SAC run
    makes ~496,000 Q steps): 1 - b^n from the device count is bitwise the
    pre-split `1 - tensor(b) ** n` (a float64 power, b * b * b at n = 3)."""
    opt = ClippedAdam([torch.zeros(1, dtype=dtype)], 1e-3, 1.0, eps=1e-8)
    b1, b2 = (torch.tensor(b, dtype=dtype) for b in (opt.b1, opt.b2))
    for n in [*range(1, 5001), *range(5001, 1_000_001, 97)]:
        opt.count = n - 1
        bc1, bc2 = opt._advance()
        assert torch.equal(bc1, 1 - b1 ** n) and torch.equal(bc2, 1 - b2 ** n), n
        assert opt.count == n


@pytest.mark.parametrize("swept", [False, True], ids=["clipped", "swept"])
def test_checkpoint_restores_both_counts(swept):
    rng = np.random.default_rng(2)
    shapes = [(2, 3), (2,)]

    def make():
        params = _tensors(np.random.default_rng(3), shapes)
        if swept:
            return SweptClippedAdam(params, [1e-3, 2e-3], 1.0, eps=1e-8)
        return ClippedAdam(params, 1e-3, 1.0, eps=1e-8)

    opt, fresh = make(), make()
    for _ in range(7):
        opt.step(_tensors(rng, shapes))
    restore_into(fresh, to_host(opt))
    for p, q in zip(fresh.params, opt.params):
        p.copy_(q)
    assert fresh.count == opt.count == 7
    assert torch.equal(fresh.device_count, opt.device_count)
    grads = _tensors(rng, shapes)
    opt.step(grads)
    fresh.step(grads)
    assert_same(fresh.params + fresh.mu + fresh.nu, opt.params + opt.mu + opt.nu)


# ------------------------------------------------------------------ no host read
class OpRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("learner", ["isac", "masac", "masac_stacked"])
def test_train_body_reads_nothing_back_and_repeats_its_ops(learner):
    if learner == "masac_stacked":
        _, _, explore, learn, state = stacked(2, False, centralised=True)
    else:
        _, _, explore, learn, state = stock(centralised=learner == "masac")
    state, _ = explore(state)
    draws = learn.train.draw(state, Draws())
    recorded = []
    for _ in range(2):
        with OpRecorder() as rec:
            losses = learn.train.body(state, draws)
        recorded.append(rec.ops)
        assert all(torch.isfinite(v).all() for v in losses.values())
    assert not set(recorded[0]) & HOST_BOUND, set(recorded[0]) & HOST_BOUND
    assert recorded[0] == recorded[1]
    assert len(recorded[0]) > 100


# ------------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the train phase is captured only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _learner(kind: str, device):
    if kind == "stacked":
        return stacked(2, False, centralised=True, device=device)
    return stock(device=device)


def _counts(state):
    return [opt.count for opt in state.opt_states] + [
        opt.device_count.item() for opt in state.opt_states]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["stock", "stacked"])
def test_replayed_train_phase_is_the_eager_one(cuda, kind):
    """Three updates replayed (the first runs the body and captures it)
    against three with the phase op by op: bitwise; the host counts and the
    all-reduce count advance alike; one graph, no re-capture."""
    _, _, explore, learn, state = _learner(kind, cuda)
    _, _, explore_eager, learn_eager, state_eager = _learner(kind, cuda)
    learn_eager.train = learn_eager.train.eager
    state, _ = explore(state)
    state_eager, _ = explore_eager(state_eager)
    reduces = mesh_module.all_reduces
    for _ in range(3):
        out, out_eager = learn(state), learn_eager(state_eager)
        assert_same_update(out, out_eager)
        state, state_eager = out.learner_state, out_eager.learner_state
        assert _counts(state) == _counts(state_eager)
    assert mesh_module.all_reduces == reduces  # no data group: no collective
    assert learn.train.captures == 1 and learn.train.recaptures == 0


@pytest.mark.gpu
def test_second_learner_gets_its_own_graph(cuda):
    _, _, explore_a, learn_a, a = stock(device=cuda)
    _, _, explore_b, learn_b, b = stock(device=cuda)
    a, _ = explore_a(a)
    b, _ = explore_b(b)
    for _ in range(2):
        out_a, out_b = learn_a(a), learn_b(b)
        assert_same_update(out_a, out_b)
        a, b = out_a.learner_state, out_b.learner_state
    assert learn_a.train.graph is not learn_b.train.graph
    assert learn_a.train.captures == learn_b.train.captures == 1
    assert learn_a.train.recaptures == learn_b.train.recaptures == 0


@pytest.mark.gpu
def test_restore_captures_once_more(cuda):
    """A learner state restored from a checkpoint holds a new ring: the next
    update captures again (once), and goes on as an eager learner restored
    the same way."""
    _, _, explore, learn, state = stock(device=cuda)
    _, _, explore_eager, learn_eager, state_eager = stock(device=cuda)
    learn_eager.train = learn_eager.train.eager
    state, _ = explore(state)
    state_eager, _ = explore_eager(state_eager)
    state = learn(state).learner_state
    state_eager = learn_eager(state_eager).learner_state
    saved = to_host(state)
    state = restore_into(state, saved)
    state_eager = restore_into(state_eager, saved)
    for _ in range(2):
        out, out_eager = learn(state), learn_eager(state_eager)
        assert_same_update(out, out_eager)
        state, state_eager = out.learner_state, out_eager.learner_state
    assert learn.train.captures == 2 and learn.train.recaptures == 1
