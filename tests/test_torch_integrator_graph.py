"""The articulated envs' integrator step (`envs/_dynamics.py` `Integrator`): on
CPU tensors the substeps run op by op, exactly as they always have, and no
graph is built; on CUDA tensors the step is one CUDA graph per batch shape,
replayed, and equal bit for bit to the same step run op by op.

This file imports neither JAX nor `mava_tpu`; the tests marked `gpu` skip
without a CUDA device. On the card (where JAX is not installed) run:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_integrator_graph.py -q
"""

import pytest
import torch

from mava_tpu_torch import envs
from mava_tpu_torch.envs._dynamics import failing_op, rk4_substep, wrap_angles
from mava_tpu_torch.utils.config import load_config

torch.set_num_threads(1)
# Every env whose step goes through `Integrator`, at its shipped scenario.
INTEGRATOR_ENVS = [("mareacher", "reacher-2x1"), ("maswimmer", "swimmer-2x1"),
                   ("mahopper", "hopper-3x1"), ("macheetah", "halfcheetah-6x1"),
                   ("mawalker", "walker2d-2x3"), ("maant", "ant-4x2"),
                   ("mahumanoid", "humanoid-9-8")]


def inner_env(env_name: str, scenario: str, device):
    env = envs.make(load_config("default_ff_isac", [f"env={env_name}",
                                                     f"env/scenario={scenario}"]), device)[0]
    while hasattr(env, "_env"):
        env = env._env
    return env


def step_inputs(env, num_envs: int, seed: int):
    """(q, q̇, τ) of `num_envs` envs: the shipped reset, bodies moving at up to
    1 unit/s and torques on [-1, 1)."""
    gen = torch.Generator(device=env.device).manual_seed(seed)
    state, _ = env.reset(env.reset_noise(num_envs, gen))
    qd = torch.rand(state.q.shape, generator=gen, device=env.device) * 2 - 1
    tau = torch.rand(state.q.shape, generator=gen, device=env.device) * 2 - 1
    return state.q, qd, tau


@pytest.mark.parametrize("env_name,scenario", [("mareacher", "reacher-2x1"),
                                               ("mahopper", "hopper-3x1")])
def test_cpu_step_is_the_substep_loop_and_builds_no_graph(env_name, scenario):
    env = inner_env(env_name, scenario, "cpu")
    integrate = env.integrate
    q, qd, tau = step_inputs(env, 4, seed=0)
    got = integrate(q, qd, tau)
    want_q, want_qd = q, qd
    for _ in range(integrate.substeps):
        want_q, want_qd = rk4_substep(integrate.accel, want_q, want_qd, tau, integrate.h,
                                      integrate.max_speed)
    want = (wrap_angles(want_q, integrate.wrap_from), want_qd)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    state, _ = env.reset(env.reset_noise(4, torch.Generator().manual_seed(1)))
    env.step(state, torch.zeros(4, env.num_agents, env.action_dim))
    assert integrate.captured == {}


def test_failing_op_names_the_traced_graphs_op():
    env = inner_env("mareacher", "reacher-2x1", "cpu")
    q, qd, tau = step_inputs(env, 4, seed=0)
    env.integrate(q, qd, tau)
    (graph,) = env.integrate.accel.graphs.values()
    with pytest.raises(RuntimeError) as error:
        graph(q[:3], qd, tau)  # rows that do not match the traced batch
    assert failing_op(error.value) == "aten.view.default"
    assert failing_op(ValueError("elsewhere")) == "an op outside the traced q̈"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured step runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("env_name,scenario", INTEGRATOR_ENVS)
def test_replayed_step_is_the_eager_step(cuda, env_name, scenario):
    integrate = inner_env(env_name, scenario, cuda).integrate
    for graphs, num_envs in enumerate((16, 64), start=1):
        for seed in (0, 1):  # the second replays the graph on new inputs
            q, qd, tau = step_inputs(inner_env(env_name, scenario, cuda), num_envs, seed)
            want = integrate.eager(q, qd, tau)
            first = integrate(q, qd, tau)
            second = integrate(q, qd, tau)
            for a, b, w in zip(first, second, want):
                assert torch.equal(a, w) and torch.equal(b, w)
                assert a.data_ptr() != b.data_ptr()  # copies, not the graph's outputs
        assert len(integrate.captured) == graphs


def test_card_graphs_route_the_solve_to_the_kernel_and_keep_its_result():
    """The rewrite that a graph traced on the card gets, run on the CPU, where
    the op's plain version computes: the solve node now calls
    `solve_ex_on_card`, and the graph's q̈ is bitwise what it was."""
    from mava_tpu_torch.envs._dynamics import Traced, route_solves_to_kernel
    from mava_tpu_torch.ops import solve

    env = inner_env("mahopper", "hopper-3x1", "cpu")
    q, qd, tau = step_inputs(env, 4, seed=2)
    traced = Traced(torch.func.vmap(env._accel))
    want = traced(q, qd, tau)
    (graph,) = traced.graphs.values()
    route_solves_to_kernel(graph)
    targets = [n.target for n in graph.graph.nodes if n.op == "call_function"]
    assert solve.solve_ex_on_card in targets
    assert torch.ops.aten._linalg_solve_ex.default not in targets
    assert torch.equal(graph(q, qd, tau), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 5, 6, 9, 14, 23])
@pytest.mark.parametrize("batch", [16, 320, 2560])
def test_solve_kernel_matches_its_plain_version(cuda, n, batch):
    from mava_tpu_torch.ops import solve

    gen = torch.Generator(device=cuda).manual_seed(n)
    m = torch.randn(batch, n, n, generator=gen, device=cuda)
    m += n * torch.eye(n, device=cuda).flip(0)  # large off-diagonal: rows must swap
    b = torch.rand(batch, n, generator=gen, device=cuda) * 2 - 1
    before = solve.launches
    got = solve.batched_solve(m, b)
    torch.testing.assert_close(got, solve.batched_solve_reference(m, b), rtol=1e-4, atol=1e-4)
    assert solve.launches == before + 1
    assert torch.equal(solve.batched_solve(m, b), got)  # no atomics: repeatable
