"""What the articulated envs share: the solve of M q̈ = rhs, the ground contact
and joint-limit forces, a function traced once per shape of its inputs, the
RK4 integrator with its speed clip and angle wrap, and the (step count, q, q̇)
state.

The reference repeats `_integrate` in every env (`mava_tpu/envs/mareacher.py`,
`maswimmer.py`, `mahopper.py`, `macheetah.py`, `maant.py`, `mahumanoid.py`);
the port keeps one. Each env writes q̈ for one env; `Integrator` vmaps it over
the envs and traces the vmapped function with `make_fx` into a graph of plain
ATen ops, once per batch shape, dtype and device. The graph computes the same
ops without the transforms' Python work, which would otherwise be paid at every
call. A step runs each RK4 substep (`rk4_substep`) over the traced q̈;
`Integrator.traced_substep`, one whole substep traced as one graph, computes
the same and takes about four times as long to trace.

No op here reads a value back to the host: `solve` leaves its error check out,
so a CUDA step queues its kernels without waiting for the device, and a
singular M gives inf or NaN, as `jnp.linalg.solve` does.

On CUDA tensors the whole integration (`substeps` RK4 substeps over the traced
q̈, then the angle wrap) is one CUDA graph per batch shape, dtype and device
(`CapturedStep`, on `utils/cuda_graphs.py`): the counterpart of the
reference's `jax.jit` of the step. A step replays it, one graph launch in
place of thousands of small launches; CPU tensors run the same substeps
eagerly (`Integrator.eager`).
"""

from __future__ import annotations

import math
import operator
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import jvp, vjp, vmap

from mava_tpu_torch.ops import solve as solve_ops
from mava_tpu_torch.types import StepType, TimeStep
from mava_tpu_torch.utils import cuda_graphs


class BodyState(NamedTuple):
    step_count: torch.Tensor  # (E,) int32
    q: torch.Tensor  # (E, n) generalised coordinates
    qd: torch.Tensor  # (E, n) their rates


def uniform_noise(num_envs: int, width: int, half: float,
                  generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
    """(E, width) uniform on [-half, half), as `jax.random.uniform(key,
    minval=-half, maxval=half)` maps its draws: u * (2 half) - half."""
    u = torch.rand(num_envs, width, generator=generator, device=device)
    return u * (2 * half) - half


def body_timestep(team_reward: torch.Tensor, terminated: torch.Tensor,
                  step_count: torch.Tensor, observation, num_agents: int,
                  time_limit: int) -> TimeStep:
    """The timestep after a step: the team's reward for every agent, LAST on
    termination or at `time_limit`, discount 0 only on termination (a
    truncation bootstraps)."""
    last = terminated | (step_count >= time_limit)
    discount = torch.where(terminated, 0.0, 1.0).to(torch.float32)
    return TimeStep(
        step_type=torch.where(last, int(StepType.LAST), int(StepType.MID)).to(torch.int32),
        reward=team_reward.to(torch.float32)[:, None].expand(-1, num_agents).contiguous(),
        discount=discount[:, None].expand(-1, num_agents).contiguous(),
        observation=observation,
        extras={},
    )


def add_to_column(x: torch.Tensor, column: int, value: torch.Tensor) -> torch.Tensor:
    """`x` (E, n) with `value` (E,) added to one column, out of place (the
    reference's `q.at[column].add(value)`)."""
    return torch.cat([x[:, :column], (x[:, column] + value)[:, None], x[:, column + 1:]], dim=1)


def solve(mass: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """M⁻¹ rhs by LU with partial pivoting, as `jnp.linalg.solve`; the `info`
    check that `torch.linalg.solve` makes (a device-to-host read) is left out."""
    return torch.linalg.solve_ex(mass, rhs, check_errors=False)[0]


def contact_force(points_fn, q: torch.Tensor, qd: torch.Tensor, up: int, kp: float, kd: float,
                  kt: float, mu: float) -> torch.Tensor:
    """The generalised ground reaction Jᵀ F of one env: a spring-damper normal
    force where a contact point lies below the ground, the friction of each
    horizontal axis clamped to ±μ F_n, mapped back by the kinematics' vjp
    (the reference's `_contact_force`; `up` is the vertical axis, 1 in the
    plane, 2 in 3D)."""
    pts, pts_dot = jvp(points_fn, (q,), (qd,))
    depth = -pts[:, up]
    f_n = torch.where(depth > 0.0, kp * depth - kd * pts_dot[:, up], 0.0)
    f_n = torch.clamp(f_n, min=0.0)
    bound = mu * f_n[:, None]
    f_t = torch.clamp(-kt * pts_dot[:, :up], -bound, bound)
    forces = torch.cat([f_t, f_n[:, None]], dim=-1)
    _, pullback = vjp(points_fn, q)
    return pullback(forces)[0]


def limit_torque(alpha: torch.Tensor, alpha_d: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 kp: float, kd: float) -> torch.Tensor:
    """The joint-limit spring, and its damper only where a limit is engaged
    (the reference's `excess != 0.0` switch)."""
    excess = torch.clamp(alpha - hi, min=0.0) + torch.clamp(alpha - lo, max=0.0)
    return -kp * excess - kd * alpha_d * (excess != 0.0)


def route_solves_to_kernel(graph: torch.fx.GraphModule) -> None:
    """Every `aten._linalg_solve_ex` of a graph traced on the card replaced by
    the hand-written kernel (`ops/solve.py`): PyTorch's own batched solve
    takes, at some sizes, a route that a CUDA graph capture does not permit."""
    for node in graph.graph.nodes:
        if node.op == "call_function" and node.target is torch.ops.aten._linalg_solve_ex.default:
            if any(u.target is not operator.getitem or u.args[1] != 0 for u in node.users):
                raise RuntimeError("a traced solve whose LU, pivots or info is read")
            node.target = solve_ops.solve_ex_on_card
    graph.recompile()


class Traced:
    """`fn` traced with `make_fx` on its first call for each (shape, dtype,
    device) of its tensor arguments; later calls run the traced graph. On the
    card the graph's solves go to the hand-written kernel
    (`route_solves_to_kernel`).
    The graph is functionalized (no op writes in place), so that the common
    subexpressions the transforms leave (the kinematics under jvp, jacfwd and
    vjp alike) can be merged: the same ops on the same inputs, computed once.
    `seconds` holds the time each trace took."""

    def __init__(self, fn: Callable[..., torch.Tensor]):
        self.fn = fn
        self.graphs: Dict[Tuple, Callable] = {}
        self.seconds: Dict[Tuple, float] = {}

    def __call__(self, *args: torch.Tensor):
        key = tuple((a.shape, a.dtype, a.device) for a in args)
        graph = self.graphs.get(key)
        if graph is None:
            from torch._guards import TracingContext, tracing
            from torch._subclasses.fake_tensor import FakeTensorMode
            from torch.func import functionalize
            from torch.fx.experimental.proxy_tensor import make_fx
            from torch.fx.passes.dialect.common.cse_pass import CSEPass

            start = time.perf_counter()
            # make_fx records each node's shape in a fake tensor; without a
            # fake mode in the tracing context it builds a new mode per node,
            # which takes half the trace.
            with tracing(TracingContext(FakeTensorMode(allow_fallback_kernels=True))):
                graph = make_fx(functionalize(lambda *xs: self.fn(*xs)))(*args)
            graph = CSEPass()(graph).graph_module
            graph.graph.eliminate_dead_code()
            graph.recompile()
            # Constants lifted on the host (a factory without a device) go to
            # the inputs' device once, here: a copy to the card in every call
            # would also be a host-to-device copy inside a graph capture.
            device = args[0].device
            for name in [n.target for n in graph.graph.nodes if n.op == "get_attr"]:
                const = getattr(graph, name)
                if isinstance(const, torch.Tensor) and const.device != device:
                    setattr(graph, name, const.to(device))
            if device.type == "cuda":
                route_solves_to_kernel(graph)
            self.graphs[key] = graph
            self.seconds[key] = time.perf_counter() - start
        return graph(*args)


def rk4_substep(accel: Callable, q: torch.Tensor, qd: torch.Tensor, tau: torch.Tensor,
                h: float, max_speed: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One classic RK4 step of the coupled (q, q̇) ODE, q̇ clipped after it
    (the reference's `sub`, e.g. `mava_tpu/envs/maswimmer.py:181-190`)."""
    k1 = (qd, accel(q, qd, tau))
    k2q, k2v = q + 0.5 * h * k1[0], qd + 0.5 * h * k1[1]
    k2 = (k2v, accel(k2q, k2v, tau))
    k3q, k3v = q + 0.5 * h * k2[0], qd + 0.5 * h * k2[1]
    k3 = (k3v, accel(k3q, k3v, tau))
    k4q, k4v = q + h * k3[0], qd + h * k3[1]
    k4 = (k4v, accel(k4q, k4v, tau))
    q = q + (h / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0])
    qd = qd + (h / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])
    return q, torch.clamp(qd, -max_speed, max_speed)


def wrap_angles(q: torch.Tensor, first: int) -> torch.Tensor:
    """Coordinates `first:` of each env wrapped to [-π, π) (`jnp.mod` and
    `torch.remainder` are both floor-mod); the ones before are kept."""
    angles = torch.remainder(q[:, first:] + math.pi, 2 * math.pi) - math.pi
    return torch.cat([q[:, :first], angles], dim=1) if first else angles


def failing_op(error: BaseException) -> str:
    """The ATen op on the line of a traced graph where `error`, or an error it
    arose from, was raised; else where in the port it was raised; else a note
    that it was raised elsewhere (`utils.cuda_graphs.failing_op`)."""
    return cuda_graphs.failing_op(error, elsewhere="an op outside the traced q̈")


class CapturedStep:
    """`fn(*args)` on CUDA tensors of fixed shapes captured once as a CUDA
    graph and replayed at every call (`utils.cuda_graphs.Captured`). The
    capture first runs `fn` once on a side stream (which traces q̈ if it was
    not traced yet, and creates the cuBLAS and cuSOLVER handles and workspaces
    its ops need), then captures it on the same stream into the device's
    shared pool (`graph_pool`). A call copies its arguments into the graph's
    static inputs, replays the graph and returns copies of its static outputs,
    which the next replay overwrites. A capture that fails raises with the
    failing op's name. The solve kernel's launch count (`ops.solve.launches`)
    counts what a replay launches, not what the capture recorded."""

    def __init__(self, fn: Callable[..., Tuple[torch.Tensor, ...]], args: Tuple[torch.Tensor, ...],
                 what: str):
        start = time.perf_counter()
        self.inputs = tuple(a.detach().clone() for a in args)
        self.graph = cuda_graphs.Captured(lambda: fn(*self.inputs), what, args[0].device,
                                          counters=[(solve_ops, "launches")])
        self.seconds = time.perf_counter() - start

    def __call__(self, *args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        for static, arg in zip(self.inputs, args):
            static.copy_(arg)
        return tuple(out.clone() for out in self.graph.replay())


class Integrator:
    """`substeps` RK4 steps of h = dt / substeps of one env's
    `accel(q, q̇, τ) -> q̈`, batched over the envs, then the coordinates from
    `wrap_from` on wrapped. The step runs `rk4_substep` over the traced q̈
    (`accel`); `traced_substep`, the whole RK4 substep traced as one graph,
    computes the same. On CUDA tensors the whole step is captured once per
    (shape, dtype, device) of its inputs (`captured`) and replayed; on CPU
    tensors it runs eagerly (`eager`), and so it does while the stream is
    capturing another graph (a PPO update captured whole, `systems/ppo/`):
    a graph neither replays nor is captured inside another capture, and the
    eager step launches the kernels that its graph replays, the solve kernel
    included."""

    def __init__(self, accel: Callable, dt: float, substeps: int, max_speed: float,
                 wrap_from: int):
        self.h = dt / substeps
        self.substeps = substeps
        self.max_speed = max_speed
        self.wrap_from = wrap_from
        batched = vmap(accel)
        self.accel = Traced(batched)
        self.traced_substep = Traced(
            lambda q, qd, tau: rk4_substep(batched, q, qd, tau, self.h, self.max_speed))
        self.captured: Dict[Tuple, CapturedStep] = {}

    def substep(self, q: torch.Tensor, qd: torch.Tensor,
                tau: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return rk4_substep(self.accel, q, qd, tau, self.h, self.max_speed)

    def trace_seconds(self) -> Dict[Tuple, float]:
        """Seconds each trace of q̈ took, by its inputs' (shape, dtype, device)."""
        return dict(self.accel.seconds)

    def capture_seconds(self) -> Dict[Tuple, float]:
        """Seconds each capture of the step took (its warm-up, and the trace
        of q̈ where that came first, included), by its inputs' key."""
        return {key: step.seconds for key, step in self.captured.items()}

    def eager(self, q: torch.Tensor, qd: torch.Tensor,
              tau: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step op by op: the substeps over the traced q̈, then the wrap."""
        for _ in range(self.substeps):
            q, qd = self.substep(q, qd, tau)
        return wrap_angles(q, self.wrap_from), qd

    def __call__(self, q: torch.Tensor, qd: torch.Tensor,
                 tau: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if q.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
            return self.eager(q, qd, tau)
        key = tuple((a.shape, a.dtype, a.device) for a in (q, qd, tau))
        step = self.captured.get(key)
        if step is None:
            step = self.captured[key] = CapturedStep(
                self.eager, (q, qd, tau), f"the integrator's step at q {tuple(q.shape)}")
        return step(q, qd, tau)
