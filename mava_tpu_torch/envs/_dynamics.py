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
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import jvp, vjp, vmap

from mava_tpu_torch.types import StepType, TimeStep


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


class Traced:
    """`fn` traced with `make_fx` on its first call for each (shape, dtype,
    device) of its tensor arguments; later calls run the traced graph.
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


class Integrator:
    """`substeps` RK4 steps of h = dt / substeps of one env's
    `accel(q, q̇, τ) -> q̈`, batched over the envs, then the coordinates from
    `wrap_from` on wrapped. The step runs `rk4_substep` over the traced q̈
    (`accel`); `traced_substep`, the whole RK4 substep traced as one graph,
    computes the same."""

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

    def substep(self, q: torch.Tensor, qd: torch.Tensor,
                tau: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return rk4_substep(self.accel, q, qd, tau, self.h, self.max_speed)

    def trace_seconds(self) -> Dict[Tuple, float]:
        """Seconds each trace of q̈ took, by its inputs' (shape, dtype, device)."""
        return dict(self.accel.seconds)

    def __call__(self, q: torch.Tensor, qd: torch.Tensor,
                 tau: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for _ in range(self.substeps):
            q, qd = self.substep(q, qd, tau)
        return wrap_angles(q, self.wrap_from), qd
