"""Episode rendering: env states to RGB frames and animated GIFs (port of
`mava_tpu/envs/render.py`).

Pure numpy + PIL raster drawing, one viewer per env family: the grid worlds
(RWARE, LBF, Cleaner, MaConnector), SMAX, MaSwarm, Gigastep, MaReacher, the
planar articulated envs (side-view stick figures) and the 3D point-cloud
envs (side-view projection). The port's states are batched over envs:
`render_frame(env, state, index)` draws env `index`, taking its tensors to
numpy at this module's edge. PIL is imported where a frame is drawn, so the
module imports without it. `rollout_episode` drives one env of a batch of
one with any act fn (see `mava_tpu_torch/examples/render_episode.py`).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

# Agent palette (distinct, colourblind-safe-ish).
AGENT_COLORS = [
    (31, 119, 180),
    (255, 127, 14),
    (44, 160, 44),
    (214, 39, 40),
    (148, 103, 189),
    (140, 86, 75),
    (227, 119, 194),
    (127, 127, 127),
    (188, 189, 34),
    (23, 190, 207),
]

BG = (250, 250, 250)
GRID_LINE = (225, 225, 225)


def unwrap_env(env: Any) -> Any:
    """Follow the wrapper chain to the base engine."""
    while hasattr(env, "_env"):
        env = env._env
    return env


def unwrap_state(state: Any) -> Any:
    """Follow wrapper states (e.g. RecordEpisodeMetricsState) to the base state."""
    while hasattr(state, "env_state"):
        state = state.env_state
    return state


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _canvas(rows: int, cols: int, scale: int):
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (cols * scale, rows * scale), BG)
    draw = ImageDraw.Draw(img)
    for r in range(rows + 1):
        draw.line([(0, r * scale), (cols * scale, r * scale)], fill=GRID_LINE)
    for c in range(cols + 1):
        draw.line([(c * scale, 0), (c * scale, rows * scale)], fill=GRID_LINE)
    return img, draw


def _cell(draw, r: int, c: int, scale: int, color, inset: int = 1) -> None:
    draw.rectangle(
        [c * scale + inset, r * scale + inset, (c + 1) * scale - inset, (r + 1) * scale - inset],
        fill=color,
    )


def _disc(draw, r: float, c: float, scale: int, color, shrink: float = 0.12,
          outline=None) -> None:
    pad = scale * shrink
    draw.ellipse(
        [c * scale + pad, r * scale + pad, (c + 1) * scale - pad, (r + 1) * scale - pad],
        fill=color,
        outline=outline,
        width=2 if outline else 0,
    )


def _text(draw, r: float, c: float, scale: int, s: str, color=(255, 255, 255)):
    draw.text((c * scale + scale * 0.36, r * scale + scale * 0.22), s, fill=color)


def _render_rware(env: Any, state: Any, scale: int = 32) -> np.ndarray:
    img, draw = _canvas(env.height, env.width, scale)
    storage = _np(env._storage_flat).reshape(env.height, env.width)
    goal_flat = _np(env._goal_flat)
    goals = np.stack([goal_flat // env.width, goal_flat % env.width], axis=-1)
    requested = state.shelf_requested
    carrying = state.agent_carrying

    for r, c in np.argwhere(storage):
        _cell(draw, r, c, scale, (235, 235, 235))
    for r, c in goals:
        _cell(draw, r, c, scale, (180, 220, 180))
    # A carried shelf rides on its agent: the engine keeps shelf_pos at its cell.
    for sid, (r, c) in enumerate(state.shelf_pos):
        color = (240, 150, 60) if requested[sid] else (120, 120, 130)
        _cell(draw, r, c, scale, color, inset=scale // 5)
    for aid, (r, c) in enumerate(state.agent_pos):
        _disc(draw, r, c, scale, AGENT_COLORS[aid % len(AGENT_COLORS)],
              outline=(60, 20, 90) if carrying[aid] >= 0 else None)
    return np.asarray(img)


def _render_lbf(env: Any, state: Any, scale: int = 32) -> np.ndarray:
    img, draw = _canvas(env.grid_size, env.grid_size, scale)
    for fid, (r, c) in enumerate(state.food_pos):
        if state.food_eaten[fid]:
            continue
        _disc(draw, r, c, scale, (80, 160, 60), shrink=0.2)
        _text(draw, r, c, scale, str(int(state.food_level[fid])))
    for aid, (r, c) in enumerate(state.agent_pos):
        _disc(draw, r, c, scale, AGENT_COLORS[aid % len(AGENT_COLORS)])
        _text(draw, r, c, scale, str(int(state.agent_level[aid])))
    return np.asarray(img)


def _render_cleaner(env: Any, state: Any, scale: int = 32) -> np.ndarray:
    img, draw = _canvas(env.num_rows, env.num_cols, scale)
    for r, c in np.argwhere(state.dirty):
        _cell(draw, r, c, scale, (150, 110, 70))
    for aid, (r, c) in enumerate(state.agent_pos):
        _disc(draw, r, c, scale, AGENT_COLORS[aid % len(AGENT_COLORS)])
    return np.asarray(img)


def _render_connector(env: Any, state: Any, scale: int = 32) -> np.ndarray:
    img, draw = _canvas(env.grid_size, env.grid_size, scale)
    for r, c in np.argwhere(state.paths):
        _cell(draw, r, c, scale, (205, 205, 215))
    for aid, (r, c) in enumerate(state.target_pos):
        color = AGENT_COLORS[aid % len(AGENT_COLORS)]
        _cell(draw, r, c, scale, tuple(min(255, v + 80) for v in color), inset=scale // 4)
    for aid, (r, c) in enumerate(state.head_pos):
        _disc(draw, r, c, scale, AGENT_COLORS[aid % len(AGENT_COLORS)],
              outline=(30, 120, 30) if state.connected[aid] else None)
    return np.asarray(img)


def _render_smax(env: Any, state: Any, scale: int = 18) -> np.ndarray:
    from mava_tpu_torch.envs.smax import MAP_HEIGHT, MAP_WIDTH

    img, draw = _canvas(int(MAP_HEIGHT), int(MAP_WIDTH), scale)
    pos, hp = state.unit_pos, state.unit_hp  # (N, 2) as (x, y); (N,)
    max_hp = _np(env._stats)[state.unit_types, 0]
    for i in range(pos.shape[0]):
        if hp[i] <= 0:
            continue
        x, y = pos[i]
        ally = i < env.num_agents
        frac = float(np.clip(hp[i] / max(max_hp[i], 1e-6), 0.0, 1.0))
        base = (40, 90, 200) if ally else (200, 60, 50)
        color = tuple(int(v * (0.45 + 0.55 * frac)) for v in base)
        # y grows upward in SMAX; image rows grow downward.
        _disc(draw, MAP_HEIGHT - 1 - y, x, scale, color, outline=(20, 20, 20) if ally else None)
    return np.asarray(img)


def _render_maswarm(env: Any, state: Any, scale: int = 60) -> np.ndarray:
    # Positions live roughly in [-1.5, 1.5]^2: a canvas of 10 x 10 cells.
    cells, lo, hi = 10, -1.5, 1.5
    img, draw = _canvas(cells, cells, scale)

    def to_cell(p):
        return np.clip((p - lo) / (hi - lo), 0, 0.999) * cells

    # y grows upward in the arena; image rows grow downward.
    for p in state.landmarks:
        cx, cy = to_cell(p)
        _disc(draw, cells - cy - 0.5, cx - 0.5, scale, (120, 170, 120), shrink=0.33)
    for aid, p in enumerate(state.pos):
        cx, cy = to_cell(p)
        _disc(draw, cells - cy - 0.5, cx - 0.5, scale, AGENT_COLORS[aid % len(AGENT_COLORS)],
              shrink=0.28)
    return np.asarray(img)


def _line(draw, p0, p1, color, width=4):
    draw.line([tuple(p0), tuple(p1)], fill=color, width=width)


def _planar_segments(env: Any, q: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """((L, 2) starts, (L, 2) steps) of the links in the world frame: a tree
    (cheetah, walker) from `_frames`, a chain (hopper, swimmer) from
    `_body_frame`."""
    if hasattr(env, "_frames"):
        starts, steps, _ = env._frames(q)
        return _np(starts), _np(steps)
    centers, phi = env._body_frame(q)
    steps = env.link_lengths[:, None] * torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    return _np(centers - 0.5 * steps), _np(steps)


def _joint_agent_colors(env: Any, n_links: int) -> list:
    """Link i in the colour of the agent owning joint i - 1 (link 0, the torso, grey)."""
    jpa = getattr(env, "joints_per_agent", 1)
    return [(90, 90, 100)] + [AGENT_COLORS[(j // jpa) % len(AGENT_COLORS)]
                              for j in range(n_links - 1)]


def _render_planar_locomotion(env: Any, state: Any, scale: int = 60) -> np.ndarray:
    """Side view of hopper, walker, cheetah and swimmer: the camera follows
    the base, the ground line is y = 0, links in their agent's colour."""
    from PIL import Image, ImageDraw

    W, H = 480, 360
    img = Image.new("RGB", (W, H), BG)
    draw = ImageDraw.Draw(img)
    starts, steps = _planar_segments(env, state.q_tensor)
    base = state.q[:2]

    def to_px(p):
        return (W / 2 + (p[0] - base[0]) * scale, H * 0.8 - p[1] * scale)

    draw.line([(0, H * 0.8), (W, H * 0.8)], fill=(160, 160, 160), width=2)
    colors = _joint_agent_colors(env, starts.shape[0])
    for i in range(starts.shape[0]):
        _line(draw, to_px(starts[i]), to_px(starts[i] + steps[i]), colors[i], width=6)
    ex, ey = to_px(base)
    draw.ellipse([ex - 5, ey - 5, ex + 5, ey + 5], fill=(30, 30, 30))
    return np.asarray(img)


def _render_mareacher(env: Any, state: Any, scale: int = 140) -> np.ndarray:
    from PIL import Image, ImageDraw

    W = H = 400
    img = Image.new("RGB", (W, H), BG)
    draw = ImageDraw.Draw(img)

    def to_px(p):
        return (W / 2 + p[0] * scale, H / 2 - p[1] * scale)

    phi = torch.cumsum(state.q_tensor, 0)
    u = torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    ends = _np(torch.cumsum(env.link_lengths[:, None] * u, 0))
    pts = np.concatenate([np.zeros((1, 2)), ends], axis=0)
    tx, ty = to_px(state.target)
    draw.ellipse([tx - 8, ty - 8, tx + 8, ty + 8], fill=(200, 60, 50))
    jpa = getattr(env, "joints_per_agent", 1)
    for i in range(pts.shape[0] - 1):
        _line(draw, to_px(pts[i]), to_px(pts[i + 1]),
              AGENT_COLORS[(i // jpa) % len(AGENT_COLORS)], width=7)
    return np.asarray(img)


def _render_pointcloud3d(env: Any, state: Any, scale: int = 90) -> np.ndarray:
    """Side view (x right, z up) of the 3D point-cloud envs (MaAnt,
    MaHumanoid): mass points as discs, the far ones smaller and lighter."""
    from PIL import Image, ImageDraw

    W, H = 480, 360
    img = Image.new("RGB", (W, H), BG)
    draw = ImageDraw.Draw(img)
    pts = _np(env._points(state.q_tensor))  # (P, 3)
    cx = float(state.q[0])

    def to_px(x, z):
        return (W / 2 + (x - cx) * scale, H * 0.85 - z * scale)

    draw.line([(0, H * 0.85), (W, H * 0.85)], fill=(160, 160, 160), width=2)
    for i in np.argsort(pts[:, 1]):  # far (small y) first
        x, y, z = pts[i]
        px, py = to_px(x, z)
        depth = (y - pts[:, 1].min()) / (np.ptp(pts[:, 1]) + 1e-6)
        r = 4 + 2 * depth
        shade = int(140 - 60 * depth)
        draw.ellipse([px - r, py - r, px + r, py + r], fill=(shade, shade, 200))
    return np.asarray(img)


def _render_gigastep(env: Any, state: Any, scale: int = 44) -> np.ndarray:
    from mava_tpu_torch.envs.gigastep import _ARENA

    img, draw = _canvas(int(_ARENA), int(_ARENA), scale)
    wx, wy = state.waypoint
    if getattr(env, "scenario", "") == "waypoint":
        _disc(draw, _ARENA - 1 - wy, wx, scale, (120, 170, 120), shrink=0.25)
    for team, active, color in (
        (state.team_pos, state.team_active, (40, 90, 200)),
        (state.adv_pos, state.adv_active, (200, 60, 50)),
    ):
        for i in range(team.shape[0]):
            if active[i]:
                x, y = team[i]
                _disc(draw, _ARENA - 1 - y, x, scale, color, shrink=0.3)
    return np.asarray(img)


_RENDERERS = {
    "RobotWarehouse": _render_rware,
    "LevelBasedForaging": _render_lbf,
    "Cleaner": _render_cleaner,
    "MaConnector": _render_connector,
    "Smax": _render_smax,
    "MaSwarm": _render_maswarm,
    "MaReacher": _render_mareacher,
    "MaSwimmer": _render_planar_locomotion,
    "MaHopper": _render_planar_locomotion,
    "MaWalker": _render_planar_locomotion,
    "MaCheetah": _render_planar_locomotion,
    "MaAnt": _render_pointcloud3d,
    "MaHumanoid": _render_pointcloud3d,
    "Gigastep": _render_gigastep,
}


class _OneEnv:
    """Env `index` of a batched state: every field as numpy, and the joint
    angles `q` also as the tensor the env's kinematics take."""

    def __init__(self, state: Any, index: int):
        for name, value in state._asdict().items():
            setattr(self, name, _np(value[index]))
        if hasattr(state, "q"):
            self.q_tensor = state.q[index].detach().cpu()


def render_frame(env: Any, state: Any, index: int = 0) -> np.ndarray:
    """Render env `index` of a batched state to an RGB uint8 frame. Raises
    KeyError for an env family without a viewer (Matrax, a matrix game with
    no spatial state)."""
    base_env = unwrap_env(env)
    name = type(base_env).__name__
    if name not in _RENDERERS:
        raise KeyError(f"no renderer registered for {name!r} (available: {sorted(_RENDERERS)})")
    with torch.no_grad():
        return _RENDERERS[name](base_env, _OneEnv(unwrap_state(state), index))


def rollout_episode(
    env: Any,
    act_fn: Callable[[Any, torch.Generator], torch.Tensor],
    generator: torch.Generator,
    max_steps: Optional[int] = None,
) -> Tuple[List[np.ndarray], float]:
    """Roll out one episode of a batch of one env, rendering every state.

    `act_fn(timestep, generator)` -> the actions of the batch (1, A, ...).
    Returns (frames, episode return). A host loop: a viewer, not a training
    path."""
    max_steps = max_steps or getattr(unwrap_env(env), "time_limit", 200)
    state, timestep = env.reset(env.reset_noise(1, generator))
    frames = [render_frame(env, state)]
    total = 0.0
    for _ in range(max_steps):
        with torch.no_grad():
            action = act_fn(timestep, generator)
            state, timestep = env.step(state, action, env.step_noise(1, generator))
        frames.append(render_frame(env, state))
        total += float(timestep.reward.mean())
        if bool(timestep.last()[0]):
            break
    return frames, total


def save_gif(frames: List[np.ndarray], path: str, fps: int = 8) -> str:
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=int(1000 / fps), loop=0)
    return path
