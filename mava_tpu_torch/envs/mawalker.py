"""MaWalker: a planar biped, one leg per agent, batched over a leading env
axis (port of `mava_tpu/envs/mawalker.py`).

walker2d-2x3 is MaCheetah's kinematic tree with another body: a vertical torso
whose bottom end carries two three-link legs (thigh, shin, foot), agent 0 the
right leg and agent 1 the left. Knees bend backward only, feet stay near flat.
The shared team reward is the forward velocity plus 1 for being healthy minus
0.001 Σa²; the episode terminates (discount 0) when the torso drops below
`min_torso_height` or pitches past `max_pitch`.
"""

from __future__ import annotations

import math

import torch

from mava_tpu_torch.envs.macheetah import MaCheetah

# link: (name, parent, anchor fraction on the parent, length, rest angle offset)
_WALKER_TOPOLOGY = (
    ("torso", -1, 0.0, 0.40, 0.0),
    ("rthigh", 0, 1.0, 0.45, 0.0),
    ("rshin", 1, 1.0, 0.50, 0.0),
    ("rfoot", 2, 1.0, 0.20, math.pi / 2),
    ("lthigh", 0, 1.0, 0.45, 0.0),
    ("lshin", 4, 1.0, 0.50, 0.0),
    ("lfoot", 5, 1.0, 0.20, math.pi / 2),
)


class MaWalker(MaCheetah):
    """Batched MaWalker on one device."""

    TOPOLOGY = _WALKER_TOPOLOGY
    JOINT_LO = (-1.0, -2.0, -0.6, -1.0, -2.0, -0.6)
    JOINT_HI = (1.0, 0.05, 0.6, 1.0, 0.05, 0.6)
    DEFAULT_TORQUE = 30.0
    CTRL_COST = 1e-3
    HEALTHY_BONUS = 1.0
    TORSO_REST = -math.pi / 2

    def __init__(self, num_agents: int = 2, joints_per_agent: int = 3, time_limit: int = 250,
                 min_torso_height: float = 0.75, max_pitch: float = 0.8, **kwargs):
        super().__init__(num_agents, joints_per_agent, time_limit, **kwargs)
        self.min_torso_height = float(min_torso_height)
        self.max_pitch = float(max_pitch)

    def _terminated(self, q: torch.Tensor) -> torch.Tensor:
        torso_y = self._body_frame(q)[0][0, 1]
        pitch = torch.atan2(torch.sin(q[2] - self.TORSO_REST), torch.cos(q[2] - self.TORSO_REST))
        return (torso_y < self.min_torso_height) | (torch.abs(pitch) > self.max_pitch)
