"""Feed-forward and recurrent actor and critic (port of
`mava_tpu/networks/actor_critic.py`).

The critics come in two kinds: on the agent's own view, or centralised on
`observation.global_state` (CTDE), which only an `ObservationGlobalState` has.

`ScannedRNN` keeps the reference's parameter layout: `wi` (F,3H), `bi` (3H),
`wh` (H,3H) and `bhn` (H) are raw parameters in JAX's (in, out) layout, which
is the layout the GRU kernel takes. The input projection for every step is one
matmul ahead of the recurrence (the reference's "hoisted" scan).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from mava_tpu_torch.networks.torsos import MLPTorso, orthogonal_linear
from mava_tpu_torch.ops.gru import gru_sequence
from mava_tpu_torch.types import ObservationGlobalState

# `network.gru_impl` values: "auto" resolves per device; "pallas" is the GRU
# kernel (hand-written CUDA in this port); "hoisted" and "cell" are the plain
# PyTorch recurrence.
_PLAIN_IMPLS = ("hoisted", "cell")


def resolve_gru_impl(impl: Optional[str], device: torch.device) -> str:
    """"auto" -> "pallas" (the kernel) on CUDA, "hoisted" (plain scan) on CPU."""
    impl = impl or "auto"
    if impl == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "hoisted"
    if impl != "pallas" and impl not in _PLAIN_IMPLS:
        raise ValueError(f"Unknown gru_impl {impl!r} (auto | pallas | hoisted | cell)")
    return impl


def _critic_input(observation, centralised_critic: bool) -> torch.Tensor:
    if not centralised_critic:
        return observation.agents_view
    if not isinstance(observation, ObservationGlobalState):
        raise ValueError("Centralised critic requires a global state.")
    return observation.global_state


class FeedForwardActor(nn.Module):
    """torso(agents_view) -> action_head(embedding, obs)."""

    def __init__(self, torso: MLPTorso, action_head: nn.Module):
        super().__init__()
        self.torso = torso
        self.action_head = action_head

    def forward(self, observation):
        return self.action_head(self.torso(observation.agents_view), observation)


class FeedForwardValueNet(nn.Module):
    """V(obs); the centralised variant reads the global state."""

    def __init__(self, torso: MLPTorso, centralised_critic: bool = False):
        super().__init__()
        self.torso = torso
        self.centralised_critic = centralised_critic
        self.value_head = orthogonal_linear(torso.out_features, 1, 1.0)

    def forward(self, observation) -> torch.Tensor:
        x = _critic_input(observation, self.centralised_critic)
        return self.value_head(self.torso(x)).squeeze(-1)


def lecun_normal_(w: torch.Tensor) -> torch.Tensor:
    """flax `lecun_normal`: a normal truncated at 2 std, rescaled to variance
    1/fan_in (fan_in = w.shape[0] in the (in, out) layout)."""
    std = math.sqrt(1.0 / w.shape[0]) / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std)


def _blockwise_orthogonal_(w: torch.Tensor) -> torch.Tensor:
    """Init a (H, 3H) recurrent kernel as 3 independent orthogonal (H, H) blocks
    (reference `_blockwise_orthogonal`, :85-96)."""
    h = w.shape[0]
    if w.shape[1] != 3 * h:
        raise ValueError("fused recurrent kernel must be (h, 3h)")
    with torch.no_grad():
        for g in range(3):
            nn.init.orthogonal_(w[:, g * h : (g + 1) * h])
    return w


class ScannedRNN(nn.Module):
    """GRU over the leading (time) axis, with the carry reset where `resets` is set.

    forward(carry (B..., H), inputs (T, B..., F), resets (T, B...)) returns
    (final carry, ys (T, B..., H)); with `collect_carries` ys becomes
    (carries, ys), where carries[t] is step t's input carry before the reset:
    [h0, hs[:-1]].
    """

    def __init__(self, in_features: int, hidden_state_dim: int = 128,
                 gru_impl: Optional[str] = None):
        super().__init__()
        h = hidden_state_dim
        self.hidden_state_dim = h
        self.gru_impl = gru_impl
        self.wi = nn.Parameter(lecun_normal_(torch.empty(in_features, 3 * h)))
        self.bi = nn.Parameter(torch.zeros(3 * h))
        self.wh = nn.Parameter(_blockwise_orthogonal_(torch.empty(h, 3 * h)))
        self.bhn = nn.Parameter(torch.zeros(h))

    def forward(
        self,
        carry: torch.Tensor,
        ins: torch.Tensor,
        resets: torch.Tensor,
        collect_carries: bool = False,
    ):
        hidden = self.hidden_state_dim
        impl = resolve_gru_impl(self.gru_impl, ins.device)
        gates_i = ins @ self.wi + self.bi  # every step's input gates in one matmul
        t_len = ins.shape[0]
        lead = ins.shape[1:-1]

        # The kernel runs on real sequences; T == 1 (the per-env-step rollout)
        # stays on the plain path, as in the reference (:261-264).
        if impl == "pallas" and t_len > 1:
            gi = gates_i.reshape(t_len, -1, 3 * hidden)
            keep = (1.0 - resets.to(torch.float32)).reshape(t_len, -1, 1)
            keep = keep.expand(*gi.shape[:2], hidden).contiguous()
            h0 = carry.reshape(-1, hidden).contiguous()
            hs = gru_sequence(gi, keep, h0, self.wh, self.bhn)
            final_h = hs[-1].reshape(*lead, hidden)
            ys = hs.reshape(t_len, *lead, hidden)
            if collect_carries:
                carries = torch.cat([h0[None], hs[:-1]], dim=0)
                return final_h, (carries.reshape(t_len, *lead, hidden), ys)
            return final_h, ys

        h = carry
        carries, ys = [], []
        for t in range(t_len):
            carries.append(h)
            h_in = torch.where(resets[t][..., None], 0.0, h)
            xr, xz, xn = gates_i[t].chunk(3, dim=-1)
            hr, hz, hn = (h_in @ self.wh).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * (hn + self.bhn))
            h = (1.0 - z) * n + z * h_in
            ys.append(h)
        if collect_carries:
            return h, (torch.stack(carries), torch.stack(ys))
        return h, torch.stack(ys)

    @staticmethod
    def initialize_carry(batch_shape, hidden_size: int, device=None) -> torch.Tensor:
        return torch.zeros((*batch_shape, hidden_size), dtype=torch.float32, device=device)


class RecurrentActor(nn.Module):
    """pre_torso -> GRU -> post_torso -> action head."""

    def __init__(self, pre_torso: MLPTorso, post_torso: MLPTorso, action_head: nn.Module,
                 hidden_state_dim: int = 128, gru_impl: Optional[str] = None):
        super().__init__()
        self.pre_torso = pre_torso
        self.rnn = ScannedRNN(pre_torso.out_features, hidden_state_dim, gru_impl)
        self.post_torso = post_torso
        self.action_head = action_head

    def forward(self, policy_hidden_state: torch.Tensor, observation_done: Tuple):
        observation, done = observation_done
        embedding = self.pre_torso(observation.agents_view)
        policy_hidden_state, embedding = self.rnn(policy_hidden_state, embedding, done)
        embedding = self.post_torso(embedding)
        return policy_hidden_state, self.action_head(embedding, observation)


class RecurrentValueNet(nn.Module):
    """Recurrent V(obs); the centralised variant reads the global state.

    With `collect_carries` the call returns
    `(final_hidden, (per_step_input_hidden, values))`; the parameters are the
    same either way.
    """

    def __init__(self, pre_torso: MLPTorso, post_torso: MLPTorso,
                 hidden_state_dim: int = 128, gru_impl: Optional[str] = None,
                 centralised_critic: bool = False):
        super().__init__()
        self.pre_torso = pre_torso
        self.centralised_critic = centralised_critic
        self.rnn = ScannedRNN(pre_torso.out_features, hidden_state_dim, gru_impl)
        self.post_torso = post_torso
        self.value_head = orthogonal_linear(post_torso.out_features, 1, 1.0)

    def forward(self, value_hidden_state: torch.Tensor, observation_done: Tuple,
                collect_carries: bool = False):
        observation, done = observation_done
        embedding = self.pre_torso(_critic_input(observation, self.centralised_critic))
        value_hidden_state, rnn_out = self.rnn(
            value_hidden_state, embedding, done, collect_carries=collect_carries
        )
        carries, embedding = rnn_out if collect_carries else (None, rnn_out)
        value = self.value_head(self.post_torso(embedding)).squeeze(-1)
        if collect_carries:
            return value_hidden_state, (carries, value)
        return value_hidden_state, value
