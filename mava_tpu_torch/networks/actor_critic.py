"""Feed-forward and recurrent actor and critic, and the recurrent Q-network
(port of `mava_tpu/networks/actor_critic.py`).

The critics come in two kinds: on the agent's own view, or centralised on
`observation.global_state` (CTDE), which only an `ObservationGlobalState` has.
So does SAC's `FeedForwardQNet`, which also reads an action (MASAC's
centralised one reads the joint action).

`ScannedRNN` keeps the reference's parameter layout: `wi` (F,3H), `bi` (3H),
`wh` (H,3H) and `bhn` (H) are raw parameters in JAX's (in, out) layout, which
is the layout the GRU kernel takes. The input projection for every step is one
matmul ahead of the recurrence (the reference's "hoisted" scan).

`RecQNetwork.stacked_q_values` is rec-IQL's fused target pass: the online and
the target network over the same inputs as one pass over a stack of two
(`StackedNetwork`), the torsos and heads vmapped over their stacked
parameters (batched products) and the recurrence as one launch of the stacked
GRU kernel (the reference vmaps `get_q_values` over stacked params).

`StackedNetwork` is S networks of one structure as one, for the programs that
`jax.vmap` a whole learner over seeds, learning rates or a PBT population
(`mava_tpu/advanced_usage/`): their parameters stacked on a leading axis as
leaf tensors, the torsos and heads vmapped over them (batched products) and a
recurrence as one launch of the stacked GRU kernel, forward and backward, each
entry with its own resets. One call serves all S entries, so the launches of a
pass do not grow with S.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils import _pytree as pytree

from mava_tpu_torch.distributions import Categorical, MaskedEpsGreedy, TanhNormal
from mava_tpu_torch.networks.torsos import MLPTorso, lecun_normal_, orthogonal_linear
from mava_tpu_torch.ops.gru import gru_sequence, gru_sequence_stacked
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


class FeedForwardQNet(nn.Module):
    """Q(obs, action) for continuous control (reference `actor_critic.py:61-81`):
    the torso on concat([x, action]), then Dense(1) (orthogonal 1.0). `x` is
    the agent's view, or the global state when centralised; `in_features` is
    the width of that concatenation."""

    def __init__(self, torso: MLPTorso, centralised_critic: bool = False):
        super().__init__()
        self.torso = torso
        self.centralised_critic = centralised_critic
        self.q_head = orthogonal_linear(torso.out_features, 1, 1.0)

    def forward(self, observation, action: torch.Tensor) -> torch.Tensor:
        x = torch.cat([_critic_input(observation, self.centralised_critic), action], dim=-1)
        return self.q_head(self.torso(x)).squeeze(-1)


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
        gates_i = ins @ self.wi + self.bi  # every step's input gates in one matmul
        t_len = ins.shape[0]
        lead = ins.shape[1:-1]
        # Resets may broadcast over trailing axes (rec-IQL's are (T, B, 1)).
        resets = torch.broadcast_to(resets, ins.shape[:-1])

        if self.uses_kernel(ins.device, t_len):
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

        return plain_gru(carry, gates_i, resets, self.wh, self.bhn, collect_carries)

    def uses_kernel(self, device: torch.device, t_len: int) -> bool:
        """Whether a sequence of `t_len` steps goes to the GRU kernel: with
        gru_impl "pallas", for real sequences; T == 1 (the per-env-step rollout)
        stays on the plain path, as in the reference (:261-264)."""
        return resolve_gru_impl(self.gru_impl, device) == "pallas" and t_len > 1

    def plain_recurrence(self, carry, gates_i, resets, collect_carries: bool = False):
        """The plain loop over time on precomputed input gates."""
        return plain_gru(carry, gates_i, resets, self.wh, self.bhn, collect_carries)

    @staticmethod
    def initialize_carry(batch_shape, hidden_size: int, device=None) -> torch.Tensor:
        return torch.zeros((*batch_shape, hidden_size), dtype=torch.float32, device=device)


def plain_gru(carry, gates_i, resets, wh, bhn, collect_carries: bool = False):
    """The plain GRU loop over time on precomputed input gates (the body of
    `ScannedRNN.plain_recurrence`, a function of the weights so that it can be
    vmapped over stacked ones)."""
    h = carry
    carries, ys = [], []
    for t in range(gates_i.shape[0]):
        carries.append(h)
        h_in = torch.where(resets[t][..., None], 0.0, h)
        xr, xz, xn = gates_i[t].chunk(3, dim=-1)
        hr, hz, hn = (h_in @ wh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * (hn + bhn))
        h = (1.0 - z) * n + z * h_in
        ys.append(h)
    if collect_carries:
        return h, (torch.stack(carries), torch.stack(ys))
    return h, torch.stack(ys)


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


class RecQNetwork(nn.Module):
    """pre_torso -> GRU -> post_torso -> Dense (orthogonal 0.01) Q-values, with
    an epsilon-greedy distribution over the masked Q-values (reference
    `networks/actor_critic.py:376-407`)."""

    def __init__(self, pre_torso: MLPTorso, post_torso: MLPTorso, num_actions: int,
                 hidden_state_dim: int = 128, gru_impl: Optional[str] = None):
        super().__init__()
        self.pre_torso = pre_torso
        self.rnn = ScannedRNN(pre_torso.out_features, hidden_state_dim, gru_impl)
        self.post_torso = post_torso
        self.q_head = orthogonal_linear(post_torso.out_features, num_actions, 0.01)

    def get_q_values(self, hidden_state: torch.Tensor, observations_resets: Tuple):
        """(final hidden state, Q-values (T, B..., actions))."""
        obs, resets = observations_resets
        embedding = self.pre_torso(obs.agents_view)
        hidden_state, embedding = self.rnn(hidden_state, embedding, resets)
        return hidden_state, self.q_head(self.post_torso(embedding))

    def forward(self, hidden_state: torch.Tensor, observations_resets: Tuple, eps=0.0):
        obs, _ = observations_resets
        hidden_state, q_values = self.get_q_values(hidden_state, observations_resets)
        return hidden_state, MaskedEpsGreedy(q_values, eps, obs.action_mask)

    @staticmethod
    @torch.no_grad()
    def stacked_q_values(online: "RecQNetwork", target: "RecQNetwork",
                         hidden_state: torch.Tensor, observations_resets: Tuple) -> torch.Tensor:
        """`get_q_values` of `online` and of `target` on the same inputs and initial
        hidden state, as one pass over a stack of the two (`StackedNetwork`):
        Q-values (2, T, B..., actions). No gradient. With the kernel (gru_impl
        "pallas", T > 1) the recurrence of both is one launch of the stacked GRU
        kernel; otherwise the plain loop, vmapped."""
        obs, resets = observations_resets
        twice = lambda x: torch.stack([x, x])  # noqa: E731
        _, q_values = StackedNetwork([online, target]).get_q_values(
            twice(hidden_state), (obs._replace(agents_view=twice(obs.agents_view)), twice(resets)))
        return q_values


class StackedNetwork:
    """S networks of one structure as one (`FeedForwardActor` with a discrete
    or a continuous head, `FeedForwardValueNet`, `RecurrentActor`,
    `RecurrentValueNet`, `FeedForwardQNet` or `RecQNetwork`, centralised
    critics included).

    `params` maps each parameter name of the structure to the S entries'
    values stacked on a leading axis, leaf tensors that an optimizer steps in
    place (`parameters()`, in the structure's order). A call takes every input
    with the stack axis in front and returns every output so:
      * feed-forward actor: obs (S, ...) -> a distribution over (S, ...);
      * feed-forward critic: obs (S, ...) -> values (S, ...);
      * Q-network: (obs, action) (S, ...) -> Q-values (S, ...);
      * recurrent actor: (h (S, B.., H), (obs, done) (S, T, B.., ...)) ->
        (final h, distribution); the recurrent critic likewise with values and
        `collect_carries`, as `RecurrentValueNet`;
      * recurrent Q-network: (h, (obs, resets), eps) -> (final h, the
        epsilon-greedy distribution), and `get_q_values`, as `RecQNetwork`.
    The gradient of a loss that sums the entries' losses is each entry's own.
    A recurrence of T > 1 steps with `gru_impl` "pallas" is one call of
    `gru_sequence_stacked` with per-entry resets; otherwise the plain loop,
    vmapped. `entry(s)` is entry s as a module of the structure (a copy).
    `concat` joins stacks of one structure into one (rec-IQL's fused target
    pass runs its online and target stacks as one).
    """

    def __init__(self, modules: Sequence[nn.Module]):
        self.module = modules[0]
        params, buffers = torch.func.stack_module_state(list(modules))
        self.params: Dict[str, torch.Tensor] = params
        self.buffers: Dict[str, torch.Tensor] = buffers
        self.size = len(modules)
        self._kinds()

    def _kinds(self) -> None:
        self.recurrent = isinstance(self.module, (RecurrentActor, RecurrentValueNet, RecQNetwork))
        self.is_actor = isinstance(self.module, (FeedForwardActor, RecurrentActor))

    @classmethod
    def concat(cls, stacks: Sequence["StackedNetwork"]) -> "StackedNetwork":
        """The entries of `stacks` (one structure) as one stack, in order: new
        tensors, not leaves that an optimizer steps."""
        joined = cls.__new__(cls)
        joined.module = stacks[0].module
        joined.params = {k: torch.cat([s.params[k] for s in stacks]) for k in stacks[0].params}
        joined.buffers = {k: torch.cat([s.buffers[k] for s in stacks]) for k in stacks[0].buffers}
        joined.size = sum(s.size for s in stacks)
        joined._kinds()
        return joined

    def parameters(self):
        return list(self.params.values())

    def entry(self, s: int) -> nn.Module:
        """A copy of the structure holding entry s's parameters."""
        module = copy.deepcopy(self.module)
        with torch.no_grad():
            module.load_state_dict(
                {k: v[s] for k, v in {**self.params, **self.buffers}.items()}, strict=True)
        return module

    def _sub(self, prefix: str):
        pick = lambda d: {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}  # noqa: E731
        return pick(self.params), pick(self.buffers)

    def _vcall(self, name: str, *args, in_dims=None, post=None):
        """Submodule `name` of every entry on its inputs, vmapped over the stack;
        `post` maps the submodule's output inside the vmap (to tensors)."""
        module = getattr(self.module, name)
        params, buffers = self._sub(name + ".")

        def call(p, b, *a):
            out = torch.func.functional_call(module, (p, b), a)
            return post(out) if post else out

        dims = in_dims if in_dims is not None else (0,) * len(args)
        return torch.func.vmap(call, in_dims=(0, 0, *dims))(params, buffers, *args)

    def _distribution(self, raw):
        if isinstance(raw, tuple):
            return TanhNormal(*raw)
        return Categorical(raw)

    def _head(self, embedding, observation):
        if self.is_actor:
            raw = self._vcall("action_head", embedding, observation,
                              post=lambda pi: pi.raw_params())
            return self._distribution(raw)
        return self._vcall("value_head", embedding).squeeze(-1)

    def __call__(self, *args, collect_carries: bool = False):
        if isinstance(self.module, RecQNetwork):
            hidden, observations_resets, *eps = args
            hidden, q_values = self.get_q_values(hidden, observations_resets)
            mask = observations_resets[0].action_mask
            return hidden, MaskedEpsGreedy(q_values, eps[0] if eps else 0.0, mask)
        if isinstance(self.module, FeedForwardQNet):
            observation, action = args
            x = torch.cat([_critic_input(observation, self.module.centralised_critic), action],
                          dim=-1)
            return self._vcall("q_head", self._vcall("torso", x)).squeeze(-1)
        if not self.recurrent:
            (observation,) = args
            x = observation.agents_view if self.is_actor else _critic_input(
                observation, self.module.centralised_critic)
            return self._head(self._vcall("torso", x), observation)
        hidden, (observation, done) = args
        x = observation.agents_view if self.is_actor else _critic_input(
            observation, self.module.centralised_critic)
        embedding = self._vcall("pre_torso", x)
        hidden, out = self._recurrence(hidden, embedding, done, collect_carries)
        carries, embedding = out if collect_carries else (None, out)
        embedding = self._vcall("post_torso", embedding)
        result = self._head(embedding, observation)
        if collect_carries:
            return hidden, (carries, result)
        return hidden, result

    def get_q_values(self, hidden: torch.Tensor, observations_resets: Tuple):
        """`RecQNetwork.get_q_values` of every entry: (final hidden (S, B.., H),
        Q-values (S, T, B.., actions))."""
        obs, resets = observations_resets
        embedding = self._vcall("pre_torso", obs.agents_view)
        hidden, embedding = self._recurrence(hidden, embedding, resets, False)
        return hidden, self._vcall("q_head", self._vcall("post_torso", embedding))

    @staticmethod
    @torch.no_grad()
    def stacked_q_values(online: "StackedNetwork", target: "StackedNetwork",
                         hidden_state: torch.Tensor, observations_resets: Tuple) -> torch.Tensor:
        """`RecQNetwork.stacked_q_values` for every entry: the online and the
        target network of each of the S entries on that entry's inputs, as one
        pass over a stack of 2S (online entries, then target entries), each
        pair with its entry's resets. Q-values (2, S, T, B.., actions). No
        gradient. With the kernel the recurrence of all 2S is one launch of the
        stacked GRU kernel, its keep (2S, T, B, H)."""
        obs, resets = observations_resets
        twice = lambda x: torch.cat([x, x])  # noqa: E731
        pair = pytree.tree_map(twice, (hidden_state, obs.agents_view, resets))
        both = StackedNetwork.concat([online, target])
        _, q_values = both.get_q_values(pair[0], (obs._replace(agents_view=pair[1]), pair[2]))
        return q_values.reshape(2, online.size, *q_values.shape[1:])

    def _recurrence(self, carry, ins, resets, collect_carries: bool):
        """`ScannedRNN.forward` of every entry: carry (S, B.., H), ins (S, T, B..,
        F), resets (S, T, B..)."""
        rnn = self.module.rnn
        wi, bi, wh, bhn = (self.params[f"rnn.{k}"] for k in ("wi", "bi", "wh", "bhn"))
        hidden = rnn.hidden_state_dim
        gates_i = torch.func.vmap(lambda x, w, b: x @ w + b)(ins, wi, bi)
        stack, t_len, lead = ins.shape[0], ins.shape[1], ins.shape[2:-1]
        resets = torch.broadcast_to(resets, ins.shape[:-1])
        if rnn.uses_kernel(ins.device, t_len):
            gi = gates_i.reshape(stack, t_len, -1, 3 * hidden).contiguous()
            keep = (1.0 - resets.to(torch.float32)).reshape(stack, t_len, -1, 1)
            keep = keep.expand(*gi.shape[:3], hidden).contiguous()
            h0 = carry.reshape(stack, -1, hidden).contiguous()
            hs = gru_sequence_stacked(gi, keep, h0, wh, bhn)
            final_h = hs[:, -1].reshape(stack, *lead, hidden)
            ys = hs.reshape(stack, t_len, *lead, hidden)
            if collect_carries:
                carries = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
                return final_h, (carries.reshape(stack, t_len, *lead, hidden), ys)
            return final_h, ys
        return torch.func.vmap(
            lambda c, g, r, w, b: plain_gru(c, g, r, w, b, collect_carries)
        )(carry, gates_i, resets, wh, bhn)


def stack_observation(observation: Any, stack: int) -> Any:
    """Every leaf of a batched observation (or any pytree) from (S * E, ...) to
    (S, E, ...): the envs of a stacked program, entry by entry."""
    return pytree.tree_map(lambda x: x.reshape(stack, -1, *x.shape[1:]), observation)
