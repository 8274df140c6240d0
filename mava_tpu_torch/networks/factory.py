"""Build torsos and heads from config dicts (port of
`mava_tpu/networks/factory.py`)."""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Union

from mava_tpu_torch.distributions import Categorical, TanhNormal, gumbel, normal
from mava_tpu_torch.networks.heads import ContinuousActionHead, DiscreteActionHead
from mava_tpu_torch.networks.torsos import CNNTorso, MLPTorso

_TORSOS = {"MLPTorso": MLPTorso, "CNNTorso": CNNTorso}
_HEADS = {
    "DiscreteActionHead": DiscreteActionHead,
    "ContinuousActionHead": ContinuousActionHead,
}


def _lookup(table: Dict[str, Any], kind: str, what: str) -> Any:
    if kind not in table:
        raise NotImplementedError(
            f"{what} {kind!r} is not yet ported to mava_tpu_torch "
            f"(ported: {sorted(table)}); see ROADMAP.md."
        )
    return table[kind]


def make_torso(cfg: Dict[str, Any], in_shape: Union[int, Sequence[int]]):
    """cfg e.g. {"type": "MLPTorso", "layer_sizes": [128], "activation": "relu"}.

    `in_shape` is the shape of one input without its leading dims: an int or
    a one-entry shape (features) for `MLPTorso`, (rows, cols, channels) for
    `CNNTorso`."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    torso = _lookup(_TORSOS, kind, "Torso")
    if torso is CNNTorso:
        return CNNTorso(tuple(in_shape), **cfg)
    if not isinstance(in_shape, int):
        if len(in_shape) != 1:
            raise ValueError(f"{kind} takes vector inputs, not shape {tuple(in_shape)}")
        (in_shape,) = in_shape
    return torso(in_shape, **cfg)


def make_action_head(cfg: Dict[str, Any], in_features: int, action_dim: int):
    cfg = dict(cfg)
    kind = cfg.pop("type")
    return _lookup(_HEADS, kind, "Action head")(in_features, action_dim, **cfg)


def make_rollout_noise_fn(cfg: Dict[str, Any]) -> Callable:
    """`fn(shape, generator, device)` -> the sampling noise of the head's
    `sample_from_noise`: Gumbel for the discrete head, standard normal for the
    continuous one."""
    return _lookup(
        {"DiscreteActionHead": gumbel, "ContinuousActionHead": normal},
        cfg["type"],
        "Action head",
    )


def make_log_prob_from_params(cfg: Dict[str, Any]) -> Callable:
    """`fn(raw_params, action) -> log_prob`, the companion of `raw_params`."""
    return _lookup(
        {
            "DiscreteActionHead": lambda p, a: Categorical(p).log_prob(a),
            "ContinuousActionHead": lambda p, a: TanhNormal(p[0], p[1]).log_prob(a),
        },
        cfg["type"],
        "Action head",
    )
