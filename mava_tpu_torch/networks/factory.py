"""Build torsos and heads from config dicts (port of
`mava_tpu/networks/factory.py`)."""

from __future__ import annotations

from typing import Any, Callable, Dict

from mava_tpu_torch.distributions import Categorical, gumbel
from mava_tpu_torch.networks.heads import DiscreteActionHead
from mava_tpu_torch.networks.torsos import MLPTorso

_TORSOS = {"MLPTorso": MLPTorso}
_HEADS = {"DiscreteActionHead": DiscreteActionHead}


def _lookup(table: Dict[str, Any], kind: str, what: str) -> Any:
    if kind not in table:
        raise NotImplementedError(
            f"{what} {kind!r} is not yet ported to mava_tpu_torch "
            f"(ported: {sorted(table)}); see ROADMAP.md."
        )
    return table[kind]


def make_torso(cfg: Dict[str, Any], in_features: int) -> MLPTorso:
    """cfg e.g. {"type": "MLPTorso", "layer_sizes": [128], "activation": "relu"}."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    return _lookup(_TORSOS, kind, "Torso")(in_features, **cfg)


def make_action_head(cfg: Dict[str, Any], in_features: int, action_dim: int):
    cfg = dict(cfg)
    kind = cfg.pop("type")
    return _lookup(_HEADS, kind, "Action head")(in_features, action_dim, **cfg)


def make_rollout_noise_fn(cfg: Dict[str, Any]) -> Callable:
    """`fn(shape, generator, device)` -> the sampling noise of the head's
    `sample_from_noise` (Gumbel for the discrete head)."""
    return _lookup({"DiscreteActionHead": gumbel}, cfg["type"], "Action head")


def make_log_prob_from_params(cfg: Dict[str, Any]) -> Callable:
    """`fn(raw_params, action) -> log_prob`, the companion of `raw_params`."""
    return _lookup(
        {"DiscreteActionHead": lambda p, a: Categorical(p).log_prob(a)},
        cfg["type"],
        "Action head",
    )
