"""Array specs of the environments (port of `mava_tpu/specs.py`).

The spec surface the systems read from an env: shape- and dtype-carrying
specs with `generate_value()`, bounded and discrete variants, and `TreeSpec`
for the NamedTuple observations. Dtypes are `torch.dtype`s. Every port env
has the `MarlEnv` protocol's `observation_spec()` and `action_spec()`
(reference `mava_tpu/types.py:133-149`) through `DiscreteEnvSpecs` or
`ContinuousEnvSpecs`: the agents' views (vector or grid), a boolean action
mask of one entry per action, the step count bounded by the time limit, and
an action of one index per agent or of `action_dim` values in [-1, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple, Type

import torch

from mava_tpu_torch.types import Observation


@dataclasses.dataclass(frozen=True)
class Array:
    """A tensor of a static shape and dtype."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    name: str = ""

    def generate_value(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=self.dtype)

    def replace(self, **kwargs: Any) -> "Array":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class BoundedArray(Array):
    """An array spec with inclusive bounds."""

    minimum: Any = None
    maximum: Any = None

    def generate_value(self) -> torch.Tensor:
        if self.minimum is not None:
            return torch.full(self.shape, self.minimum, dtype=self.dtype)
        return torch.zeros(self.shape, dtype=self.dtype)


@dataclasses.dataclass(frozen=True)
class DiscreteArray(Array):
    """An integer array spec whose entries lie in [0, num_values)."""

    num_values: int = 0


class TreeSpec:
    """The spec of a NamedTuple (an observation): the container type and one
    spec per field, each also an attribute (`spec.agents_view.shape`)."""

    def __init__(self, constructor: Type, name: str = "", **field_specs: Any):
        self._constructor = constructor
        self._name = name
        self._field_specs = dict(field_specs)
        for key, value in field_specs.items():
            setattr(self, key, value)

    def generate_value(self) -> Any:
        return self._constructor(**{k: v.generate_value() for k, v in self._field_specs.items()})

    def replace(self, **kwargs: Any) -> "TreeSpec":
        return TreeSpec(self._constructor, self._name, **{**self._field_specs, **kwargs})

    @property
    def fields(self) -> dict:
        return dict(self._field_specs)


def make_float_spec(shape: Sequence[int], name: str = "") -> Array:
    return Array(tuple(shape), torch.float32, name)


def make_bool_spec(shape: Sequence[int], name: str = "") -> Array:
    return Array(tuple(shape), torch.bool, name)


def make_int_spec(shape: Sequence[int], name: str = "") -> Array:
    return Array(tuple(shape), torch.int32, name)


class DiscreteEnvSpecs:
    """`observation_spec()` and `action_spec()` of an env with one discrete
    action per agent, from its `num_agents`, `action_dim`, `time_limit` and
    view shape (`obs_shape` for a grid, else `num_obs_features`)."""

    def observation_spec(self) -> TreeSpec:
        view = getattr(self, "obs_shape", None) or (self.num_obs_features,)
        return TreeSpec(
            Observation,
            "ObservationSpec",
            agents_view=make_float_spec((self.num_agents, *view), "agents_view"),
            action_mask=make_bool_spec((self.num_agents, self.action_dim), "action_mask"),
            step_count=BoundedArray(
                (self.num_agents,), torch.int32, "step_count",
                minimum=0, maximum=self.time_limit,
            ),
        )

    def action_spec(self) -> Array:
        return DiscreteArray(
            (self.num_agents,), torch.int32, "action", num_values=self.action_dim
        )


class ContinuousEnvSpecs(DiscreteEnvSpecs):
    """As `DiscreteEnvSpecs`, with `action_dim` actions in [-1, 1] per agent."""

    def action_spec(self) -> Array:
        return BoundedArray(
            (self.num_agents, self.action_dim), torch.float32, "action",
            minimum=-1.0, maximum=1.0,
        )
