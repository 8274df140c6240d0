from mava_tpu_torch.networks.actor_critic import (
    FeedForwardActor,
    FeedForwardQNet,
    FeedForwardValueNet,
    RecQNetwork,
    RecurrentActor,
    RecurrentValueNet,
    ScannedRNN,
    StackedNetwork,
    resolve_gru_impl,
    stack_observation,
)
from mava_tpu_torch.networks.heads import ContinuousActionHead, DiscreteActionHead
from mava_tpu_torch.networks.torsos import CNNTorso, MLPTorso

__all__ = [
    "CNNTorso",
    "ContinuousActionHead",
    "DiscreteActionHead",
    "FeedForwardActor",
    "FeedForwardQNet",
    "FeedForwardValueNet",
    "MLPTorso",
    "RecQNetwork",
    "RecurrentActor",
    "RecurrentValueNet",
    "ScannedRNN",
    "StackedNetwork",
    "resolve_gru_impl",
    "stack_observation",
]
