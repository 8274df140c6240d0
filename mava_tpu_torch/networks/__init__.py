from mava_tpu_torch.networks.actor_critic import (
    FeedForwardActor,
    FeedForwardQNet,
    FeedForwardValueNet,
    RecQNetwork,
    RecurrentActor,
    RecurrentValueNet,
    ScannedRNN,
    resolve_gru_impl,
)
from mava_tpu_torch.networks.heads import ContinuousActionHead, DiscreteActionHead
from mava_tpu_torch.networks.torsos import MLPTorso

__all__ = [
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
    "resolve_gru_impl",
]
