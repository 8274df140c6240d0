from mava_tpu_torch.networks.actor_critic import (
    FeedForwardActor,
    FeedForwardValueNet,
    RecurrentActor,
    RecurrentValueNet,
    ScannedRNN,
    resolve_gru_impl,
)
from mava_tpu_torch.networks.heads import DiscreteActionHead
from mava_tpu_torch.networks.torsos import MLPTorso

__all__ = [
    "DiscreteActionHead",
    "FeedForwardActor",
    "FeedForwardValueNet",
    "MLPTorso",
    "RecurrentActor",
    "RecurrentValueNet",
    "ScannedRNN",
    "resolve_gru_impl",
]
