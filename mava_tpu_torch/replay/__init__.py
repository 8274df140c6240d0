from mava_tpu_torch.replay.item_buffer import ItemBuffer, ItemBufferState
from mava_tpu_torch.replay.stacked import StackedItemBuffer, StackedTrajectoryBuffer
from mava_tpu_torch.replay.trajectory_buffer import (
    TrajectoryBuffer,
    TrajectoryBufferState,
)

__all__ = ["ItemBuffer", "ItemBufferState", "StackedItemBuffer", "StackedTrajectoryBuffer",
           "TrajectoryBuffer", "TrajectoryBufferState"]
