from mava_tpu_torch.replay.trajectory_buffer import (
    TrajectoryBuffer,
    TrajectoryBufferState,
)

__all__ = ["TrajectoryBuffer", "TrajectoryBufferState"]
