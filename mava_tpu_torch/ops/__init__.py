from mava_tpu_torch.ops.losses import clipped_ppo_policy_loss, clipped_value_loss

__all__ = ["clipped_ppo_policy_loss", "clipped_value_loss"]
