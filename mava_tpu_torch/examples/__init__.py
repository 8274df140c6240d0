"""Example programs of the port (`python -m mava_tpu_torch.examples.<name>`)."""
