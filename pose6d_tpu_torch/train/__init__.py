"""Pose training on the device (counterpart of pose6d_tpu/train)."""
