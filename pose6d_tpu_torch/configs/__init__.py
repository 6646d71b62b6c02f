"""Training presets (counterpart of pose6d_tpu/configs)."""
