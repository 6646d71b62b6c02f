"""Depth constants of the rgbd crop contract, which rgbd_geometric's depth
guards reuse (the port's own copy of pose6d_tpu/data/crop.py's constants;
reference data/dataset_rgbd.py:181-186)."""

DEPTH_MIN_M = 0.1
DEPTH_MAX_M = 1.6
DEPTH_INVALID_M = 0.01
