"""ResNet50, PoseNet (rgbd) and its folded serving forward."""
