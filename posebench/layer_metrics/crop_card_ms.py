"""Device ms per batch of the crop layer: the request steps crop (the RGB
crops), normalize (ImageNet) and depth_crop (the depth crops and the pose
net's other inputs)."""

from posebench.layer_metrics._stages import per_batch_ms


def read(rec: dict):
    return per_batch_ms(rec, ("crop", "normalize", "depth_crop", "pose_inputs"))
