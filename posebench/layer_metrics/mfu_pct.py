"""The whole request's share of the card's dense bf16 peak, in %: the
detector's and PoseNet's FLOPs per frame (counted on the reference
networks, convolution and matrix-product multiply-adds x 2) times the
frames/s of the run's untraced window, over 989 TFLOP/s."""

from posebench import flops


def read(rec: dict):
    if not rec.get("frames_per_s"):
        return None
    pipe, traffic = rec["config"]["pipeline"], rec["traffic"]
    per_frame = (flops.detector_flops(rec["shapes"][0], traffic["frame_hw"])
                 + traffic["max_objects"] * flops.posenet_flops(pipe["variant"], rec["shapes"][1],
                                                                pipe["img_size"]))
    return 100.0 * per_frame * rec["frames_per_s"] / flops.PEAK_FLOPS
