"""PoseNet's share of its roofline, in %: the least time the card could
take for the towers and heads over the batch's crops, over the posenet
step's device time per batch. The same work whichever kernels implement it
(posebench/flops.py, counted on the reference networks)."""

from posebench import flops
from posebench.layer_metrics._stages import per_batch_ms


def read(rec: dict):
    ms = per_batch_ms(rec, ("posenet",))
    if ms is None:
        return None
    pipe, traffic = rec["config"]["pipeline"], rec["traffic"]
    crops = traffic["frames_per_batch"] * traffic["max_objects"]
    work = crops * flops.posenet_flops(pipe["variant"], rec["shapes"][1], pipe["img_size"])
    moved = flops.posenet_bytes(pipe["variant"], rec["shapes"][1], crops, pipe["img_size"],
                                pipe["compute_dtype"])
    return 100.0 * flops.bound_ms(work, moved) / ms
