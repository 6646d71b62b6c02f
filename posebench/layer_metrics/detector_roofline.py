"""The detector's share of its roofline, in %: the least time the card
could take over the detector step's device time per batch. The least time
is the larger of YOLOv8's FLOPs at the cell's frames over the bf16 peak and
its bytes (frames in, weights, logits out) over the HBM bandwidth
(posebench/flops.py, counted on the reference network)."""

from posebench import flops
from posebench.layer_metrics._stages import per_batch_ms


def read(rec: dict):
    ms = per_batch_ms(rec, ("detector",))
    if ms is None:
        return None
    det, traffic = rec["config"]["detector"], rec["traffic"]
    B, hw = traffic["frames_per_batch"], traffic["frame_hw"]
    work = B * flops.detector_flops(rec["shapes"][0], hw)
    moved = flops.detector_bytes(rec["shapes"][0], B, hw, det["dtype"], det["num_classes"],
                                 det["reg_max"])
    return 100.0 * flops.bound_ms(work, moved) / ms
