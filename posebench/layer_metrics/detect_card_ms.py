"""Device ms per batch of the detect layer: the request steps convert
(uint8 -> bf16 / 255), detector (letterbox, YOLOv8n) and decode_nms."""

from posebench.layer_metrics._stages import per_batch_ms


def read(rec: dict):
    return per_batch_ms(rec, ("convert", "detector", "decode_nms"))
