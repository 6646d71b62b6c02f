"""Device ms per batch of the request step posenet: the towers and heads
over the batch's crops."""

from posebench.layer_metrics._stages import per_batch_ms


def read(rec: dict):
    return per_batch_ms(rec, ("posenet",))
