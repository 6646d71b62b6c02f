"""The host's own time to hand one batch to PosePipeline.__call__
(perf_counter around the call, which returns before the card has run it),
served one at a time so that the card is idle when each call starts and no
launch waits for the card to drain its queue: the median over the traced
run's TRACE_BATCHES such batches. Layer: entry."""

import statistics


def read(rec: dict):
    times = rec.get("host_enqueue_ms")
    return statistics.median(times) if times else None
