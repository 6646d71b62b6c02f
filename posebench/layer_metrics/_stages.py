"""Shared by the readers of step device times: the device ms per traced
batch of the program's request steps named, or None where the trace has
none of them."""


def per_batch_ms(rec: dict, steps) -> float | None:
    times = rec.get("stage_device_ms", {})
    found = [times[s] for s in steps if s in times]
    if not found or not rec.get("batches") or sum(found) <= 0:
        return None
    return sum(found) / rec["batches"]
