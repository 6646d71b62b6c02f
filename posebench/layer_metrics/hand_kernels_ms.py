"""Device ms per batch of the operations named as the program's
hand-written kernels (trace.HAND_KERNELS), or None where none ran."""


def read(rec: dict):
    if not rec.get("hand_kernel_ms") or not rec.get("batches"):
        return None
    return rec["hand_kernel_ms"] / rec["batches"]
