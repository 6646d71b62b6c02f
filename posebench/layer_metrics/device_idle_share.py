"""The share of the traced window in which no operation ran on the card:
1 - (the union of the device operations' intervals) / (the window)."""


def read(rec: dict):
    if not rec.get("window_s") or not rec.get("busy_s"):
        return None
    return 1.0 - rec["busy_s"] / rec["window_s"]
