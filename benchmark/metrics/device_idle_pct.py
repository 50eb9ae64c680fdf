"""device_idle_pct: the share of the profiled part of the window in which
no operation runs on the card (the union of the device's activity
intervals from torch.profiler)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
