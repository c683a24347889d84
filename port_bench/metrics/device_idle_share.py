"""Percent of the traced requests' wall time in which no operation ran on
the device: 1 - (the union of the profiler's device activity) / (the traced
window)."""


def read(record):
    tr = record.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
