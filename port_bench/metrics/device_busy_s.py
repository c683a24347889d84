"""Seconds per request in which an operation ran on the device: the union
of the profiler's device activity over the profiled requests (trace.py),
divided by their number.  The host's speed does not move it, so it is the
steady reading beside device_idle_share."""


def read(record):
    tr = record.get("trace")
    if not tr or tr["busy_s"] <= 0 or not tr.get("requests"):
        return None
    return tr["busy_s"] / tr["requests"]
