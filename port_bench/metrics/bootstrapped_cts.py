"""Per request: ciphertexts the bootstrap refreshed; the program's
counter `utils/timing.GLOBAL_TIMERS.counts["bootstrap"]`, its change over
each request, averaged over the window's requests."""


def read(record):
    vals = [c["bootstrap"] for c in record["spans"].counts]
    return sum(vals) / len(vals) if vals else None
