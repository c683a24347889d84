"""Per request: key switches, counted per ciphertext where they run; the program's
counter `utils/timing.GLOBAL_TIMERS.counts["keyswitch"]`, its change over
each request, averaged over the window's requests."""


def read(record):
    vals = [c["keyswitch"] for c in record["spans"].counts]
    return sum(vals) / len(vals) if vals else None
