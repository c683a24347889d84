"""Per request: rotations served by the double-hoisted rotation combo; the program's
counter `utils/timing.GLOBAL_TIMERS.counts["combo_rot"]`, its change over
each request, averaged over the window's requests."""


def read(record):
    vals = [c["combo_rot"] for c in record["spans"].counts]
    return sum(vals) / len(vals) if vals else None
