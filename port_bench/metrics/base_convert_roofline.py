"""Percent of the roofline the `base_convert` kernels reach over the traced
requests: the sum of each call's least time (costs/*.py whose ROOFLINE is
"base_convert", from the call's argument shapes, against peaks.json) over the sum of
the device seconds of their launches in the profiler's trace."""

from port_bench.roofline import share


def read(record):
    return share(record, "base_convert")
