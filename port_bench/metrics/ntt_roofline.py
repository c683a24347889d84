"""Percent of the roofline the `ntt` kernels reach over the traced
requests: the sum of each call's least time (costs/*.py whose ROOFLINE is
"ntt", from the call's argument shapes, against peaks.json) over the sum of
the device seconds of their launches in the profiler's trace."""

from port_bench.roofline import share


def read(record):
    return share(record, "ntt")
