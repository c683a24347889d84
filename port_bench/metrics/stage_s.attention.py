"""Seconds per request in the circuit's `attention` stage: the benchmark's span
around the circuit's `attention` method, behind a synchronize at both ends in
the traced run's spanned requests (trace.py), summed within each request
and averaged over those requests."""


def read(record):
    vals = record["spans"].per_request("attention")
    return sum(vals) / len(vals) if vals else None
