"""Seconds per request in the bootstrap: the benchmark's span around each
`refresh` and `bootstrap` call the circuit makes on the bootstrapper it was
handed, behind a synchronize at both ends in the traced run's spanned
requests (trace.py), summed within each request and averaged over those
requests that bootstrapped."""


def read(record):
    vals = record["spans"].per_request("bootstrap")
    return sum(vals) / len(vals) if vals else None
