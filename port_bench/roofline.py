"""A kernel's least time from its bytes and operations, against the
table of peaks, and a group of kernels' share of it over a traced run."""

from __future__ import annotations


def bound_s(cost, peaks: dict) -> float:
    """Seconds the card needs at least: bytes over the memory rate, or 32-bit
    multiplies or int8 tensor-core operations over their peak, whichever is
    longest."""
    nbytes, muls, tc = cost
    return max(nbytes / peaks["hbm_bytes_per_s"],
               muls / peaks["int32_mul_per_s"],
               tc / peaks["int8_tc_ops_per_s"])


def share(record: dict, roofline: str) -> float | None:
    """Percent: the sum of the least times of the traced calls of every
    kernel in `roofline` over the sum of their launches' device seconds.
    None when no such kernel was traced, or when a kernel's launches and
    calls do not pair up (then its time would not be its calls')."""
    tr = record.get("trace")
    if not tr:
        return None
    least = spent = 0.0
    for k, got in tr["kernels"].items():
        if getattr(k, "ROOFLINE", None) != roofline or not got["calls"]:
            continue
        if len(got["calls"]) != len(got["seconds"]) or \
                any("unreadable" in c for c in got["calls"]):
            return None
        least += sum(bound_s(k.cost(c), record["peaks"]) for c in got["calls"])
        spent += sum(got["seconds"])
    return 100.0 * least / spent if spent > 0 else None
