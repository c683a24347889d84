"""Wall-clock accumulators, operation counters and per-kernel launch counts.

`GLOBAL_TIMERS.time(name)` adds a block's wall-clock seconds to
`totals[name]` (and one to `counts[name]`); the packed circuit spans its
per-head scores (`head_scores`) and value mix (`head_mix`), on the host's
clock with no synchronize.  `GLOBAL_TIMERS.counts` counts the
per-primitive work the evaluator does (`keyswitch`, `combo_rot`,
`rescale`, ...), the calls of the kernel wrappers K4, K5 and K6 on either
route (`ks_mac`, `mod_down`, `mod_ew`, `rs_lift`, `rs_finish`), the d x d
block products of the block-major matmuls by ciphertext
(`block_matmul`), the residue rows made from
coefficient plaintexts for the rotation combo (`pt_rows`) and the
ciphertexts the bootstrap refreshes (`bootstrap`).  `KERNEL_LAUNCHES` counts each CUDA kernel's
launches: a wrapper adds one where it launches its kernel and nowhere else,
so a run can show that its main path went through the kernels.
`COLLECTIVE_BYTES` counts the bytes each rank hands to the collectives of
`parallel/comm.py`, by collective.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


class Timers:
    """Named wall-clock accumulators and op counters."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def count(self, name: str, n: int = 1):
        self.counts[name] += n

    def report(self) -> dict:
        """{name: {"total_s", "count"}} for the timed names (seconds
        rounded to 0.1 ms), then {name: {"count"}} for the counted ones."""
        return {k: {"total_s": round(v, 4), "count": self.counts[k]}
                for k, v in sorted(self.totals.items())} | {
            k: {"count": v} for k, v in self.counts.items()
            if k not in self.totals}


GLOBAL_TIMERS = Timers()

# kernel name -> launches; the names are the ones chip_smoke.py reports
KERNEL_LAUNCHES: dict[str, int] = {"ntt_fwd": 0, "ntt_inv": 0,
                                   "base_convert": 0, "ks_mac": 0,
                                   "md_fold": 0, "md_lift": 0, "md_finish": 0,
                                   "mod_ew": 0, "rs_lift": 0, "rs_finish": 0}


# collective -> bytes of the tensors this process handed to it
COLLECTIVE_BYTES: dict[str, int] = {"all_reduce": 0, "reduce_scatter": 0,
                                    "all_gather": 0}


def reset_launches() -> None:
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


@contextlib.contextmanager
def launches_into(acc: dict):
    """Add the kernel launches made inside the block to `acc` (kernel name
    -> launches), so a run can count one path's launches apart from the
    reference work around it."""
    before = dict(KERNEL_LAUNCHES)
    try:
        yield acc
    finally:
        for k, v in KERNEL_LAUNCHES.items():
            acc[k] = acc.get(k, 0) + v - before[k]


def approx_error_log2(expected: np.ndarray, actual: np.ndarray) -> float:
    """-log2 of the infinity-norm error: bits of precision, higher is
    better; negative when the error exceeds 1."""
    err = np.max(np.abs(np.asarray(expected) - np.asarray(actual)))
    if err == 0:
        return float("inf")
    return float(-np.log2(err))
