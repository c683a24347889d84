"""Operation counters and per-kernel launch counts.

`GLOBAL_TIMERS.counts` counts the per-primitive work the evaluator does
(`keyswitch`, `combo_rot`, `rescale`, ...) and the ciphertexts the
bootstrap refreshes (`bootstrap`).  `KERNEL_LAUNCHES` counts each CUDA kernel's
launches: a wrapper adds one where it launches its kernel and nowhere else,
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


class Timers:
    """Named op counters (the JAX package's Timers without its clocks)."""

    def __init__(self):
        self.counts = defaultdict(int)

    def count(self, name: str, n: int = 1):
        self.counts[name] += n


GLOBAL_TIMERS = Timers()

# kernel name -> launches; the names are the ones chip_smoke.py reports
KERNEL_LAUNCHES: dict[str, int] = {"ntt_fwd": 0, "ntt_inv": 0,
                                   "base_convert": 0}


def reset_launches() -> None:
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


def approx_error_log2(expected: np.ndarray, actual: np.ndarray) -> float:
    """-log2 of the infinity-norm error: bits of precision, higher is
    better; negative when the error exceeds 1."""
    err = np.max(np.abs(np.asarray(expected) - np.asarray(actual)))
    if err == 0:
        return float("inf")
    return float(-np.log2(err))
