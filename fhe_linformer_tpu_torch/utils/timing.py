"""Operation counters and per-kernel launch counts.

`GLOBAL_TIMERS.counts` counts the per-primitive work the evaluator does
(`keyswitch`, `combo_rot`, `rescale`, ...; `bootstrap` stays 0 until the
bootstrap is ported).  `KERNEL_LAUNCHES` counts each CUDA kernel's
launches: a wrapper adds one where it launches its kernel and nowhere else,
so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

from collections import defaultdict


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
