"""Lattice-security calibration for CKKS parameter presets.

Parameters are assessed against the HomomorphicEncryption.org Security
Standard tables (uniform ternary secret), over the full prime basis Q*P:
the key-switching keys are RLWE samples over the extended basis.  For a
rigorous bound on other shapes (sparse secrets), run the lattice-estimator
on the instance `estimator_input()` describes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .ckks.context import modulus_chain

# HomomorphicEncryption.org standard (Table 1, uniform ternary secret):
# ring dim -> max log2(q) supported at the given security level.
_HE_STD_TERNARY = {
    "classical": {
        128: {1024: 27, 2048: 54, 4096: 109, 8192: 218,
              16384: 438, 32768: 881},
        192: {1024: 19, 2048: 37, 4096: 75, 8192: 152,
              16384: 305, 32768: 611},
        256: {1024: 14, 2048: 29, 4096: 58, 8192: 118,
              16384: 237, 32768: 476},
    },
    "quantum": {
        128: {1024: 25, 2048: 51, 4096: 101, 8192: 202,
              16384: 411, 32768: 827},
        192: {1024: 17, 2048: 35, 4096: 70, 8192: 141,
              16384: 284, 32768: 571},
        256: {1024: 13, 2048: 27, 4096: 54, 8192: 109,
              16384: 220, 32768: 443},
    },
}


def max_log_qp(n: int, level: int = 128, model: str = "classical") -> float:
    """Largest total modulus log2(Q*P) the standard allows at `level` bits
    for ring dimension n (uniform ternary secret).  For n beyond the table
    the bound is extrapolated linearly in n — accurate to a few bits since
    the security-fixed log q scales ~linearly with n."""
    table = _HE_STD_TERNARY[model][level]
    if n in table:
        return float(table[n])
    n_max = max(table)
    if n > n_max:
        return table[n_max] * (n / n_max)
    n_min = min(table)
    if n < n_min:
        return table[n_min] * (n / n_min)
    lo = max(k for k in table if k < n)
    return table[lo] * (n / lo)


@dataclass(frozen=True)
class SecurityReport:
    n: int
    log_qp: float                 # full basis incl. key-switch specials
    log_q: float                  # Q chain only (fresh-ciphertext modulus)
    classical_bits: int           # highest standard level satisfied (0 if none)
    quantum_bits: int
    sparse_secret: bool           # sparse secrets are NOT covered by the table
    headroom_bits: float          # margin to the classical-128 bound

    def __str__(self) -> str:
        claim = (f">= {self.classical_bits}-bit classical"
                 if self.classical_bits else "BELOW 128-bit classical")
        warn = ("  [sparse secret: standard table assumes uniform ternary —"
                " verify with the lattice estimator]" if self.sparse_secret
                else "")
        return (f"n=2^{self.n.bit_length() - 1} log2(QP)={self.log_qp:.1f} "
                f"(Q only: {self.log_q:.1f}) -> {claim} "
                f"(headroom to 128c: {self.headroom_bits:+.1f} bits){warn}")


def assess(ctx_or_cfg) -> SecurityReport:
    """Security assessment of a Context or a bare CKKSConfig (the latter
    resolves the prime chain without building NTT tables — cheap)."""
    if hasattr(ctx_or_cfg, "cfg"):
        cfg, qs, ps = ctx_or_cfg.cfg, ctx_or_cfg.qs, ctx_or_cfg.ps
    else:
        cfg = ctx_or_cfg
        qs, ps, _ = modulus_chain(cfg)
    log_q = sum(math.log2(q) for q in qs)
    log_qp = log_q + sum(math.log2(p) for p in ps)
    n = cfg.n
    levels = [lv for lv in (256, 192, 128)
              if log_qp <= max_log_qp(n, lv, "classical")]
    qlevels = [lv for lv in (256, 192, 128)
               if log_qp <= max_log_qp(n, lv, "quantum")]
    return SecurityReport(
        n=n,
        log_qp=log_qp,
        log_q=log_q,
        classical_bits=max(levels) if levels else 0,
        quantum_bits=max(qlevels) if qlevels else 0,
        sparse_secret=cfg.secret_hw is not None,
        headroom_bits=max_log_qp(n, 128, "classical") - log_qp,
    )


def estimator_input(ctx_or_cfg) -> str:
    """LWE instance description for the (external) lattice-estimator:
    https://github.com/malb/lattice-estimator — run
    `LWE.estimate(LWE.Parameters(**params))` in its Sage environment."""
    if hasattr(ctx_or_cfg, "cfg"):
        cfg, qs, ps = ctx_or_cfg.cfg, ctx_or_cfg.qs, ctx_or_cfg.ps
    else:
        cfg = ctx_or_cfg
        qs, ps, _ = modulus_chain(cfg)
    log_qp = sum(math.log2(q) for q in qs) + sum(math.log2(p) for p in ps)
    hw = cfg.secret_hw
    xs = (f"ND.SparseTernary(n={cfg.n}, p={hw // 2}, m={hw - hw // 2})"
          if hw else "ND.UniformMod(3)")
    return (f"LWE.Parameters(n={cfg.n}, q=2**{log_qp:.0f}, "
            f"Xs={xs}, Xe=ND.DiscreteGaussian({cfg.sigma}))")
