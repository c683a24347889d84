"""Nonlinearity gadgets for the encrypted Linformer circuit.

  eval_exp     - deg-6 Taylor of e^x (optionally then x^8 by squaring)
  eval_inverse - Chebyshev 1/x
  eval_gelu    - Chebyshev of 0.5*x'*(1+erf(x'/sqrt 2)), x' = x/mult
  eval_tanh    - Chebyshev of tanh(x/mult)
  relu         - Chebyshev of max(scale*x, 0)/scale on [-1, 1]
  relu_degree_depth - the degree -> multiplicative depth table
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import erf

from ..ckks.ciphertext import Ciphertext
from ..ckks.evaluator import Evaluator
from .eval import PolyEvaluator

EXP_TAYLOR_DEG6 = [1.0, 1.0, 1 / 2, 1 / 6, 1 / 24, 1 / 120, 1 / 720]

# degree -> multiplicative depth of the Chebyshev evaluation
RELU_DEPTH = {7: 6, 13: 7, 27: 8, 59: 9, 119: 10, 247: 11, 495: 12}


def relu_degree_depth(degree: int) -> int:
    for d, depth in RELU_DEPTH.items():
        if degree <= d:
            return depth
    return 13


class Gadgets:
    def __init__(self, ev: Evaluator):
        self.ev = ev
        self.poly = PolyEvaluator(ev)

    def eval_exp(self, ct: Ciphertext, pow8: bool = True, boot=None,
                 boot_below: int = 0) -> Ciphertext:
        """pow8=True: deg-6 Taylor of e^x then x^8 by three squarings
        (approximates e^(8x)); pow8=False: the bare deg-6 Taylor (what the
        golden model computes).

        boot (a Bootstrapper): refresh before the Taylor when fewer than 6
        levels are left (its product tree needs ~4 plus the rescale floor),
        and after it when fewer than `boot_below` usable levels remain for
        the chain downstream (the mid-exp refresh)."""
        if boot is not None and ct.nl < 6:
            ct = boot.bootstrap(ct)
        t = self.poly.eval_poly(ct, EXP_TAYLOR_DEG6)
        if boot is not None and t.nl - 1 < boot_below:
            t = boot.bootstrap(t)
        if pow8:
            for _ in range(3):
                t = self.ev.mul(t, t)
        return t

    def eval_inverse(self, ct: Ciphertext, a: float, b: float,
                     degree: int = 119) -> Ciphertext:
        return self.poly.eval_chebyshev_function(
            lambda x: 1.0 / x, ct, a, b, degree)

    def eval_gelu(self, ct: Ciphertext, a: float, b: float, mult: float,
                  degree: int = 119) -> Ciphertext:
        """GELU of the unscaled input: the ciphertext arrives pre-scaled by
        `mult` and the gadget evaluates gelu(x/mult)."""
        def gelu(x):
            xp = x / mult
            return 0.5 * xp * (1.0 + erf(xp / math.sqrt(2.0)))
        return self.poly.eval_chebyshev_function(gelu, ct, a, b, degree)

    def eval_tanh(self, ct: Ciphertext, a: float, b: float, mult: float,
                  degree: int = 300) -> Ciphertext:
        """tanh(x/mult) on a mult-pre-scaled input."""
        return self.poly.eval_chebyshev_function(
            lambda x: np.tanh(x / mult), ct, a, b, degree)

    def relu(self, ct: Ciphertext, scale: float = 1.0,
             degree: int = 119) -> Ciphertext:
        """ReLU of an input in [-1, 1], as the Chebyshev fit of
        max(scale*x, 0)/scale; degree 119 uses depth 10 (RELU_DEPTH)."""
        return self.poly.eval_chebyshev_function(
            lambda x: np.maximum(x * scale, 0.0) / scale, ct, -1.0, 1.0,
            degree)
