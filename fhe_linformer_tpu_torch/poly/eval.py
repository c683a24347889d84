"""Homomorphic polynomial evaluation: Paterson-Stockmeyer in the monomial
and Chebyshev bases.

Scale discipline: every linear combination routes each term through a
constant multiply whose plaintext scale is solved so that all terms land on
one exact (level, scale) target, with the running scale tracked in host
floats.  `wide=True` (the bootstrap's EvalMod) runs every product at the
paired working scale delta^2.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext
from ..ckks.evaluator import Evaluator
from .cheb import cheb_divmod, chebyshev_fit


class PolyEvaluator:
    """wide=True runs ct x ct chains at the paired working scale
    (~delta^2 = 2^52): every product drops two limbs and every scale
    normalization targets delta^2, so the per-op key-switch and rescale
    noise sits at 2^-43 relative instead of 2^-17 (the bootstrap's EvalMod
    amplifies it).  Costs two limbs per multiplicative level."""

    def __init__(self, ev: Evaluator, wide: bool = False):
        self.ev = ev
        self.wide = wide

    @property
    def anchor(self) -> float:
        d = self.ev.ctx.delta
        return d * d if self.wide else d

    def _clamp(self, out: Ciphertext) -> Ciphertext:
        """Wide drift clamp: a paired product multiplies the scale by
        s/(qd*qd2) and the T_{2m} chain squares the drift, so one
        conditional level per offending product holds it within 1.5 bits
        of the anchor."""
        if self.wide and out.nl > 1 and \
                abs(math.log2(out.scale / self.anchor)) > 1.5:
            out = self.ev.adjust(out, out.nl - 1, self.anchor)
        return out

    def _mul(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        ev = self.ev
        if not self.wide:
            return ev.mul(a, b)
        return self._clamp(ev.rescale(ev.rescale(ev.mul(a, b, rescale=False))))

    def _match(self, a: Ciphertext, b: Ciphertext):
        """ev.match, but the equal-level reconciliation lands on the anchor
        scale (ev.match lands on delta)."""
        ev = self.ev
        if a.nl == b.nl and abs(a.scale / b.scale - 1.0) >= 1e-9:
            nl = a.nl - 1
            return ev.adjust(a, nl, self.anchor), ev.adjust(b, nl, self.anchor)
        return ev.match(a, b)

    def _mul2sub(self, a: Ciphertext, b: Ciphertext,
                 c: Ciphertext) -> Ciphertext:
        """2ab - c (the T_{a+b} node), fused, with the wide drift clamp;
        falls back to the mul/match/sub chain when c sits too deep for the
        inlined match."""
        ev = self.ev
        nl_out = min(a.nl, b.nl) - (2 if self.wide else 1)
        if c.nl >= nl_out + 1:
            return self._clamp(ev.mul_double_sub(a, b, c, wide=self.wide))
        prod = ev.mul_scalar_int(self._mul(a, b), 2)
        prod, tm = self._match(prod, c)
        return ev.sub(prod, tm)

    def _sq2m1(self, y: Ciphertext) -> Ciphertext:
        """2y^2 - 1 (the T_{2m} node), fused, with the wide drift clamp."""
        return self._clamp(self.ev.square_double_minus_one(y, wide=self.wide))

    # ------------------------------------------------------------------
    # linear combination with exact (nl, scale) targeting
    # ------------------------------------------------------------------

    def combine(self, terms: list[tuple[Ciphertext, float]],
                const: float) -> Ciphertext:
        """sum_i coeff_i * ct_i + const, all terms landed on one exact
        (nl, scale) at the anchor scale.  Spends one level (constant
        multiplies)."""
        ev = self.ev
        ctx = ev.ctx
        assert terms, "empty combination"
        nl_c = min(ct.nl for ct, _ in terms)
        out_nl = nl_c - 1
        out_scale = self.anchor
        qd = float(ctx.qs[out_nl])
        limbs = ctx.limb_idx(nl_c)
        qs_np = np.asarray([ctx.basis[i] for i in limbs], np.int64)
        shape = torch.broadcast_shapes(*(ct.c0.shape[:-2] for ct, _ in terms)
                                       ) + (nl_c, ctx.cfg.n)
        c0s, c1s, vals = [], [], []
        for ct, c in terms:
            ct = ev.drop_to(ct, nl_c)
            v = int(round(c * (out_scale * qd / ct.scale)))
            assert abs(v) < 1 << 62
            c0s.append(ct.c0.expand(shape))
            c1s.append(ct.c1.expand(shape))
            vals.append(v)
        res = np.asarray(vals, np.int64)[:, None] % qs_np[None]   # (T, nl)
        w = ctx.tensor(res.astype(np.int32)).view(
            (len(terms),) + (1,) * (len(shape) - 2) + (len(limbs), 1))
        q = ctx.mod(limbs)
        o0, o1 = (torch.remainder(torch.remainder(
            torch.stack(cs).long() * w, q).sum(0), q).int()
            for cs in (c0s, c1s))
        acc = ev.rescale(Ciphertext(o0, o1, nl_c, out_scale * qd))
        acc.scale = out_scale
        if const != 0.0:
            acc = ev.add_plain(acc, ev.encode_const(const, acc.nl, acc.scale))
        return acc

    # ------------------------------------------------------------------
    # monomial Paterson-Stockmeyer (low degree, e.g. the exp Taylor)
    # ------------------------------------------------------------------

    def power_basis(self, x: Ciphertext, k: int) -> dict[int, Ciphertext]:
        """x^1..x^k via binary products (depth ceil(log2 k))."""
        pows = {1: x}
        for i in range(2, k + 1):
            a = i // 2
            pows[i] = self._mul(pows[a], pows[i - a])
        return pows

    def eval_poly(self, x: Ciphertext, coeffs) -> Ciphertext:
        """p(x) = sum_i coeffs[i] x^i, monomial basis; depth
        ceil(log2 deg) + 1."""
        coeffs = list(coeffs)
        deg = len(coeffs) - 1
        assert deg >= 1
        if abs(math.log2(x.scale / self.anchor)) > 0.02:
            x = self.ev.adjust(x, x.nl - 1, self.anchor)
        pows = self.power_basis(x, deg)
        return self.combine([(pows[i], coeffs[i]) for i in range(1, deg + 1)],
                            coeffs[0])

    # ------------------------------------------------------------------
    # Chebyshev-basis Paterson-Stockmeyer (high degree)
    # ------------------------------------------------------------------

    def eval_chebyshev_series(self, y: Ciphertext, coeffs) -> Ciphertext:
        """sum_i c_i T_i(y), y expected in [-1, 1].  Entry scale is
        normalized to exactly the anchor: the T_{2i} = 2T_i^2-1 recursion
        squares any scale excess."""
        ev = self.ev
        if abs(math.log2(y.scale / self.anchor)) > 0.02:
            y = ev.adjust(y, y.nl - 1, self.anchor)
        coeffs = np.asarray(coeffs, np.float64)
        deg = len(coeffs) - 1
        k = max(2, 1 << int(math.ceil(math.log2(max(deg, 2)) / 2)))
        babies = {1: y}
        # T_{2i} = 2 T_i^2 - 1 ; T_{i+j} = 2 T_i T_j - T_{i-j}
        for i in range(2, k + 1):
            a, b = i // 2, i - i // 2
            babies[i] = self._sq2m1(babies[a]) if a == b else \
                self._mul2sub(babies[a], babies[b], babies[b - a])
        giants = {k: babies[k]}
        m = k
        while m < deg:
            giants[2 * m] = self._sq2m1(giants[m])
            m *= 2
        out = self._series(coeffs, k, babies, giants)
        # exit-scale normalization (callers may square the result)
        if out.nl > 1 and abs(math.log2(out.scale / self.anchor)) > 0.25:
            out = ev.adjust(out, out.nl - 1, self.anchor)
        return out

    def _series(self, c: np.ndarray, k: int, babies: dict,
                giants: dict) -> Ciphertext:
        """sum_i c_i T_i from the baby steps T_1..T_k and the giant steps
        T_m, dividing by the largest giant step that fits.  A method, not a
        nested closure: a recursive closure forms a reference cycle, which
        would keep the whole power basis (GBs at a 128-ciphertext batch) on
        the card until the garbage collector's next full pass."""
        ev = self.ev
        d = len(c) - 1
        while d > 0 and c[d] == 0.0:
            d -= 1
        c = c[: d + 1]
        if d < k:
            if d == 0:
                return self.combine([(babies[1], 0.0)], c[0])
            return self.combine([(babies[i], c[i]) for i in range(1, d + 1)],
                                c[0])
        m = k
        while 2 * m <= d:
            m *= 2
        q, r = cheb_divmod(c, m)
        # the quotient may be a bare constant: fold via combine on T_1
        quot = self.combine([(babies[1], 0.0)], q[0]) \
            if len(q) == 1 or not np.any(q[1:] != 0.0) else \
            self._series(np.asarray(q), k, babies, giants)
        left = self._mul(quot, giants[m])
        if np.any(r != 0.0):
            left, right = self._match(left, self._series(np.asarray(r), k,
                                                         babies, giants))
            return ev.add(left, right)
        return left

    def eval_chebyshev_function(self, f, ct: Ciphertext, a: float, b: float,
                                degree: int) -> Ciphertext:
        """Chebyshev-approximate f on [a, b] and evaluate it."""
        coeffs = chebyshev_fit(f, a, b, degree)
        ev = self.ev
        sc = 2.0 / (b - a)
        sh = -(a + b) / (b - a)
        y = ev.mul_scalar(ct, sc)           # affine map y = (2x - a - b)/(b - a)
        if sh != 0.0:
            y = ev.add_plain(y, ev.encode_const(sh, y.nl, y.scale))
        return self.eval_chebyshev_series(y, coeffs)
