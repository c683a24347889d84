"""CKKS bootstrapping: ModRaise -> CoeffsToSlots -> EvalMod -> SlotsToCoeffs.

  * ModRaise: lift the last-limb residues (centered) onto the full chain:
    the integer plaintext becomes s*m + q0*I with |I| <= K (sparse secret),
    s the incoming tracked scale.
  * CtS: homomorphic multiply by V^-1 (the special-FFT factor groups of
    boot/transform.py as BSGS diagonal transforms, one or two levels per
    group).  The factor s/q0 multiplies the last group at encode time, so
    the slots land on y = (s/q0)*m_c + I_c: a fraction around exact
    integers, the form the sine needs.
  * EvalMod: sin(2*pi*y) via a Chebyshev series of cos(2*pi*(y-1/4)/2^r)
    on [-K, K] and r double-angle steps (cos 2t = 2 cos^2 t - 1), on the
    real and imaginary packings from a conjugation split, as one batch-2
    chain.
  * StC: homomorphic multiply by V, with q0/(2*pi*s) folded into its first
    group, recombining real + i*imag.

`wide=True` runs CtS's exit, EvalMod and StC's entry at the paired working
scale ~delta^2 (one CtS group raises it, the last StC group lowers it).
`simulate()` repeats every folding decision in numpy: the precision oracle.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext, Plaintext
from ..ckks.evaluator import Evaluator, _nct
from ..linalg.packed import PackedOps
from ..ops import ntt
from ..ops.modarith import submod
from ..poly.cheb import chebyshev_fit
from ..poly.eval import PolyEvaluator
from ..utils.timing import GLOBAL_TIMERS
from .transform import (diagonals_of, group_stages, special_fft_stages,
                        special_ifft_stages)


@dataclass
class BootConfig:
    level_budget: tuple = (3, 3)     # CtS / StC groups
    K: int = 16                      # bound on |I| (sparse ternary secret)
    sin_degree: int = 119
    double_angles: int = 3
    bs: int = 0                      # BSGS baby size; 0 = auto
    # wide: run CtS's exit -> EvalMod -> StC at the paired working scale
    # ~delta^2 = 2^52, so per-op noise sits at 2^-43 relative; costs ~2x
    # the limbs between CtS and StC (the 'linformer-boot-w' chain)
    wide: bool = False
    # scale_boost: exact power-of-two pre-multiplier on the input scale
    # (message * f reinterpreted as scale * f): raises s_in toward q0, so
    # noise injected before StC's q0/(2*pi*s_in) fold is amplified less.
    # Needs |message| * boost * scale < q0/2 at mod-raise.
    scale_boost: int = 1
    # wide_early: enter the paired scale at CtS group 0, not the last group
    wide_early: bool = False
    # out_boost: land the output at out_boost * scale (folded into beta,
    # the tracked scale reinterpreted)
    out_boost: int = 1
    # msg_bound: twice the |message| bound the mod-raise guard assumes
    msg_bound: float = 2.0

    @classmethod
    def wide_production(cls, scale_boost: int = 2, wide_early: bool = False,
                        out_boost: int = 1, msg_bound: float = 2.0
                        ) -> "BootConfig":
        """The production config: paired-scale internal pipeline + input
        scale boost (pair with the 'linformer-boot-w' preset)."""
        return cls(wide=True, scale_boost=int(scale_boost),
                   wide_early=wide_early, out_boost=int(out_boost),
                   msg_bound=float(msg_bound))


class Bootstrapper:
    """`chunk` > 0 caps the ciphertexts one bootstrap processes at once
    (the batch is split, the last part zero-padded); `two_pass` makes
    refresh() run bootstrap2 (default: for narrow configs only)."""

    def __init__(self, ev: Evaluator, cfg: BootConfig | None = None,
                 chunk: int = 0, two_pass: bool | None = None):
        self.ev = ev
        self.cfg = cfg or BootConfig()
        ctx = ev.ctx
        self.M = ctx.cfg.slots
        self.ops = PackedOps(ev, d=1)
        self.cts_diags, self.stc_diags, self.bs = self._transform_plan(
            ctx.cfg.n, self.cfg)
        self.q0 = float(ctx.qs[0])
        self.chunk = chunk
        self.two_pass = (not self.cfg.wide) if two_pass is None else two_pass
        r = self.cfg.double_angles
        self.sin_coeffs = chebyshev_fit(
            lambda y: np.cos(2 * np.pi * (y - 0.25) / (1 << r)),
            -self.cfg.K, self.cfg.K, self.cfg.sin_degree)
        self.poly = PolyEvaluator(ev, wide=self.cfg.wide)
        self._fold_cache: dict = {}

    # -- key requirements ----------------------------------------------------

    @staticmethod
    def _transform_plan(n: int, cfg: BootConfig):
        """(cts_diags, stc_diags, bs) for ring dim n.  The bit-reversal
        permutation is dropped from both transforms: CtS runs the inverse
        butterflies only (slots land bit-reversed), EvalMod is
        slot-elementwise, and StC's forward butterflies consume that order,
        so the permutations cancel and every group stays BSGS-sparse."""
        _, fwd_stages = special_fft_stages(n)
        cts_groups = group_stages(special_ifft_stages(n)[:-1],
                                  cfg.level_budget[0])
        stc_groups = group_stages(fwd_stages, cfg.level_budget[1])
        cts_diags = [diagonals_of(g) for g in cts_groups]
        stc_diags = [diagonals_of(g) for g in stc_groups]
        maxd = max(len(d) for d in cts_diags + stc_diags)
        bs = cfg.bs or (1 << max(1, int(math.ceil(
            math.log2(max(2, maxd)) / 2))))
        return cts_diags, stc_diags, bs

    @classmethod
    def rotations_for(cls, n: int, cfg: BootConfig | None = None):
        """Rotation-key shifts bootstrapping needs at ring dim n (callable
        before key generation)."""
        cts, stc, bs = cls._transform_plan(n, cfg or BootConfig())
        need = set()
        for dg in cts + stc:
            need |= PackedOps.bsgs_required_rotations(dg.keys(), bs, n // 2)
        return tuple(sorted(need))

    def required_rotations(self):
        need = set()
        for dg in self.cts_diags + self.stc_diags:
            need |= PackedOps.bsgs_required_rotations(dg.keys(), self.bs,
                                                      self.M)
        return tuple(sorted(need))

    # -- stages --------------------------------------------------------------

    def mod_raise(self, ct: Ciphertext) -> Ciphertext:
        """Last-level ciphertext -> full-chain ciphertext of the same
        integer plaintext (+ q0*I): the centered lift of limb 0 onto every
        limb.  The limb-0 slice goes to the inverse NTT as it is (K2 reads
        it in place), the lift to the forward NTT on all limbs."""
        ev, ctx = self.ev, self.ev.ctx
        ct = ev.drop_to(ct, 1)
        full = ctx.num_q
        limbs = ctx.limb_idx(full)
        q0 = int(ctx.qs[0])
        qrem = ctx.mod(limbs)
        q0mod = ctx.tensor((q0 % np.asarray(ctx.qs, np.int64))
                           .reshape(-1, 1).astype(np.int32))
        outs = []
        for c in (ct.c0, ct.c1):
            v = ntt.inv(c, ctx.ntt, (0,))
            vm = torch.remainder(v, qrem)
            lift = torch.where(v <= q0 // 2, vm, submod(vm, q0mod, qrem))
            outs.append(ntt.fwd(lift, ctx.ntt, limbs))
        return Ciphertext(outs[0], outs[1], full, ct.scale)

    def _folded(self, which: str, gi: int, mult: complex):
        """Folded diagonal dicts cached by (which, gi, mult), so the
        plaintext cache (keyed by dict identity) stays hot across calls."""
        key = (which, gi, mult)
        if key not in self._fold_cache:
            dg = (self.cts_diags if which == "cts" else self.stc_diags)[gi]
            self._fold_cache[key] = dg if mult == 1.0 else \
                {k: d * mult for k, d in dg.items()}
        return self._fold_cache[key]

    def coeffs_to_slots(self, ct: Ciphertext) -> Ciphertext:
        alpha = ct.scale / self.q0
        last = len(self.cts_diags) - 1
        raise_at = 0 if (self.cfg.wide and self.cfg.wide_early) else last
        for gi in range(len(self.cts_diags)):
            dg = self._folded("cts", gi, alpha if gi == last else 1.0)
            # wide: one group raises the working scale by one prime
            mode = "raise" if (self.cfg.wide and gi == raise_at) \
                else "double"
            ct = self.ops.bsgs_diag_transform(ct, dg, self.bs,
                                              rescale_mode=mode)
        return ct

    def slots_to_coeffs(self, ct_r: Ciphertext, ct_i: Ciphertext,
                        s_in: float, out_div: float = 1.0) -> Ciphertext:
        """Recombine yr + i*yi inside the first StC group: both operands go
        through identical op chains, so their tracked scales agree exactly.
        out_div divides the output message (folded into the constant), with
        the tracked (nl, scale) unchanged."""
        ev = self.ev
        beta = self.q0 / (2 * math.pi * s_in * out_div)
        last = len(self.stc_diags) - 1

        def mode(gi):
            # wide: the last StC group lowers the paired scale back
            return "lower" if (self.cfg.wide and gi == last) else "double"
        a = self.ops.bsgs_diag_transform(ct_r, self._folded("stc", 0, beta),
                                         self.bs, rescale_mode=mode(0))
        b = self.ops.bsgs_diag_transform(ct_i,
                                         self._folded("stc", 0, beta * 1j),
                                         self.bs, rescale_mode=mode(0))
        ct = ev.add(a, b)
        for gi in range(1, len(self.stc_diags)):
            ct = self.ops.bsgs_diag_transform(
                ct, self._folded("stc", gi, 1.0), self.bs,
                rescale_mode=mode(gi))
        return ct

    def eval_mod(self, ct: Ciphertext, pre_factor: complex) -> Ciphertext:
        """sin(2 pi y) via the cosine series and double angles; pre_factor
        folds the conjugation-split constant and the [-K,K] -> [-1,1]
        normalization into one exact complex multiply."""
        ev = self.ev
        pt = ev.encode(np.full(self.M, pre_factor / self.cfg.K), nl=ct.nl,
                       scale=self._pre_scale(ct.nl))
        y = self._wide_pt_rescale(ev.mul_plain(ct, pt, rescale=False),
                                  ct.scale)
        return self._eval_mod_tail(y)

    def _pre_scale(self, nl: int) -> float | None:
        """Plaintext scale of the EvalMod pre-factor: wide, the exact
        product of the two primes the double rescale drops."""
        if not self.cfg.wide:
            return None
        qs = self.ev.ctx.qs
        return float(qs[nl - 1]) * float(qs[nl - 2])

    def _wide_pt_rescale(self, y: Ciphertext, s_in: float) -> Ciphertext:
        """After the pre-factor multiply: one rescale, two when wide."""
        ev = self.ev
        y = ev.rescale(y)
        if self.cfg.wide:
            y = ev.rescale(y)
            y.scale = s_in          # exact by construction
        return y

    def eval_mod_pair(self, pair: Ciphertext) -> Ciphertext:
        """eval_mod on the stacked (2, ...) re/im pair with per-element
        pre-factors (0.5, -0.5j): one batched Chebyshev chain.  The (2, nl,
        N) plaintext broadcasts over the pair's batch axes."""
        ev = self.ev
        rows = np.stack([np.full(self.M, 0.5 / self.cfg.K),
                         np.full(self.M, -0.5j / self.cfg.K)])
        pt = ev.encode(rows, nl=pair.nl, batch=True,
                       scale=self._pre_scale(pair.nl))
        nb = pair.c0.dim() - 3          # batch dims between the pair axis
        if nb:                          # and (nl, N)
            pt = Plaintext(pt.data.reshape((2,) + (1,) * nb +
                                           tuple(pt.data.shape[-2:])),
                           pt.nl, pt.scale)
        y = self._wide_pt_rescale(ev.mul_plain(pair, pt, rescale=False),
                                  pair.scale)
        return self._eval_mod_tail(y)

    def _eval_mod_tail(self, y: Ciphertext) -> Ciphertext:
        ev = self.ev
        g = self.poly.eval_chebyshev_series(y, self.sin_coeffs)
        anchor = self.poly.anchor
        for _ in range(self.cfg.double_angles):
            # backstop: each squaring doubles the log-scale drift
            if abs(math.log2(g.scale / anchor)) > 8.0 and g.nl > 1:
                g = ev.adjust(g, g.nl - 1, anchor)
            g = self.poly._sq2m1(g)
        return g

    def bootstrap(self, ct: Ciphertext, out_div: float = 1.0) -> Ciphertext:
        """Refresh a depleted ciphertext to the full chain minus the boot
        depth.  Counts the real batch once; with `self.chunk` the batch,
        its leading axes flattened, runs in parts of that many ciphertexts
        (each ciphertext's bootstrap is independent of the others)."""
        count = _nct(ct)
        GLOBAL_TIMERS.count("bootstrap", count)
        bc = self.chunk
        if not (bc and count > bc):
            return self._bootstrap_impl(ct, out_div)
        lead, tail = tuple(ct.c0.shape[:-2]), tuple(ct.c0.shape[-2:])
        flat = ct.with_data(ct.c0.reshape((count,) + tail),
                            ct.c1.reshape((count,) + tail))
        outs = []
        for s in range(0, count, bc):
            part = flat.with_data(flat.c0[s: s + bc], flat.c1[s: s + bc])
            if part.c0.shape[0] < bc:          # pad: keep shapes uniform
                z = torch.zeros((bc - part.c0.shape[0],) + tail,
                                dtype=part.c0.dtype, device=part.c0.device)
                part = part.with_data(torch.cat([part.c0, z]),
                                      torch.cat([part.c1, z]))
            outs.append(self._bootstrap_impl(part, out_div))
        unflat = lambda x: x[:count].reshape(lead + tuple(x.shape[-2:]))
        return outs[0].with_data(unflat(torch.cat([o.c0 for o in outs])),
                                 unflat(torch.cat([o.c1 for o in outs])))

    def _bootstrap_impl(self, ct: Ciphertext,
                        out_div: float = 1.0) -> Ciphertext:
        """One uncounted, unchunked bootstrap."""
        f = int(self.cfg.scale_boost)
        if f > 1:
            # message * f at the same scale, then reinterpreted: exact
            assert f * ct.scale * self.cfg.msg_bound < self.q0, \
                (f, ct.scale, self.cfg.msg_bound, self.q0)
            ct = self.ev.mul_scalar_int(ct, f)
            ct.scale = ct.scale * f
        s_in = ct.scale
        enc = self.coeffs_to_slots(self.mod_raise(ct))
        cj = self.ev.conjugate(enc)
        rsum = self.ev.add(enc, cj)            # 2 * Re
        dif = self.ev.sub(enc, cj)             # 2i * Im
        pair = rsum.with_data(torch.stack([rsum.c0, dif.c0]),
                              torch.stack([rsum.c1, dif.c1]))
        g = self.eval_mod_pair(pair)           # identical chains, batch 2
        yr = g.with_data(g.c0[0], g.c1[0])
        yi = g.with_data(g.c0[1], g.c1[1])
        ob = float(self.cfg.out_boost)
        out = self.slots_to_coeffs(yr, yi, s_in, out_div / ob)
        if ob != 1.0:
            out.scale = out.scale * ob
        return out

    def refresh(self, ct: Ciphertext) -> Ciphertext:
        """The circuit's refresh: bootstrap2 when `two_pass`, else one
        bootstrap."""
        return self.bootstrap2(ct) if self.two_pass else self.bootstrap(ct)

    def bootstrap2(self, ct: Ciphertext, prec_bits: int = 5) -> Ciphertext:
        """Two-iteration bootstrap: boot once, scale the residual error up
        by 2^p, boot it (folding 2^-p into StC), and subtract.  The output
        (nl, scale) equals one bootstrap's."""
        ev = self.ev
        y1 = self.bootstrap(ct)
        y1_low = ev.adjust(y1, 1, ct.scale) if y1.nl > 1 else y1
        e = ev.sub(y1_low, ev.drop_to(ct, 1))
        e = ev.mul_scalar_int(e, 1 << prec_bits)
        eb = self.bootstrap(e, out_div=float(1 << prec_bits))
        return ev.sub(y1, eb)

    # -- numpy simulator (precision oracle) ----------------------------------

    def simulate(self, slots_raised: np.ndarray, s_in: float) -> np.ndarray:
        """Given the decoded slots of the raised ciphertext (at scale s_in),
        the slot values the bootstrap should output."""
        y = np.asarray(slots_raised, np.complex128)
        for gi, dg in enumerate(self.cts_diags):
            m = (s_in / self.q0) if gi == len(self.cts_diags) - 1 else 1.0
            y2 = np.zeros_like(y)
            for k, d in dg.items():
                y2 += d * m * np.roll(y, -k)
            y = y2

        def evalmod(x):
            g = np.polynomial.chebyshev.chebval(x / self.cfg.K,
                                                self.sin_coeffs)
            for _ in range(self.cfg.double_angles):
                g = 2 * g * g - 1
            return g

        z = evalmod(np.real(y)) + 1j * evalmod(np.imag(y))
        for gi, dg in enumerate(self.stc_diags):
            m = self.q0 / (2 * math.pi * s_in) if gi == 0 else 1.0
            z2 = np.zeros_like(z)
            for k, d in dg.items():
                z2 += d * m * np.roll(z, -k)
            z = z2
        return z
