"""Packed homomorphic linear algebra over CKKS slots (the JAX package's
`linalg/packed.py`): slot layouts and masks, rotate-accumulate trees, the
RE/CR/BSGS matmul families, batched interleave/deinterleave and the
wrap/unwrap helpers, and the BSGS diagonal transform with its four rescale
modes, on the double-hoisted combo.

Layout conventions over slots = nb * d:
  expanded:  slot[d*j + i] = v[j]   (value j fills block j)
  repeated:  slot[d*j + i] = v[i]   (d-vector tiled nb times)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext, Plaintext
from ..ckks.evaluator import Evaluator


def _log2(x: int) -> int:
    lg = x.bit_length() - 1
    assert 1 << lg == x, f"{x} not a power of two"
    return lg


class PackedOps:
    def __init__(self, ev: Evaluator, d: int = 128):
        self.ev = ev
        self.d = d
        self.slots = ev.ctx.cfg.slots
        self.nb = self.slots // d

    def required_rotations(self) -> tuple[int, ...]:
        """Power-of-two shifts (both signs) covering the rotsum/repeat
        trees."""
        out, s = set(), 1
        while s < self.slots:
            out |= {s, -s}
            s *= 2
        return tuple(sorted(out))

    # -- slot patterns -------------------------------------------------------

    def expanded_slots(self, v: np.ndarray) -> np.ndarray:
        full = np.zeros(self.nb)
        full[: len(v)] = v
        return np.repeat(full, self.d)

    def repeated_slots(self, v: np.ndarray) -> np.ndarray:
        full = np.zeros(self.d)
        full[: len(v)] = v
        return np.tile(full, self.nb)

    def matrix_cr_slots(self, W: np.ndarray) -> np.ndarray:
        """Weight layout slot[d*j + i] = W[j][i]."""
        Wp = np.zeros((self.nb, self.d))
        Wp[: W.shape[0], : W.shape[1]] = W
        return Wp.reshape(-1)

    def matrix_re_slots(self, W: np.ndarray) -> np.ndarray:
        """Weight layout slot[d*j + i] = W[i][j]."""
        d = self.d
        out = np.zeros(self.slots)
        W = np.asarray(W)
        if W.shape[0] == d:
            out[: W.shape[1] * d] = W.T.reshape(-1)[: W.shape[1] * d]
        else:
            Wt = np.pad(W.T, ((0, 0), (0, d - W.shape[0]))).reshape(-1)
            out[: Wt.shape[0]] = Wt
        return out

    # -- masks -------------------------------------------------------------

    def mask_block(self, j: int, value: float = 1.0) -> np.ndarray:
        m = np.zeros(self.slots)
        m[j * self.d: (j + 1) * self.d] = value
        return m

    def mask_mod_n(self, n: int, value: float = 1.0,
                   offset: int = 0) -> np.ndarray:
        m = np.zeros(self.slots)
        m[offset::n] = value
        return m

    def mask_first_n(self, n: int, value: float = 1.0) -> np.ndarray:
        m = np.zeros(self.slots)
        m[:n] = value
        return m

    def mask_heads(self, stride: int, value: float = 1.0) -> np.ndarray:
        """1 on the first `stride` lanes of every block."""
        m = np.zeros(self.slots)
        for j in range(self.nb):
            m[j * self.d: j * self.d + stride] = value
        return m

    # -- rotate-accumulate trees --------------------------------------------

    def rotsum(self, ct: Ciphertext, count: int, padding: int) -> Ciphertext:
        """slot[s] += sum over count strided copies: log-depth tree."""
        return self._acc_tree(ct, [padding * (1 << i)
                                   for i in range(_log2(count))])

    def repeat(self, ct: Ciphertext, count: int,
               padding: int = 1) -> Ciphertext:
        """Broadcast by negative-rotation tree."""
        return self._acc_tree(ct, [-padding * (1 << i)
                                   for i in range(_log2(count))])

    def _acc_tree(self, ct: Ciphertext, shifts) -> Ciphertext:
        ev = self.ev
        if ev.has_rotation_keys(shifts):
            return ev.rotate_accumulate_tree(ct, shifts)
        for s in shifts:
            ct = ev.add(ct, ev.rotate(ct, s))
        return ct

    # -- matmul families --------------------------------------------------

    def matmul_re(self, ct_exp: Ciphertext, w_pt: Plaintext,
                  bias_slots: np.ndarray | None = None) -> Ciphertext:
        """expanded x (matrix in RE layout) -> repeated y = W x (+ b), the
        bias encoded at the post-rescale scale."""
        out = self.ev.mul_plain(ct_exp, w_pt)
        out = self.rotsum(out, self.nb, self.d)
        if bias_slots is not None:
            pt = self.ev.encode(bias_slots, nl=out.nl, scale=out.scale)
            out = self.ev.add_plain(out, pt)
        return out

    def matmul_cr(self, ct_rep: Ciphertext, w_pt: Plaintext,
                  width: int | None = None) -> Ciphertext:
        """repeated x (matrix in CR layout) -> expanded-dirty y = W x:
        slot[d*j] = y_j, the other lanes partial sums (masked later)."""
        out = self.ev.mul_plain(ct_rep, w_pt)
        return self.rotsum(out, width or self.d, 1)

    def matmul_bsgs(self, ct: Ciphertext, W: np.ndarray,
                    scale: float | None = None) -> Ciphertext:
        """y = W @ x for x in slots [0, dim), W (dim x dim), dim a power of
        two dividing slots: baby-step/giant-step over the generalized
        diagonals (tiled over the slots), babies by hoisted rotations."""
        ev = self.ev
        dim = W.shape[0]
        assert W.shape == (dim, dim)
        bs = 1 << -(-(dim.bit_length() - 1) // 2)
        gs = dim // bs
        i = np.arange(dim)
        diags = {k: np.tile(W[i % dim, (i + k) % dim], self.slots // dim)
                 for k in range(dim)}
        baby = ev.rotate_hoisted(ct, range(bs))
        acc = None
        for g in range(gs):
            inner = None
            for j in range(bs):
                k = g * bs + j
                dk = np.roll(diags[k], g * bs)
                pt = ev.encode(dk, nl=ct.nl, scale=scale or ev.ctx.delta)
                term = ev.mul_plain(baby[j], pt, rescale=False)
                inner = term if inner is None else ev.add(inner, term)
            rot = ev.rotate(inner, g * bs) if g else inner
            acc = rot if acc is None else ev.add(acc, rot)
        return ev.rescale(acc)

    # -- batched log-tree interleave -----------------------------------------

    def interleave_batch(self, ct: Ciphertext, stride: int = 1) -> Ciphertext:
        """(m, ...) batch -> single ct; batch index t lands at lane offset
        t*stride.  Caller pre-masks so merged slots don't collide."""
        ev = self.ev
        m = ct.c0.shape[0]
        mp = 1 << (m - 1).bit_length()
        if mp != m:
            pad = torch.zeros((mp - m,) + ct.c0.shape[1:], dtype=ct.c0.dtype,
                              device=ct.c0.device)
            ct = ct.with_data(torch.cat([ct.c0, pad]), torch.cat([ct.c1, pad]))
        step = 1
        while ct.c0.shape[0] > 1:
            even = ct.with_data(ct.c0[0::2], ct.c1[0::2])
            odd = ev.rotate(ct.with_data(ct.c0[1::2], ct.c1[1::2]),
                            -step * stride)
            ct = ev.add(even, odd)
            step *= 2
        return ct.with_data(ct.c0[0], ct.c1[0])

    def deinterleave_batch(self, ct: Ciphertext, m: int,
                           stride: int = 1) -> Ciphertext:
        """Single ct -> (m, ...) batch with element t = rotate(ct, t*stride).
        The prefix of shifts with dedicated keys builds via one hoisted
        multi-rotate; remaining doublings use batched rotations."""
        ev = self.ev
        p = 1
        while p * 2 <= m and ev.has_rotation_keys(
                [t * stride for t in range(1, p * 2)]):
            p *= 2
        if p > 1:
            stk = ev.multi_rotate_stack(ct, [t * stride for t in range(1, p)])
            out = ct.with_data(torch.cat([ct.c0[None], stk.c0]),
                               torch.cat([ct.c1[None], stk.c1]))
        else:
            out = ct.with_data(ct.c0[None], ct.c1[None])
        k = p
        while out.c0.shape[0] < m:
            rot = ev.rotate(out, k * stride)
            out = out.with_data(torch.cat([out.c0, rot.c0]),
                                torch.cat([out.c1, rot.c1]))
            k *= 2
        return out.with_data(out.c0[:m], out.c1[:m])

    def unwrap_to_repeated(self, ct: Ciphertext, m: int) -> Ciphertext:
        """Inverse of an interleaved wrap: an (m, ...) batch of repeated
        cts, one per interleaved lane."""
        ev = self.ev
        batch = self.deinterleave_batch(ct, m, 1)
        pt = ev.encode_cached(("mask_mod_n", self.d, 0),
                              self.mask_mod_n(self.d), nl=batch.nl)
        return self.repeat(ev.mul_plain(batch, pt), self.d, 1)

    # -- BSGS diagonal transform on the double-hoisted combo -------------------

    def bsgs_diag_transform(self, ct: Ciphertext, diags: dict[int, np.ndarray],
                            bs: int, scale: float | None = None,
                            double_rescale: bool = False,
                            rescale_mode: str | None = None) -> Ciphertext:
        """y_i = sum_k diags[k][i] * x[(i+k) mod slots]: BSGS over a sparse
        diagonal set with offsets decomposed stride-aware as
        k = stride*(g*bs + j), on the double-hoisted combo: the
        decomposition runs once; stage 1 (per baby permutation + key inner
        products) is shared by every giant group; each group accumulates
        plaintext-weighted rows with one lazy mod-down; giant shifts
        without a dedicated key compose (rotate_any); plaintexts are
        level-independent coefficient vectors, cached per diagonal (keyed
        by the dict's id; each cache entry holds the dict).

        rescale_mode (double_rescale=True means "double"), with qd, qd2
        the top two primes:
          "single" - plaintexts at `scale` (delta), drop 1
          "double" - plaintexts at qd*qd2, drop 2, scale out = scale in
          "raise"  - plaintexts at qd*qd2, drop 1, scale out = scale in * qd2
                     (enters the bootstrap's paired working scale)
          "lower"  - plaintexts at qd, drop 2, scale out = scale in / qd2
                     (leaves it)"""
        ev = self.ev
        mode = rescale_mode or ("double" if double_rescale else "single")
        qd = float(ev.ctx.qs[ct.nl - 1])
        qd2 = float(ev.ctx.qs[ct.nl - 2]) if ct.nl >= 2 else 1.0
        if mode in ("double", "raise"):
            scale = qd * qd2
        elif mode == "lower":
            scale = qd
        else:
            scale = scale or ev.ctx.delta
        stride, by_giant = self.by_giant(diags, bs)
        acc = ev.rescale(self._bsgs_combo(ct, diags, by_giant, bs, stride,
                                          scale))
        if mode == "double":
            acc = ev.rescale(acc)
            acc.scale = ct.scale        # exact by construction
        elif mode == "raise":
            acc.scale = ct.scale * qd2  # qd cancelled by the one rescale
        elif mode == "lower":
            acc = ev.rescale(acc)
            acc.scale = ct.scale / qd2
        return acc

    def by_giant(self, diags: dict, bs: int):
        """(stride, {giant g: {baby j: diagonal}}) of a diagonal set, each
        offset k = stride*(g*bs + j)."""
        stride = self._diag_stride(diags.keys(), self.slots)
        by_giant: dict[int, dict[int, np.ndarray]] = {}
        for k, d in diags.items():
            g, j = divmod((k % self.slots) // stride, bs)
            by_giant.setdefault(g, {})[j] = d
        return stride, by_giant

    def _bsgs_combo(self, ct, diags, by_giant, bs, stride, scale):
        groups = self.ev.cached(
            ("combo", id(diags), bs, float(scale)),
            lambda: self.combo_plaintexts(by_giant, bs, stride, scale),
            holds=diags)
        babies = self.combo_babies([groups])
        stage1 = self.combo_stage1(ct, babies)
        return self.combo_groups(ct, stage1, groups, babies)

    def combo_plaintexts(self, by_giant, bs: int, stride: int,
                         scale: float | None = None, tile: int = 1):
        """The combo's giant groups [(giant shift, [(baby shift,
        CoeffPlaintext)])] of a by_giant set: each diagonal rolled by its
        giant shift g*bs*stride, repeated `tile` times (a d-lane pattern
        over the slots), and all of them encoded in one batch on the device
        (Evaluator.encode_coeff_many)."""
        ev = self.ev
        items = [(g, j, d) for g, js in sorted(by_giant.items())
                 for j, d in sorted(js.items())]
        rows = torch.as_tensor(np.stack([
            np.roll(np.asarray(d), g * bs * stride) for g, _, d in items]),
            device=ev.ctx.device).repeat(1, tile)
        pts = iter(ev.encode_coeff_many(rows, scale))
        groups: dict = {}
        for g, j, _ in items:
            groups.setdefault(g * bs * stride, []).append(
                (j * stride, next(pts)))
        return list(groups.items())

    @staticmethod
    def combo_babies(group_sets) -> list[int]:
        """The nonzero baby shifts of every group set, sorted: the rows of
        the stage 1 that the sets share."""
        return sorted({r for groups in group_sets for _, items in groups
                       for r, _ in items if r})

    def combo_stage1(self, ct: Ciphertext, babies):
        """The combo's stage 1 of ct over `babies` (None without babies):
        the decomposition, the baby permutations and their key inner
        products, computed once for every group set applied to ct."""
        if not babies:
            return None
        ev = self.ev
        ks = ev.ctx.ks_tables(ct.nl)
        return ev.combo_stage1(ct, ev.hoist_decompose(ct, ks), babies, ks)

    def combo_groups(self, ct: Ciphertext, stage1, groups, babies):
        """sum over giant groups (shift, [(baby shift, CoeffPlaintext)]) of
        rotate(sum of plaintext x baby rotation, shift), from combo_stage1's
        rows (one mod-down per group); un-rescaled."""
        ev = self.ev
        ks = ev.ctx.ks_tables(ct.nl)
        if stage1 is not None and ev.has_rotation_keys(gs for gs, _ in groups):
            gshifts, stacked = ev.combo_stage2_all(ct, stage1, groups,
                                                   babies, ks)
            return ev.multi_rotate_sum(stacked, gshifts)
        acc = None
        for gshift, items in groups:
            inner = ev.combo_stage2(ct, stage1, items, babies, ks)
            rot = ev.rotate_any(inner, gshift) if gshift else inner
            acc = rot if acc is None else ev.add(acc, rot)
        return acc

    @staticmethod
    def _diag_stride(offsets, slots: int) -> int:
        g = slots
        for k in offsets:
            if k % slots:
                g = math.gcd(g, k % slots)
        return max(g, 1)

    @staticmethod
    def bsgs_required_rotations(offsets, bs: int, slots: int) -> set[int]:
        stride = PackedOps._diag_stride(offsets, slots)
        need = set()
        for k in offsets:
            g, j = divmod((k % slots) // stride, bs)
            if j:
                need.add(j * stride)
            if g:
                need.add(g * bs * stride)
        return need

    # -- wrap / unwrap -----------------------------------------------------

    def wrap_up_repeated(self, cts: list[Ciphertext],
                         scale: float | None = None) -> Ciphertext:
        """Mask block j of ct j and sum: n repeated cts -> one ct whose
        block j holds ct j's d-vector."""
        ev = self.ev
        out = None
        for j, ct in enumerate(cts):
            pt = ev.encode(self.mask_block(j), nl=ct.nl,
                           scale=scale or ev.ctx.delta)
            t = ev.mul_plain(ct, pt, rescale=False)
            out = t if out is None else ev.add(out, t)
        return ev.rescale(out)

    def wrap_up_expanded(self, cts: list[Ciphertext]) -> Ciphertext:
        """Stride-mask + interleave n expanded-dirty cts into one ct:
        slot[d*j + t] = ct_t's y_j."""
        ev = self.ev
        out = None
        for t, ct in enumerate(cts):
            pt = ev.encode(self.mask_mod_n(self.d), nl=ct.nl)
            m = ev.mul_plain(ct, pt, rescale=False)
            if t:
                m = ev.rotate(m, -t)
            out = m if out is None else ev.add(out, m)
        return ev.rescale(out)

    def unwrap_expanded(self, ct: Ciphertext, index: int) -> Ciphertext:
        """Extract interleaved column `index` back to a repeated ct."""
        ev = self.ev
        pt = ev.encode(self.mask_mod_n(self.d, offset=index), nl=ct.nl)
        m = ev.mul_plain(ct, pt, rescale=False)
        if index:
            m = ev.rotate(m, index)
        return self.repeat(ev.rescale(m), self.d, 1)
