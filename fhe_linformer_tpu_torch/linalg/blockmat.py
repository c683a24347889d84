"""Block-major matrix packing: one ciphertext holds a whole token matrix,
slot[d*t + i] = X[t, i], for nb = slots/d tokens per ciphertext (128 tokens
of d = 128 dims at 16384 slots).

A dense d x d projection y[t, :] = W @ x[t, :] for all nb tokens at once is
a BSGS diagonal transform with 2d masked diagonals: each block-local
diagonal u splits into a rotate-by-u part and a rotate-by-(u-d) wrap part,
riding the double-hoisted rotation combo.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext
from ..ckks.evaluator import Evaluator
from .packed import PackedOps


class BlockOps:
    def __init__(self, ev: Evaluator, d: int = 128, bs: int = 16,
                 chunk_tokens: int | None = None):
        self.ev = ev
        self.d = d
        self.slots = ev.ctx.cfg.slots
        self.nb = self.slots // d
        # chunk_tokens < nb trades slot occupancy for a chunk count
        self.chunk_tokens = min(chunk_tokens or self.nb, self.nb)
        assert self.chunk_tokens > 0
        self.bs = min(bs, d)
        self.ops = PackedOps(ev, d)
        self._diag_cache: dict = {}

    def required_baby_rotations(self) -> tuple[int, ...]:
        """The non-pow2 shifts block matmuls need as dedicated keys (BSGS
        babies must be single automorphisms for hoisting)."""
        return tuple(j for j in range(1, self.bs) if j & (j - 1) != 0)

    # -- host packing ----------------------------------------------------

    def pack(self, X: np.ndarray) -> np.ndarray:
        """(T, d) token matrix -> slot vector, T <= nb."""
        out = np.zeros((self.nb, self.d))
        out[: X.shape[0], : X.shape[1]] = X
        return out.reshape(-1)

    def pack_chunks(self, X: np.ndarray) -> np.ndarray:
        """(S, d) -> (ceil(S/chunk_tokens), slots) chunked block-major slots."""
        step = self.chunk_tokens
        C = -(-X.shape[0] // step)
        out = np.zeros((C, self.slots))
        for c in range(C):
            out[c] = self.pack(X[c * step: (c + 1) * step])
        return out

    def unpack_chunks(self, slots: np.ndarray, S: int) -> np.ndarray:
        """(C, slots) -> (S, d): inverse of pack_chunks."""
        step = self.chunk_tokens
        rows = [self.unpack(s, min(step, S - c * step))
                for c, s in enumerate(np.asarray(slots))]
        return np.concatenate(rows, 0)

    def unpack(self, slots: np.ndarray, T: int) -> np.ndarray:
        """Inverse of pack."""
        return np.asarray(slots).reshape(self.nb, self.d)[:T]

    # -- the block-local matmul ---------------------------------------------

    def matmul_diags(self, W: np.ndarray, key) -> dict:
        """Diagonal set for y[t, j] = sum_i W[j, i] x[t, i] applied to every
        block t.  Diagonal u contributes W[j, j+u] at output slot d*t + j;
        lanes that would read past the block boundary move to the wrap
        diagonal at global offset (u - d) mod slots."""
        if key in self._diag_cache:
            return self._diag_cache[key]
        d, nb = self.d, self.nb
        W = np.asarray(W, float)
        dj, di = W.shape
        assert dj <= d and di <= d
        Wp = np.zeros((d, d))
        Wp[:dj, :di] = W
        diags: dict[int, np.ndarray] = {}
        for u in range(d):
            main = np.array([Wp[j, j + u] if j + u < d else 0.0
                             for j in range(d)])
            wrap = np.array([Wp[j, j + u - d] if j + u >= d else 0.0
                             for j in range(d)])
            if np.any(main):
                diags[u] = np.tile(main, nb)
            if u and np.any(wrap):
                diags[(u - d) % self.slots] = np.tile(wrap, nb)
        self._diag_cache[key] = diags
        return diags

    def matmul(self, ct: Ciphertext, W: np.ndarray, key,
               bias: np.ndarray | None = None,
               w_scale: float = 1.0) -> Ciphertext:
        """Block-major y = X @ (w_scale*W)^T (+ bias per output lane), all
        nb tokens per ct and any leading chunk dims at once."""
        ev = self.ev
        diags = self.matmul_diags(np.asarray(W) * w_scale, (key, w_scale))
        out = self.ops.bsgs_diag_transform(ct, diags, self.bs)
        if bias is not None:
            b = np.zeros(self.d)
            b[: len(bias)] = np.asarray(bias) * w_scale
            pt = ev.encode_cached((key, "bias", w_scale), np.tile(b, self.nb),
                                  nl=out.nl, scale=out.scale)
            out = ev.add_plain(out, pt)
        return out

    # -- row broadcast (for ct x ct contractions) -----------------------------

    def rows_to_repeated(self, ct: Ciphertext, k: int) -> Ciphertext:
        """Single block-major ct (rows u < k valid) -> (k, ...) batch where
        element u tiles row u's d-vector across every block."""
        ev, ops = self.ev, self.ops
        batch = ops.deinterleave_batch(ct, k, stride=self.d)
        pt = ev.encode_cached(("mask_block0", self.d), ops.mask_block(0),
                              nl=batch.nl)
        return ops.repeat(ev.mul_plain(batch, pt), self.nb, self.d)

    def lane_rows_to_blocks(self, ct: Ciphertext, k: int) -> Ciphertext:
        """ct with values at lane u of each block (u < k) -> (k, ...) batch
        where element u fills each block with its lane-u value."""
        ev, ops = self.ev, self.ops
        batch = ops.deinterleave_batch(ct, k, stride=1)
        pt = ev.encode_cached(("mask_mod_n", self.d, 0),
                              ops.mask_mod_n(self.d), nl=batch.nl)
        return ops.repeat(ev.mul_plain(batch, pt), self.d, 1)

    def reduce_batch(self, ct: Ciphertext) -> Ciphertext:
        """Sum a (k, ...) ciphertext batch down to a single ct (log-tree of
        batched modular adds; no key switches)."""
        ev = self.ev
        while ct.c0.shape[0] > 1:
            m = ct.c0.shape[0]
            h = (m + 1) // 2
            lo = ct.with_data(ct.c0[:m // 2], ct.c1[:m // 2])
            hi = ct.with_data(ct.c0[h: h + m // 2], ct.c1[h: h + m // 2])
            merged = ev.add(lo, hi)
            if m % 2:
                merged = merged.with_data(
                    torch.cat([merged.c0, ct.c0[m // 2: h]]),
                    torch.cat([merged.c1, ct.c1[m // 2: h]]))
            ct = merged
        return ct.with_data(ct.c0[0], ct.c1[0])
