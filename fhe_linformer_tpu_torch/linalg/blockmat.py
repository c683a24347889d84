"""Block-major matrix packing: one ciphertext holds a whole token matrix,
slot[d*t + i] = X[t, i], for nb = slots/d tokens per ciphertext (128 tokens
of d = 128 dims at 16384 slots).  A model wider than the d-lane block is
held as feature blocks: feature f of token t sits at slot d*t + f % d of
block f // d, the blocks on a batch axis just before (nl, N) that is there
only when there is more than one block.

A dense d x d projection y[t, :] = W @ x[t, :] for all nb tokens at once is
a BSGS diagonal transform with 2d masked diagonals: each block-local
diagonal u splits into a rotate-by-u part and a rotate-by-(u-d) wrap part,
riding the double-hoisted rotation combo.  A wider matrix is a grid of such
blocks: output block j sums the products W[j, i] x_i over the input blocks
i, and each input block's decomposition and baby rotations (the combo's
stage 1) are computed once and shared by every output block.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext, Plaintext
from ..ckks.evaluator import Evaluator
from ..utils.timing import GLOBAL_TIMERS
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
        # (name, w_scale) -> (output blocks, input blocks, {(j, i): giant
        # groups of W[j, i]'s coefficient plaintexts})
        self._grid_cache: dict = {}

    def required_baby_rotations(self) -> tuple[int, ...]:
        """The non-pow2 shifts block matmuls need as dedicated keys (BSGS
        babies must be single automorphisms for hoisting)."""
        return tuple(j for j in range(1, self.bs) if j & (j - 1) != 0)

    def blocks(self, width: int) -> int:
        """Feature blocks of d lanes that hold `width` features."""
        return -(-width // self.d)

    # -- host packing ----------------------------------------------------

    def pack(self, X: np.ndarray) -> np.ndarray:
        """(T, width) token matrix -> slot vector, T <= nb; (blocks, slots)
        when width > d."""
        X = np.asarray(X)
        nblk = self.blocks(X.shape[1])
        full = np.zeros((self.nb, nblk * self.d))
        full[: X.shape[0], : X.shape[1]] = X
        out = full.reshape(self.nb, nblk, self.d).transpose(1, 0, 2) \
            .reshape(nblk, self.slots)
        return out[0] if nblk == 1 else out

    def pack_chunks(self, X: np.ndarray) -> np.ndarray:
        """(S, width) -> (ceil(S/chunk_tokens), [blocks,] slots) chunked
        block-major slots."""
        step = self.chunk_tokens
        C = -(-X.shape[0] // step)
        return np.stack([self.pack(X[c * step: (c + 1) * step])
                         for c in range(C)])

    def unpack_chunks(self, slots: np.ndarray, S: int) -> np.ndarray:
        """(C, [blocks,] slots) -> (S, width): inverse of pack_chunks."""
        step = self.chunk_tokens
        rows = [self.unpack(s, min(step, S - c * step))
                for c, s in enumerate(np.asarray(slots))]
        return np.concatenate(rows, 0)

    def unpack(self, slots: np.ndarray, T: int) -> np.ndarray:
        """Inverse of pack."""
        blk = np.asarray(slots).reshape(-1, self.nb, self.d)[:, :T]
        return blk.transpose(1, 0, 2).reshape(T, -1)

    def lanes(self, v: np.ndarray) -> np.ndarray:
        """A per-feature vector tiled over every token block: slot
        d*t + f % d of block f // d holds v[f]."""
        v = np.asarray(v)
        nblk = self.blocks(len(v))
        full = np.zeros(nblk * self.d)
        full[: len(v)] = v
        out = np.tile(full.reshape(nblk, 1, self.d), (1, self.nb, 1)) \
            .reshape(nblk, self.slots)
        return out[0] if nblk == 1 else out

    def encode_lanes(self, v, nl: int, scale: float | None = None,
                     key=None) -> Plaintext:
        """lanes(v) encoded at (nl, scale), a batch over the blocks;
        memoized under `key` when one is given."""
        vals = self.lanes(v)
        batch = vals.ndim > 1
        if key is None:
            return self.ev.encode(vals, nl=nl, scale=scale, batch=batch)
        return self.ev.encode_cached(key, vals, nl=nl, scale=scale,
                                     batch=batch)

    # -- the block axis ----------------------------------------------------

    @staticmethod
    def slices(ct: Ciphertext) -> list[Ciphertext]:
        """ct's slices along the batch axis -3."""
        return [ct.with_data(ct.c0[..., i, :, :], ct.c1[..., i, :, :])
                for i in range(ct.c0.shape[-3])]

    def split(self, ct: Ciphertext, n: int) -> list[Ciphertext]:
        """The n blocks of ct: [ct] for one block, else its slices along
        the block axis."""
        if n == 1:
            return [ct]
        assert ct.c0.shape[-3] == n, (ct.c0.shape, n)
        return self.slices(ct)

    @staticmethod
    def stack(cts: list[Ciphertext]) -> Ciphertext:
        """cts stacked on a new batch axis -3: inverse of slices."""
        return cts[0].with_data(torch.stack([c.c0 for c in cts], -3),
                                torch.stack([c.c1 for c in cts], -3))

    def join(self, cts: list[Ciphertext]) -> Ciphertext:
        """Inverse of split."""
        return cts[0] if len(cts) == 1 else self.stack(cts)

    def sum_axis(self, ct: Ciphertext) -> Ciphertext:
        """Sum over the batch axis -3 (dropped)."""
        acc = None
        for t in self.slices(ct):
            acc = t if acc is None else self.ev.add(acc, t)
        return acc

    # -- the block-grid matmul ---------------------------------------------

    def block_diags(self, W: np.ndarray) -> dict:
        """Diagonal set for y[t, j] = sum_i W[j, i] x[t, i] applied to every
        block t, W at most d x d, each diagonal as the d-lane pattern that
        every block repeats.  Diagonal u contributes W[j, j+u] at output
        slot d*t + j; lanes that would read past the block boundary move to
        the wrap diagonal at global offset (u - d) mod slots."""
        d = self.d
        W = np.asarray(W, float)
        dj, di = W.shape
        assert dj <= d and di <= d
        Wp = np.zeros((d, d))
        Wp[:dj, :di] = W
        j = np.arange(d)
        diags: dict[int, np.ndarray] = {}
        for u in range(d):
            vals = Wp[j, (j + u) % d]
            main = np.where(j + u < d, vals, 0.0)
            wrap = np.where(j + u >= d, vals, 0.0)
            if np.any(main):
                diags[u] = main
            if u and np.any(wrap):
                diags[(u - d) % self.slots] = wrap
        return diags

    def _grid(self, W, w_scale: float, key):
        """(output blocks, input blocks, {(j, i): giant groups}) of
        w_scale * W: each nonzero d x d block's diagonals as level-independent
        coefficient plaintexts at the working scale, grouped by giant step
        for the rotation combo (PackedOps.combo_groups).  Cached per
        (key, w_scale); the diagonals themselves are not kept: a block's
        are tiled over the slots on the device and transformed there in
        one batch."""
        k = (key, w_scale)
        if k in self._grid_cache:
            return self._grid_cache[k]
        d, bs = self.d, self.bs
        W = np.asarray(W) * w_scale
        nO, nI = self.blocks(W.shape[0]), self.blocks(W.shape[1])
        grid = {}
        for j in range(nO):
            for i in range(nI):
                diags = self.block_diags(W[j * d:(j + 1) * d,
                                           i * d:(i + 1) * d])
                if not diags:
                    continue
                stride, by_giant = self.ops.by_giant(diags, bs)
                grid[j, i] = self.ops.combo_plaintexts(by_giant, bs, stride,
                                                       tile=self.nb)
        self._grid_cache[k] = (nO, nI, grid)
        return nO, nI, grid

    def matmul(self, ct: Ciphertext, W: np.ndarray, key,
               bias: np.ndarray | None = None,
               w_scale: float = 1.0) -> Ciphertext:
        """Block-major y = X @ (w_scale*W)^T (+ bias per output lane), all
        nb tokens per ct and any leading chunk dims at once.  W (out, in)
        is a grid of d x d blocks: ct carries the input blocks, the result
        the output blocks (each axis there only for more than one block).
        Each block product is rescaled, then summed over the input blocks;
        `block_matmul` counts the block products by ciphertext."""
        ev, ops = self.ev, self.ops
        nO, nI, grid = self._grid(W, w_scale, key)
        outs: list = [None] * nO
        for i, x in enumerate(self.split(ct, nI)):
            rows = [(j, grid[j, i]) for j in range(nO) if (j, i) in grid]
            babies = ops.combo_babies([g for _, g in rows])
            stage1 = ops.combo_stage1(x, babies)
            GLOBAL_TIMERS.count("block_matmul", len(rows) * int(
                np.prod(x.c0.shape[:-2], dtype=np.int64)))
            for j, groups in rows:
                y = ev.rescale(ops.combo_groups(x, stage1, groups, babies))
                outs[j] = y if outs[j] is None else ev.add(outs[j], y)
            del stage1
        assert all(o is not None for o in outs), f"{key}: a zero block row"
        out = self.join(outs)
        if bias is not None:
            pt = self.encode_lanes(np.asarray(bias) * w_scale, out.nl,
                                   out.scale, key=(key, "bias", w_scale))
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
        """ct (..., h, nl, N) of h heads, each with values at lane u of
        each block (u < k) -> (k, ...) batch where element u fills head a's
        d/h lanes of each block (lanes a*d/h onwards) with head a's lane-u
        value: head a moves to lane a*d/h first, then every head is masked
        to its lane and repeated over its lanes."""
        ev, ops = self.ev, self.ops
        h = ct.c0.shape[-3]
        width = self.d // h
        if h > 1:
            ct = self.stack([ev.rotate_any(t, -a * width) if a else t
                             for a, t in enumerate(self.slices(ct))])
        batch = ops.deinterleave_batch(ct, k, stride=1)
        acc = None
        for a, t in enumerate(self.slices(batch)):
            pt = ev.encode_cached(("mask_mod_n", self.d, a * width),
                                  ops.mask_mod_n(self.d, offset=a * width),
                                  nl=batch.nl)
            t = ev.mul_plain(t, pt)
            acc = t if acc is None else ev.add(acc, t)
        return ops.repeat(acc, width, 1)

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
