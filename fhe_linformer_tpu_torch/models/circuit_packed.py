"""Block-major (matrix-packed) encrypted Linformer circuit.

Every tensor lives matrix-packed: one ciphertext carries nb = slots/d
tokens of one d-lane feature block (slot[d*t + i] = X[t, i]); a model
wider than d (d_model = nblk * d) holds each tensor as nblk feature blocks
on a batch axis just before (nl, N) (BlockOps).  Q/K/V/WO/FFN projections
are block-grid BSGS matmuls on the double-hoisted rotation combo; the FFN's
up-projection output blocks are the GELU containers.  Several heads split
each feature block into d/head_dim lane groups: a head's scores, softmax
and value mix run on their own batch element.  Sequences longer than nb
run as chunks of nb tokens, looped one chunk at a time through the
attention, or, with `batch_chunks=True`, as one (C, k, ...) batched score
product and value mix (the dp-sharded shape, `parallel/circuit_packed.py`).
With a Bootstrapper (`boot=`), refreshes fire where the levels run short:
mid-exp in the attention, before the GELU, and at the pooler's entry.

Layout contracts (d the block width, nb = slots/d, [b] the block axis
when nblk > 1, h = d / head_dim heads per block):
  block-major  slot[d*t + i] of block b = X[t, d*b + i]
  row-repeated (k, [b], ...) batch: element u tiles row u across all blocks
  scores       (..., [b], h) batch: slot[d*t + u] = score of head h*b + a
               for query t and key u, u < k_lin
"""

from __future__ import annotations

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext, Plaintext
from ..ckks.evaluator import Evaluator
from ..linalg.blockmat import BlockOps
from ..poly.gadgets import Gadgets, relu_degree_depth
from ..utils.timing import GLOBAL_TIMERS
from .circuit import CircuitParams, _stack
from .golden import LinformerWeights, client_preprocess


def _mul_bc(ev: Evaluator, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """ct x ct with batch broadcasting: levels aligned, then both operands
    expanded to the common batch shape (so the op counts are the
    broadcast batch's, as in the JAX package)."""
    nl = min(a.nl, b.nl)
    a, b = ev.drop_to(a, nl), ev.drop_to(b, nl)
    shape = torch.broadcast_shapes(a.c0.shape, b.c0.shape)
    a = a.with_data(a.c0.expand(shape), a.c1.expand(shape))
    b = b.with_data(b.c0.expand(shape), b.c1.expand(shape))
    return ev.mul(a, b)


class PackedLinformer:
    """`heads`: attention heads of d_model / heads features, which must
    divide the block width.  `block`: the lane width of a feature block
    (d_model when smaller).  `batch_chunks`: attention's per-chunk score
    and value-mix products as ONE (C, k, ...) batched op instead of a loop
    over chunks, bit-exact with the loop; it holds C * k_lin ciphertext
    intermediates at once."""

    def __init__(self, ev: Evaluator, w: LinformerWeights,
                 params: CircuitParams | None = None, d: int | None = None,
                 bs: int = 16, batch_chunks: bool = False,
                 chunk_tokens: int | None = None, heads: int = 1,
                 block: int = 128):
        self.ev = ev
        self.w = w
        self.p = params or CircuitParams()
        self.d = d or w.d
        self.block = min(block, self.d)
        self.nblk = self.d // self.block
        self.head_dim = self.d // heads
        assert self.nblk * self.block == self.d and \
            self.block % self.head_dim == 0, (self.d, self.block, heads)
        self.bops = BlockOps(ev, self.block, bs=bs, chunk_tokens=chunk_tokens)
        self.ops = self.bops.ops
        assert w.k_lin <= min(self.block, self.bops.nb), w.k_lin
        self.g = Gadgets(ev)
        self.batch_chunks = batch_chunks

    # -- client-side input preparation ---------------------------------

    def encrypt_inputs(self, emb: np.ndarray, nl: int | None = None):
        """Token embeddings (S, d_model) -> (x, XE, XF) block-major
        ciphertexts at nl limbs (default: the whole chain), and S + 1.
        x: (C, [blocks,] ...) chunks of <= nb tokens; XE/XF: ([blocks,]
        ...) with k_lin valid token rows."""
        w, ev, bops = self.w, self.ev, self.bops
        x_in, X_E, X_F = client_preprocess(w, emb)
        xs = bops.pack_chunks(x_in)
        x = ev.encrypt(xs.reshape(-1, xs.shape[-1]), batch=True, nl=nl)
        x = x.with_data(x.c0.reshape(xs.shape[:-1] + x.c0.shape[-2:]),
                        x.c1.reshape(xs.shape[:-1] + x.c1.shape[-2:]))
        many = self.nblk > 1
        return (x, ev.encrypt(bops.pack(X_E), nl=nl, batch=many),
                ev.encrypt(bops.pack(X_F), nl=nl, batch=many),
                x_in.shape[0])

    # -- attention ------------------------------------------------------

    def _scores(self, K_rep: Ciphertext, q: Ciphertext, mval: float,
                batched: bool) -> Ciphertext:
        """Masked head scores from one ct x ct product: K_rep (k, [b], ...)
        times the broadcast queries (`batched`: (1, k, ...) times (C, 1,
        ...)), summed over each head's lanes (lane a*head_dim of a block
        holds head a's dot), one batch element per head (a new axis -3,
        scaled by mval), the k axis interleaved to lanes and each head
        moved to lane 0."""
        ev, ops, bops, hd = self.ev, self.ops, self.bops, self.head_dim
        d = self.block
        prod = _mul_bc(ev, K_rep, q) if batched else ev.mul(K_rep, q)
        sc = ops.rotsum(prod, hd, 1)                       # dot at lane a*hd
        del prod
        sc = bops.stack([ev.mul_plain(sc, ev.encode_cached(
            ("score_mask", d, mval, a * hd),
            ops.mask_mod_n(d, value=mval, offset=a * hd), nl=sc.nl))
            for a in range(d // hd)])
        if batched:                                        # k axis first
            sc = sc.with_data(sc.c0.movedim(1, 0), sc.c1.movedim(1, 0))
        s = ops.interleave_batch(sc, stride=1)             # head a at lanes
        return bops.stack([ev.rotate_any(t, a * hd) if a else t  # a*hd + u
                           for a, t in enumerate(bops.slices(s))])

    def attention(self, x_ct, xe_ct, xf_ct, S_total, boot=None):
        """Scores + poly-softmax + value mix + WO (+ residual), block-major
        in and out."""
        ev, bops, ops, w, p = self.ev, self.bops, self.ops, self.w, self.p
        d, k_lin = self.block, w.k_lin

        Q = bops.matmul(x_ct, w.WQ, "WQ", bias=w.BQ)       # (C, [b], ...)
        K = bops.matmul(xe_ct, w.WK, "WK", bias=w.BK)      # ([b], ...)
        V = bops.matmul(xf_ct, w.WV, "WV", bias=w.BV)
        K_rep = bops.rows_to_repeated(K, k_lin)            # (k, [b], ...)
        V_rep = bops.rows_to_repeated(V, k_lin)

        C = x_ct.c0.shape[0]
        mval = p.r / 8.0 if p.exp_pow8 else p.r
        with GLOBAL_TIMERS.time("head_scores"):
            if self.batch_chunks and C > 1:
                # one (C, k, ...) product, the chunk axis first
                scores = self._scores(
                    K_rep.with_data(K_rep.c0[None], K_rep.c1[None]),
                    Q.with_data(Q.c0[:, None], Q.c1[:, None]), mval, True)
            else:
                scores = _stack([self._scores(K_rep, Q.with_data(
                    Q.c0[c], Q.c1[c]), mval, False) for c in range(C)])
            del Q                                  # (C, [b], h, ...)

        # depth after the Taylor: power raise (3 when pow8) + inverse +
        # the mix/WO/affine tail (~7): the mid-exp refresh's threshold
        need = (3 if p.exp_pow8 else 0) + \
            relu_degree_depth(p.inv_degree) + 7
        scores = self.g.eval_exp(scores, pow8=p.exp_pow8, boot=boot,
                                 boot_below=need)
        kp = 1 << (k_lin - 1).bit_length()
        if kp != k_lin:
            # non-pow2 k_lin: exp(0)=1 in the padding lanes would pollute
            # the row sums below
            scores = ev.mul_plain(scores, ev.encode_cached(
                ("mask_heads", d, k_lin), ops.mask_heads(k_lin),
                nl=scores.nl))
        ssum = ops.rotsum(scores, kp, 1)                   # lane 0 = row sum
        pt0 = ev.encode_cached(("mask_mod_n", d, 0), ops.mask_mod_n(d),
                               nl=ssum.nl)
        ssum = ops.repeat(ev.mul_plain(ssum, pt0), kp, 1)  # lanes < kp
        inv = self.g.eval_inverse(ssum, *p.inv_range, degree=p.inv_degree)
        attn = ev.mul(scores, inv)                         # (C, [b], h, ...)
        del scores, inv, ssum

        # value mix: out[t, i] = sum_u attn_head(i)[t, u] v[u, i]
        with GLOBAL_TIMERS.time("head_mix"):
            if self.batch_chunks and C > 1:
                a_sp = bops.lane_rows_to_blocks(attn, k_lin)  # (k, C, ...)
                mixed = bops.reduce_batch(_mul_bc(ev, a_sp, V_rep.with_data(
                    V_rep.c0[:, None], V_rep.c1[:, None])))   # (C, [b], ...)
                del a_sp
            else:
                outs = []
                for c in range(C):
                    a_sp = bops.lane_rows_to_blocks(
                        attn.with_data(attn.c0[c], attn.c1[c]), k_lin)
                    outs.append(bops.reduce_batch(ev.mul(a_sp, V_rep)))
                    del a_sp
                mixed = _stack(outs)                       # (C, [b], ...)
                del outs
            del attn, V_rep, K_rep

        out = bops.matmul(mixed, w.WO, "WO", bias=w.BO)
        x_adj, out = ev.match(x_ct, out)
        return ev.add(x_adj, out)

    # -- affine norm ----------------------------------------------------

    def affine(self, ct: Ciphertext, a, b, c, S_total) -> Ciphertext:
        """x*(a*fL) + b*fL with a/b per dimension (lane-wise here)."""
        ev, bops = self.ev, self.bops
        fL = c[0] + c[1] / np.sqrt(S_total) + c[2] / S_total
        out = ev.mul_plain(ct, bops.encode_lanes(np.asarray(a) * fL, ct.nl))
        return ev.add_plain(out, bops.encode_lanes(np.asarray(b) * fL,
                                                   out.nl, out.scale))

    # -- FFN -------------------------------------------------------------

    def ffn(self, x_ct: Ciphertext, boot=None) -> Ciphertext:
        """d_model -> d_ffn (a block-grid matmul) -> GELU -> d_model.  The
        up-projection's output blocks are the GELU containers: one batched
        Chebyshev serves all S x d_ffn activations.  `boot` refreshes the
        input when the GELU's depth would not fit, so the same batch is
        refreshed once before the up-projection."""
        ev, bops, w, p = self.ev, self.bops, self.w, self.p
        if boot is not None and \
                x_ct.nl - 1 < relu_degree_depth(p.gelu_degree) + 3:
            x_ct = boot.refresh(x_ct)
        h = bops.matmul(x_ct, w.W1, "W1", bias=w.B1,
                        w_scale=p.gelu_clip)           # (C, ffn blocks, ...)
        h = self.g.eval_gelu(h, -1.0, 1.0, mult=p.gelu_clip,
                             degree=p.gelu_degree)
        if boot is not None and h.nl < 4:
            h = boot.refresh(h)             # backstop (normally skipped)
        acc = bops.matmul(h, w.W2, "W2")
        return ev.add_plain(acc, bops.encode_lanes(w.B2, acc.nl, acc.scale))

    # -- pooler + classifier ---------------------------------------------

    def _grid_slots(self, W: np.ndarray, layout) -> np.ndarray:
        """`layout` (one d x d block -> slots) of each d x d block of W:
        the slots of one block, else (W's row blocks, column blocks,
        slots)."""
        d = self.block
        nO, nI = self.bops.blocks(W.shape[0]), self.bops.blocks(W.shape[1])
        if nO * nI == 1:
            return layout(W)
        Wp = np.zeros((nO * d, nI * d))
        Wp[: W.shape[0], : W.shape[1]] = W
        return np.stack([[layout(Wp[j * d:(j + 1) * d, i * d:(i + 1) * d])
                          for i in range(nI)] for j in range(nO)])

    def _encode_grid(self, key, vals: np.ndarray, nl: int) -> Plaintext:
        """encode_cached of one slot vector, or of a (..., slots) stack of
        them as a (..., nl, N) batch."""
        ev = self.ev
        if vals.ndim == 1:
            return ev.encode_cached(key, vals, nl=nl)
        pt = ev.encode_cached(key, vals.reshape(-1, vals.shape[-1]), nl=nl,
                              batch=True)
        return Plaintext(pt.data.reshape(vals.shape[:-1] +
                                         pt.data.shape[-2:]), pt.nl, pt.scale)

    def _sum_rescale(self, ct: Ciphertext) -> Ciphertext:
        """Sum the unrescaled products over the input feature blocks (the
        axis -3 when there are several), then rescale."""
        if self.nblk > 1:
            ct = self.bops.sum_axis(ct)
        return self.ev.rescale(ct)

    def pooler_classifier(self, x_ct: Ciphertext, boot=None) -> Ciphertext:
        """tanh pooler on CLS + linear head.  CLS is token 0 of chunk 0;
        the head returns logits at slots [0, n_cls).  `boot` refreshes at
        the entry (the extract/pool/tanh/classify chain needs ~16 levels)
        and before the tanh when its depth would not fit."""
        ev, ops, bops, w, p = self.ev, self.ops, self.bops, self.w, self.p
        d, nb, many = self.block, bops.nb, self.nblk > 1
        c0 = x_ct
        if c0.c0.dim() > 2 + many:                     # the chunk axis
            c0 = c0.with_data(c0.c0[0], c0.c1[0])
        if boot is not None and c0.nl < 5:
            c0 = boot.refresh(c0)
        pt_b0 = ev.encode_cached(("mask_block0", d), ops.mask_block(0),
                                 nl=c0.nl)
        cls_rep = ops.repeat(ev.mul_plain(c0, pt_b0), nb, d)  # cls tiled
        # pooled[j] at slot d*j of output block j // d: CR-layout Wp
        # multiplies, summed over the input blocks, + lane rotsum

        def cr(W):
            wp = np.zeros((nb, d))
            wp[: W.shape[0], : W.shape[1]] = W
            return wp.reshape(-1)
        wp = self._grid_slots(w.Wp * p.tanh_scale, cr)
        pooled = self._sum_rescale(ev.mul_plain(cls_rep, self._encode_grid(
            ("Wp_cr", p.tanh_scale), wp, cls_rep.nl), rescale=False))
        pooled = ops.rotsum(pooled, d, 1)
        bp = np.pad(w.bp * p.tanh_scale, (0, self.nblk * d - len(w.bp)))
        bp = np.stack([np.repeat(np.pad(v, (0, nb - d)), d)
                       for v in bp.reshape(self.nblk, d)])
        pooled = ev.add_plain(pooled, ev.encode(
            bp if many else bp[0], nl=pooled.nl, scale=pooled.scale,
            batch=many))
        if boot is not None and \
                pooled.nl - 1 < relu_degree_depth(p.tanh_degree) + 4:
            pooled = boot.refresh(pooled)
        pooled = self.g.eval_tanh(pooled, -1.0, 1.0, mult=p.tanh_scale,
                                  degree=p.tanh_degree)
        # clean to expanded (t[j] fills block j), then RE-style classifier
        ptm = ev.encode_cached(("mask_mod_n", d, 0), ops.mask_mod_n(d),
                               nl=pooled.nl)
        t_exp = ops.repeat(ev.mul_plain(pooled, ptm), d, 1)
        # slot[d*j + i] = Wc[i, j] of each column block
        wc = self._grid_slots(w.Wc, ops.matrix_re_slots)
        wc = wc[0] if many else wc
        out = self._sum_rescale(ev.mul_plain(t_exp, self._encode_grid(
            ("Wc_re",), wc, t_exp.nl), rescale=False))
        out = ops.rotsum(out, nb, d)          # lane c = logit[c] (repeated)
        ncls = w.Wc.shape[0]
        bias = np.zeros(ev.ctx.cfg.slots)
        bias[:ncls] = w.bc
        out = ev.add_plain(out, ev.encode(bias, nl=out.nl, scale=out.scale))
        return ev.mul_plain(out, ev.encode_cached(
            ("mask_first", ncls), ops.mask_first_n(ncls), nl=out.nl))

    # -- layer / forward -------------------------------------------------

    def encoder_layer(self, x_ct, xe, xf, S_total, boot=None):
        w = self.w
        attn = self.attention(x_ct, xe, xf, S_total, boot=boot)
        attn = self.affine(attn, w.a1, w.b1, w.c1, S_total)
        y = self.ffn(attn, boot=boot)
        x2m, ym = self.ev.match(attn, y)
        return self.affine(self.ev.add(x2m, ym), w.a2, w.b2, w.c2, S_total)

    def forward(self, emb: np.ndarray, boot=None,
                input_nl: int | None = None) -> Ciphertext:
        """Encrypt the embeddings at input_nl limbs, run the layer and the
        pooler/classifier, refreshing through `boot` where needed."""
        x_ct, xe, xf, S_total = self.encrypt_inputs(emb, nl=input_nl)
        x = self.encoder_layer(x_ct, xe, xf, S_total, boot=boot)
        return self.pooler_classifier(x, boot=boot)

    def decrypt_logits(self, out: Ciphertext) -> np.ndarray:
        vals = np.real(np.asarray(self.ev.decrypt(out)))
        return vals[: self.w.Wc.shape[0]]
