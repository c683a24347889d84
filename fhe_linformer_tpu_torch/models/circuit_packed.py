"""Block-major (matrix-packed) encrypted Linformer circuit.

Every tensor lives matrix-packed: one ciphertext carries nb = slots/d
tokens (slot[d*t + i] = X[t, i]).  Q/K/V/WO/FFN projections are single
BSGS block-matmuls on the double-hoisted rotation combo; the FFN's block
outputs are the GELU containers.  Sequences longer than nb run as chunks
of nb tokens, looped one chunk at a time through the attention, or, with
`batch_chunks=True`, as one (C, k, ...) batched score product and value
mix (the dp-sharded shape, `parallel/circuit_packed.py`).  With a
Bootstrapper (`boot=`), refreshes fire where the levels run short: mid-exp
in the attention, before the GELU, and at the pooler's entry (one
ciphertext per chunk each, so 3 per request at 128 tokens).

Layout contracts (d = 128, nb = slots/d):
  block-major  slot[d*t + i] = X[t, i]       (tokens t, dims i)
  row-repeated (k, ...) batch: element u tiles row u across all blocks
  scores       slot[d*t + u] = score[t, u], u < k_lin
"""

from __future__ import annotations

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext
from ..ckks.evaluator import Evaluator
from ..linalg.blockmat import BlockOps
from ..poly.gadgets import Gadgets, relu_degree_depth
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
    """`batch_chunks`: attention's per-chunk score and value-mix products
    as ONE (C, k, ...) batched op instead of a loop over chunks, bit-exact
    with the loop; it holds C * k_lin ciphertext intermediates at once."""

    def __init__(self, ev: Evaluator, w: LinformerWeights,
                 params: CircuitParams | None = None, d: int | None = None,
                 bs: int = 16, batch_chunks: bool = False,
                 chunk_tokens: int | None = None):
        self.ev = ev
        self.w = w
        self.p = params or CircuitParams()
        self.d = d or w.d
        self.bops = BlockOps(ev, self.d, bs=bs, chunk_tokens=chunk_tokens)
        self.ops = self.bops.ops
        self.g = Gadgets(ev)
        self.batch_chunks = batch_chunks

    # -- client-side input preparation ---------------------------------

    def encrypt_inputs(self, emb: np.ndarray, nl: int | None = None):
        """Token embeddings (S, d) -> (x, XE, XF) block-major ciphertexts at
        nl limbs (default: the whole chain).  x: (C, ...) chunks of <= nb
        tokens; XE/XF: single cts with k_lin valid token-blocks."""
        w, ev, bops = self.w, self.ev, self.bops
        x_in, X_E, X_F = client_preprocess(w, emb)
        return (ev.encrypt(bops.pack_chunks(x_in), batch=True, nl=nl),
                ev.encrypt(bops.pack(X_E), nl=nl),
                ev.encrypt(bops.pack(X_F), nl=nl), x_in.shape[0])

    # -- attention ------------------------------------------------------

    def attention(self, x_ct, xe_ct, xf_ct, S_total, boot=None):
        """Scores + poly-softmax + value mix + WO (+ residual), block-major
        in and out."""
        ev, bops, ops, w, p = self.ev, self.bops, self.ops, self.w, self.p
        d, k_lin = self.d, w.k_lin

        Q = bops.matmul(x_ct, w.WQ, "WQ", bias=w.BQ)       # (C, ...)
        K = bops.matmul(xe_ct, w.WK, "WK", bias=w.BK)
        V = bops.matmul(xf_ct, w.WV, "WV", bias=w.BV)
        K_rep = bops.rows_to_repeated(K, k_lin)            # (k, ...)
        V_rep = bops.rows_to_repeated(V, k_lin)

        C = x_ct.c0.shape[0]
        mval = p.r / 8.0 if p.exp_pow8 else p.r
        mask = ops.mask_mod_n(d, value=mval)
        if self.batch_chunks and C > 1:
            # one (C, k, ...) product, the chunk axis first
            prod = _mul_bc(ev, K_rep.with_data(K_rep.c0[None], K_rep.c1[None]),
                           Q.with_data(Q.c0[:, None], Q.c1[:, None]))
            sc = ops.rotsum(prod, d, 1)
            sc = ev.mul_plain(sc, ev.encode_cached(
                ("score_mask", d, mval), mask, nl=sc.nl))
            # interleave merges axis 0: the k axis first
            scores = ops.interleave_batch(sc.with_data(
                sc.c0.movedim(1, 0), sc.c1.movedim(1, 0)), stride=1)
            del Q, prod, sc
        else:
            scs = []
            for c in range(C):
                qc = Q.with_data(Q.c0[c], Q.c1[c])
                prod = ev.mul(K_rep, qc)                   # (k, ...)
                sc = ops.rotsum(prod, d, 1)                # dot at lane 0
                sc = ev.mul_plain(sc, ev.encode_cached(
                    ("score_mask", d, mval), mask, nl=sc.nl))
                scs.append(ops.interleave_batch(sc, stride=1))
            scores = _stack(scs)                           # (C, ...)
            del Q, prod, sc, scs

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
        attn = ev.mul(scores, inv)                         # (C, ...)
        del scores, inv, ssum

        # value mix: out[t, i] = sum_u attn[t, u] v[u, i]
        if self.batch_chunks and C > 1:
            a_sp = bops.lane_rows_to_blocks(attn, k_lin)   # (k, C, ...)
            mixed = bops.reduce_batch(_mul_bc(ev, a_sp, V_rep.with_data(
                V_rep.c0[:, None], V_rep.c1[:, None])))    # (C, ...)
            del attn, a_sp, V_rep, K_rep
        else:
            outs = []
            for c in range(C):
                ac = attn.with_data(attn.c0[c], attn.c1[c])
                a_sp = bops.lane_rows_to_blocks(ac, k_lin)  # (k, ...)
                outs.append(bops.reduce_batch(ev.mul(a_sp, V_rep)))
            mixed = _stack(outs)                           # (C, ...)
            del attn, outs, a_sp, V_rep, K_rep

        out = bops.matmul(mixed, w.WO, "WO", bias=w.BO)
        x_adj, out = ev.match(x_ct, out)
        return ev.add(x_adj, out)

    # -- affine norm ----------------------------------------------------

    def affine(self, ct: Ciphertext, a, b, c, S_total) -> Ciphertext:
        """x*(a*fL) + b*fL with a/b per dimension (lane-wise here)."""
        ev, bops = self.ev, self.bops
        fL = c[0] + c[1] / np.sqrt(S_total) + c[2] / S_total
        av = np.zeros(self.d)
        av[: len(a)] = a * fL
        bv = np.zeros(self.d)
        bv[: len(b)] = b * fL
        out = ev.mul_plain(ct, ev.encode(np.tile(av, bops.nb), nl=ct.nl))
        b_pt = ev.encode(np.tile(bv, bops.nb), nl=out.nl, scale=out.scale)
        return ev.add_plain(out, b_pt)

    # -- FFN -------------------------------------------------------------

    def ffn(self, x_ct: Ciphertext, boot=None) -> Ciphertext:
        """d -> d_ffn (nblk block-matmuls) -> GELU -> d (block-matmul sum).
        The nblk up-projection outputs are the GELU containers: one batched
        Chebyshev serves all S x d_ffn activations.  `boot` refreshes the
        input when the GELU's depth would not fit, so the same batch is
        refreshed once before the up-projection."""
        ev, bops, w, p = self.ev, self.bops, self.w, self.p
        d = self.d
        nblk = w.W1.shape[0] // d
        if boot is not None and \
                x_ct.nl - 1 < relu_degree_depth(p.gelu_degree) + 3:
            x_ct = boot.refresh(x_ct)
        ups = [bops.matmul(x_ct, w.W1[k * d:(k + 1) * d], f"W1_{k}",
                           bias=w.B1[k * d:(k + 1) * d], w_scale=p.gelu_clip)
               for k in range(nblk)]
        h = _stack(ups)                       # (nblk, C, ...) block-major
        h = self.g.eval_gelu(h, -1.0, 1.0, mult=p.gelu_clip,
                             degree=p.gelu_degree)
        if boot is not None and h.nl < 4:
            h = boot.refresh(h)             # backstop (normally skipped)
        acc = None
        for k in range(nblk):
            hb = h.with_data(h.c0[k], h.c1[k])
            t = bops.matmul(hb, w.W2[:, k * d:(k + 1) * d], f"W2_{k}")
            acc = t if acc is None else ev.add(acc, t)
        b2 = np.zeros(self.d)
        b2[: len(w.B2)] = w.B2
        pt = ev.encode(np.tile(b2, bops.nb), nl=acc.nl, scale=acc.scale)
        return ev.add_plain(acc, pt)

    # -- pooler + classifier ---------------------------------------------

    def pooler_classifier(self, x_ct: Ciphertext, boot=None) -> Ciphertext:
        """tanh pooler on CLS + linear head.  CLS is block 0 of chunk 0;
        the head returns logits at slots [0, n_cls).  `boot` refreshes at
        the entry (the extract/pool/tanh/classify chain needs ~16 levels)
        and before the tanh when its depth would not fit."""
        ev, ops, w, p = self.ev, self.ops, self.w, self.p
        d, nb = self.d, self.bops.nb
        c0 = x_ct
        if c0.c0.dim() > 2:
            c0 = c0.with_data(c0.c0[0], c0.c1[0])
        if boot is not None and c0.nl < 5:
            c0 = boot.refresh(c0)
        pt_b0 = ev.encode_cached(("mask_block0", d), ops.mask_block(0),
                                 nl=c0.nl)
        cls_rep = ops.repeat(ev.mul_plain(c0, pt_b0), nb, d)  # cls tiled
        # pooled[j] at slot d*j: CR-layout Wp multiply + lane rotsum
        wp = np.zeros((nb, d))
        wp[: w.Wp.shape[0], : w.Wp.shape[1]] = w.Wp * p.tanh_scale
        pooled = ev.mul_plain(cls_rep, ev.encode_cached(
            ("Wp_cr", p.tanh_scale), wp.reshape(-1), nl=cls_rep.nl))
        pooled = ops.rotsum(pooled, d, 1)
        bp = np.repeat(np.pad(w.bp * p.tanh_scale, (0, nb - len(w.bp))), d)
        pooled = ev.add_plain(pooled, ev.encode(bp, nl=pooled.nl,
                                                scale=pooled.scale))
        if boot is not None and \
                pooled.nl - 1 < relu_degree_depth(p.tanh_degree) + 4:
            pooled = boot.refresh(pooled)
        pooled = self.g.eval_tanh(pooled, -1.0, 1.0, mult=p.tanh_scale,
                                  degree=p.tanh_degree)
        # clean to expanded (t[j] fills block j), then RE-style classifier
        ptm = ev.encode_cached(("mask_mod_n", d, 0), ops.mask_mod_n(d),
                               nl=pooled.nl)
        t_exp = ops.repeat(ev.mul_plain(pooled, ptm), d, 1)
        wc = ops.matrix_re_slots(w.Wc)        # slot[d*j + i] = Wc[i, j]
        out = ev.mul_plain(t_exp, ev.encode_cached(("Wc_re",), wc,
                                                   nl=t_exp.nl))
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
