"""The per-token encrypted Linformer circuit (the JAX package's
`models/circuit.py`).

Each token is one ciphertext in expanded layout (lane 0 of block j holds
dimension j); the tokens ride a leading batch axis, so a matmul, the exp,
the GELU or a rotation processes all of them in one batched op.  Rows are
wrapped into single ciphertexts and back by batched log-tree interleaves
(`PackedOps.interleave_batch` / `deinterleave_batch`).  Levels and scales
are tracked by the evaluator; weights encode at the level that consumes
them and stay cached per (weights, name, level).

The affine norm multiplies a/b in expanded layout (per dimension), as the
golden model computes it.  Layers after the first run the Linformer E/F
sequence compression homomorphically (`ef_project`).
"""

from __future__ import annotations

import gc
from dataclasses import dataclass

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext, Plaintext
from ..ckks.evaluator import Evaluator
from ..linalg.packed import PackedOps
from ..poly.gadgets import Gadgets, relu_degree_depth
from .golden import LinformerWeights, client_preprocess


@dataclass
class CircuitParams:
    """Approximation knobs."""
    r: float = 1.0 / 8.0                  # softmax temperature
    inv_range: tuple = (-1.0, 190000.0)   # eval_inverse interval
    inv_degree: int = 119
    gelu_clip: float = 1.0 / 8.0          # GELU input pre-scale
    gelu_degree: int = 119
    tanh_scale: float = 1.0 / 18.0
    tanh_degree: int = 300
    exp_pow8: bool = True                 # Taylor(s/64)^8 vs Taylor(s/8)


class EncryptedLinformer:
    def __init__(self, ev: Evaluator, w: LinformerWeights,
                 params: CircuitParams | None = None, d: int | None = None):
        self.ev = ev
        self.w = w
        self.p = params or CircuitParams()
        self.d = d or w.d
        self.ops = PackedOps(ev, self.d)
        self.g = Gadgets(ev)
        self._pt_cache: dict = {}

    def _pt(self, name: str, slots: np.ndarray, nl: int,
            scale: float | None = None) -> Plaintext:
        """Weight plaintexts, cached per (weights, name, nl, scale).  The
        key names the layer's weights: two layers' FFNs start from the same
        refresh, so (name, nl) alone would hand one layer the other's
        plaintexts.  Each entry holds its weights, so their id stays
        theirs while the entry lives."""
        key = (id(self.w), name, nl, scale)
        if key not in self._pt_cache:
            self._pt_cache[key] = (self.w, self.ev.encode(slots, nl=nl,
                                                          scale=scale))
        return self._pt_cache[key][1]

    # -- client-side input preparation ---------------------------------

    def encrypt_inputs(self, emb: np.ndarray, nl: int | None = None):
        """Token embeddings (S, d) -> encrypted (x, XE, XF) batches in
        expanded layout at nl limbs (default: the whole chain), and S."""
        w, ops, ev = self.w, self.ops, self.ev
        x_in, X_E, X_F = client_preprocess(w, emb)
        xs, es, fs = (np.stack([ops.expanded_slots(row) for row in X])
                      for X in (x_in, X_E, X_F))
        return (ev.encrypt(xs, batch=True, nl=nl),
                ev.encrypt(es, batch=True, nl=nl),
                ev.encrypt(fs, batch=True, nl=nl), x_in.shape[0])

    # -- circuit stages -------------------------------------------------

    def _matmul_re_w(self, cts: Ciphertext, W: np.ndarray, b: np.ndarray,
                     name: str, w_scale: float = 1.0) -> Ciphertext:
        """expanded x -> repeated W x + b (both scaled by w_scale)."""
        ops = self.ops
        w_pt = self._pt(name, ops.matrix_re_slots(W * w_scale), cts.nl)
        return ops.matmul_re(cts, w_pt, None if b is None
                             else ops.repeated_slots(b * w_scale))

    def attention(self, x_cts, xe_cts, xf_cts, S_total, cls_only=False,
                  boot=None):
        """Scores + poly-softmax + value mix + output projection (+ the
        residual).  Returns per-token expanded-dirty cts (lane 0 of block j
        = dim j).  `boot` refreshes mid-exp when the levels left after the
        Taylor would not carry the rest of the attention."""
        ev, ops, w, p = self.ev, self.ops, self.w, self.p
        d, nb = ops.d, ops.nb

        Q = self._matmul_re_w(x_cts, w.WQ, w.BQ, "WQ")         # (S,) repeated
        K = self._matmul_re_w(xe_cts, w.WK, w.BK, "WK")        # (k,) repeated
        V = self._matmul_re_w(xf_cts, w.WV, w.BV, "WV")
        K_w = self._wrap_rows(K)              # block j = row j
        V_w = self._wrap_rows(V)

        # scores per query chunk of <= d lanes
        m = 1 if cls_only else min(d, S_total)
        nchunk = 1 if cls_only else -(-S_total // m)
        Sq = 1 if cls_only else S_total
        Qb = Q.with_data(Q.c0[:Sq], Q.c1[:Sq])
        mval = p.r / 8.0 if p.exp_pow8 else p.r
        chunks = []
        for c in range(nchunk):
            qc = Qb.with_data(Qb.c0[c * m:(c + 1) * m],
                              Qb.c1[c * m:(c + 1) * m])
            sc = ops.rotsum(ev.mul(qc, K_w), d, 1)   # dot at lane 0 per block
            sc = ev.mul_plain(sc, ev.encode_cached(
                ("score_mask", d, mval), ops.mask_mod_n(d, value=mval),
                nl=sc.nl))
            chunks.append(ops.interleave_batch(sc, stride=1))  # lanes = queries
        scores = _stack(chunks)                      # (nchunk, ...)
        del Q, Qb, chunks, qc, sc

        # depth after the Taylor: power raise (3) + the inverse + the
        # mix/projection/affine tail (~6): the mid-exp refresh's threshold
        need = 3 + relu_degree_depth(p.inv_degree) + 6
        scores = self.g.eval_exp(scores, pow8=p.exp_pow8, boot=boot,
                                 boot_below=need)
        ssum = ops.rotsum(scores, self.w.k_lin, d)   # row sums over k blocks
        inv = self.g.eval_inverse(ssum, *p.inv_range, degree=p.inv_degree)
        attn = ev.mul(scores, inv)

        # back to per-query repeated cts: (nchunk, m, ...) -> (Sq, ...)
        outs = []
        for c in range(attn.c0.shape[0]):
            one = attn.with_data(attn.c0[c], attn.c1[c])
            mq = m if (c + 1) * m <= Sq else Sq - c * m
            outs.append(ops.unwrap_to_repeated(one, mq))
        attn_q = _stack_cat(outs)
        del outs, attn, scores, inv, ssum

        O = ops.rotsum(ev.mul(attn_q, V_w), nb, d)   # (Sq,) repeated attn @ V
        del attn_q

        wo = self._pt("WO_cr", _cr_flat(w.WO, nb, d), O.nl)
        out = ops.rotsum(ev.mul_plain(O, wo), d, 1)  # expanded-dirty
        bo = ev.encode(ops.expanded_slots(w.BO), nl=out.nl, scale=out.scale)
        out = ev.add_plain(out, bo)

        if cls_only and S_total > 1:
            z0 = torch.zeros((S_total - 1,) + tuple(out.c0.shape[1:]),
                             dtype=out.c0.dtype, device=out.c0.device)
            out = out.with_data(torch.cat([out.c0, z0]),
                                torch.cat([out.c1, z0]))
        # residual with the inputs (expanded; lane-0 slots valid)
        x_adj, out = ev.match(x_cts, out)
        return ev.add(x_adj, out)

    def _wrap_rows(self, rows: Ciphertext) -> Ciphertext:
        """(k, ...) repeated batch -> one ct, block j = row j: mask block 0,
        then interleave with stride d."""
        ev, ops = self.ev, self.ops
        pt = ev.encode_cached(("mask_block0", ops.d), ops.mask_block(0),
                              nl=rows.nl)
        return ops.interleave_batch(ev.mul_plain(rows, pt), stride=ops.d)

    def affine(self, wrapped: Ciphertext, a, b, c, S_total) -> Ciphertext:
        """Sequence-adaptive affine on wrapped (dim-major) cts, a/b in
        expanded layout."""
        ev, ops = self.ev, self.ops
        fL = c[0] + c[1] / np.sqrt(S_total) + c[2] / S_total
        a_pt = ev.encode(ops.expanded_slots(a * fL), nl=wrapped.nl)
        out = ev.mul_plain(wrapped, a_pt)
        b_pt = ev.encode(ops.expanded_slots(b * fL), nl=out.nl, scale=out.scale)
        return ev.add_plain(out, b_pt)

    def wrap_tokens(self, dirty: Ciphertext) -> Ciphertext:
        """(S, ...) expanded-dirty -> chunked wrapped cts (lane t = token t,
        block j = dim j): mask lane 0, then interleave each <= d chunk."""
        ev, ops = self.ev, self.ops
        S = dirty.c0.shape[0]
        m = min(ops.d, S)
        pt = ev.encode_cached(("mask_mod_n", ops.d, 0),
                              ops.mask_mod_n(ops.d), nl=dirty.nl)
        masked = ev.mul_plain(dirty, pt)
        return _stack([ops.interleave_batch(masked.with_data(
            masked.c0[c * m:(c + 1) * m], masked.c1[c * m:(c + 1) * m]),
            stride=1) for c in range(-(-S // m))])

    def unwrap_tokens(self, wrapped: Ciphertext, S_total: int,
                      count: int | None = None) -> Ciphertext:
        """Chunked wrapped cts -> (S, ...) expanded batch; `count` unwraps
        only the first `count` tokens."""
        ops = self.ops
        outs = []
        left = S_total if count is None else min(count, S_total)
        for c in range(wrapped.c0.shape[0]):
            if left <= 0:
                break
            mq = min(ops.d, left)
            outs.append(ops.unwrap_to_repeated(
                wrapped.with_data(wrapped.c0[c], wrapped.c1[c]), mq))
            left -= mq
        return _stack_cat(outs)

    def ffn(self, x_cts: Ciphertext, use_containers: bool = True,
            boot=None, token_chunk: int | None = None,
            _force_containers: bool = False) -> Ciphertext:
        """FFN up (d -> d_ffn in d-blocks) + GELU + down (d_ffn -> d).
        x_cts: (S, ...) expanded.  Returns (S, ...) expanded-dirty.

        With use_containers the nblk*S activations pack into
        ceil(nblk*S*d/slots) container ciphertexts before the GELU (built
        by the batched log-tree), so the Chebyshev touches ~d/nblk times
        fewer ciphertexts; `boot` refreshes the containers after the GELU,
        all of them in one batched bootstrap.

        `token_chunk` runs the token batch in chunks of that size (the
        up-projection holds nblk cts per token); every chunk takes the
        container path, so all land on the same (nl, scale)."""
        ev, ops, w, p = self.ev, self.ops, self.w, self.p
        d, nb = ops.d, ops.nb
        S_in = x_cts.c0.shape[0]
        if token_chunk and S_in > token_chunk:
            assert token_chunk * (w.W1.shape[0] // d) > ops.slots // d
            return _stack_cat([self.ffn(
                x_cts.with_data(x_cts.c0[s: s + token_chunk],
                                x_cts.c1[s: s + token_chunk]),
                use_containers, boot, _force_containers=True)
                for s in range(0, S_in, token_chunk)])
        nblk = w.W1.shape[0] // d
        h = _stack([self._matmul_re_w(x_cts, w.W1[k * d:(k + 1) * d],
                                      w.B1[k * d:(k + 1) * d], f"W1_{k}",
                                      w_scale=p.gelu_clip)
                    for k in range(nblk)])   # (nblk, S, ...) repeated
        S = h.c0.shape[1]

        G = ops.slots // d                     # pieces per container
        if use_containers and (nblk * S > G or _force_containers):
            # flatten to (S*nblk) in container order: piece u*nblk + b
            tail = tuple(h.c0.shape[2:])
            c0 = h.c0.transpose(0, 1).reshape((S * nblk,) + tail)
            c1 = h.c1.transpose(0, 1).reshape((S * nblk,) + tail)
            ncont = -(-S * nblk // G)
            pad = ncont * G - S * nblk
            if pad:
                z = torch.zeros((pad,) + tail, dtype=c0.dtype,
                                device=c0.device)
                c0, c1 = torch.cat([c0, z]), torch.cat([c1, z])
            pt = ev.encode_cached(("mask_block0", ops.d), ops.mask_block(0),
                                  nl=h.nl)
            masked = ev.mul_plain(h.with_data(c0, c1), pt)
            tail = tuple(masked.c0.shape[1:])
            groups = masked.with_data(
                masked.c0.reshape((ncont, G) + tail),
                masked.c1.reshape((ncont, G) + tail))
            # merge the G axis into block offsets, one container at a time
            packed = _stack([ops.interleave_batch(groups.with_data(
                groups.c0[c], groups.c1[c]), stride=d) for c in range(ncont)])
            packed = self.g.eval_gelu(packed, -1.0, 1.0, mult=p.gelu_clip,
                                      degree=p.gelu_degree)
            if boot is not None:
                packed = boot.refresh(packed)
            # unpack: batch j of container c = piece c*G + j
            flat2 = _stack_cat([ops.deinterleave_batch(packed.with_data(
                packed.c0[c], packed.c1[c]), G, stride=d)
                for c in range(packed.c0.shape[0])])
            flat2 = flat2.with_data(flat2.c0[: S * nblk], flat2.c1[: S * nblk])
            pt2 = ev.encode_cached(("mask_block0", ops.d), ops.mask_block(0),
                                   nl=flat2.nl)
            rep = ops.repeat(ev.mul_plain(flat2, pt2), nb, d)  # repeated
            tail = tuple(rep.c0.shape[1:])
            h = rep.with_data(
                rep.c0.reshape((S, nblk) + tail).transpose(0, 1),
                rep.c1.reshape((S, nblk) + tail).transpose(0, 1))
        else:
            h = self.g.eval_gelu(h, -1.0, 1.0, mult=p.gelu_clip,
                                 degree=p.gelu_degree)
            if boot is not None:
                h = boot.refresh(h)
        # down-projection: sum_b W2[:, b-block] @ h_b (CR layout per block)
        acc = None
        for k in range(nblk):
            hb = h.with_data(h.c0[k], h.c1[k])
            pt = self._pt(f"W2_{k}", _cr_flat(w.W2[:, k * d:(k + 1) * d],
                                              nb, d), hb.nl)
            t = ev.mul_plain(hb, pt, rescale=False)
            acc = t if acc is None else ev.add(acc, t)
        out = ops.rotsum(ev.rescale(acc), d, 1)        # expanded-dirty
        b2 = ev.encode(ops.expanded_slots(w.B2), nl=out.nl, scale=out.scale)
        return ev.add_plain(out, b2)

    def pooler_classifier(self, cls_ct: Ciphertext,
                          boot=None) -> Ciphertext:
        """tanh pooler on CLS + linear head; logits at lanes 0, d, 2d, ...
        `boot` refreshes before the tanh when its depth would not fit."""
        ev, ops, w, p = self.ev, self.ops, self.w, self.p
        pooled = self._matmul_re_w(cls_ct, w.Wp, w.bp, "Wp",
                                   w_scale=p.tanh_scale)
        if boot is not None and \
                pooled.nl - 1 < relu_degree_depth(p.tanh_degree) + 3:
            pooled = boot.refresh(pooled)
        pooled = self.g.eval_tanh(pooled, -1.0, 1.0, mult=p.tanh_scale,
                                  degree=p.tanh_degree)
        # classifier: CR layout (n_classes rows)
        fc = self._pt("Wc_cr", _cr_flat(w.Wc, ops.nb, ops.d), pooled.nl)
        out = ops.rotsum(ev.mul_plain(pooled, fc), ops.d, 1)
        ncls = w.Wc.shape[0]
        bias = np.zeros(ops.slots)
        bias[: ncls * ops.d: ops.d] = w.bc
        out = ev.add_plain(out, ev.encode(bias, nl=out.nl, scale=out.scale))
        mask = ops.mask_mod_n(ops.d)
        mask[ncls * ops.d:] = 0.0
        return ev.mul_plain(out, ev.encode(mask, nl=out.nl))

    # -- homomorphic E/F projection (layers >= 2) -----------------------

    def ef_project(self, x_cts: Ciphertext, E: np.ndarray, b: np.ndarray,
                   S_total: int) -> Ciphertext:
        """XE_r = sum_t E[r, t] * x_t + b_r computed homomorphically: the
        sequence compression a later layer cannot leave to the client."""
        ev, ops = self.ev, self.ops
        wrapped = self.wrap_tokens(x_cts)        # (chunks, ...) lane = token
        k_lin = E.shape[0]
        m = min(ops.d, S_total)
        rows = []
        for r in range(k_lin):
            acc = None
            for c in range(wrapped.c0.shape[0]):
                one = wrapped.with_data(wrapped.c0[c], wrapped.c1[c])
                coefs = np.zeros(ops.slots)
                for t in range(min(m, S_total - c * m)):
                    coefs[t::ops.d] = E[r, c * m + t]
                term = ev.mul_plain(one, ev.encode(coefs, nl=one.nl),
                                    rescale=False)
                acc = term if acc is None else ev.add(acc, term)
            acc = ev.rescale(acc)
            mp = 1 << (m - 1).bit_length()       # lanes >= m hold zeros
            rows.append(ops.rotsum(acc, mp, 1))  # lane 0 of block j = XE_r[j]
        out = _stack(rows)                       # (k_lin, ...) expanded-dirty
        # clean to full expanded: mask lane 0 + repeat
        out = ev.mul_plain(out, ev.encode(ops.mask_mod_n(ops.d), nl=out.nl))
        out = ops.repeat(out, ops.d, 1)
        # bias: b_r adds to every dim of row r
        bias = np.stack([np.full(ops.slots, float(bb)) for bb in b])
        pt_b = ev.encode(bias, nl=out.nl, scale=out.scale, batch=True)
        return ev.add_plain(out, pt_b)

    def encoder_layer(self, x_cts, xe, xf, S_total, w=None,
                      cls_only=False, boot=None):
        """attention + affine1 + FFN + affine2, refreshing through `boot`
        after each affine.  Returns per-token expanded cts."""
        w = w or self.w
        attn = self.attention(x_cts, xe, xf, S_total, cls_only, boot=boot)
        wrapped = self.affine(self.wrap_tokens(attn), w.a1, w.b1, w.c1,
                              S_total)
        if boot is not None:
            wrapped = boot.refresh(wrapped)
        x2 = self.unwrap_tokens(wrapped, S_total)
        y = self.ffn(x2, boot=boot)
        x2m, ym = self.ev.match(x2, y)
        wrapped2 = self.affine(self.wrap_tokens(self.ev.add(x2m, ym)),
                               w.a2, w.b2, w.c2, S_total)
        if boot is not None:
            wrapped2 = boot.refresh(wrapped2)
        return self.unwrap_tokens(wrapped2, S_total)

    def next_layer(self, x: Ciphertext, lw: LinformerWeights, S_total: int,
                   boot=None) -> Ciphertext:
        """One more encoder layer with weights lw: its E/F compression runs
        homomorphically; the finished layer's cached plaintexts are dropped
        first (the next layer re-encodes what it shares)."""
        xe = self.ef_project(x, lw.E_w[:, :S_total], lw.E_b, S_total)
        xf = self.ef_project(x, lw.F_w[:, :S_total], lw.F_b, S_total)
        self.ev._enc_cache.clear()
        self._pt_cache.clear()
        gc.collect()
        saved = self.w
        self.w = lw
        try:
            return self.encoder_layer(x, xe, xf, S_total, boot=boot)
        finally:
            self.w = saved

    # -- full forward ---------------------------------------------------

    def forward(self, emb: np.ndarray, cls_only: bool = False,
                extra_layers: list | None = None, boot=None,
                input_nl: int | None = None) -> Ciphertext:
        """End-to-end encrypted forward.  extra_layers: LinformerWeights of
        layers 2..N, whose K/V compression runs homomorphically."""
        x_cts, xe, xf, S_total = self.encrypt_inputs(emb, nl=input_nl)
        x = self.encoder_layer(x_cts, xe, xf, S_total, cls_only=cls_only,
                               boot=boot)
        for lw in (extra_layers or []):
            x = self.next_layer(x, lw, S_total, boot=boot)
        return self.pooler_classifier(x.with_data(x.c0[0], x.c1[0]),
                                      boot=boot)

    def decrypt_logits(self, out: Ciphertext) -> np.ndarray:
        """Client decode: the stride-d logits."""
        vals = np.real(np.asarray(self.ev.decrypt(out)))
        ncls = self.w.Wc.shape[0]
        return vals[: ncls * self.ops.d: self.ops.d]


def _cr_flat(W: np.ndarray, nb: int, d: int) -> np.ndarray:
    """CR weight layout: slot[d*j + i] = W[j][i] (rows over blocks)."""
    out = np.zeros((nb, d))
    out[: W.shape[0], : W.shape[1]] = W
    return out.reshape(-1)


def _stack(cts: list[Ciphertext]) -> Ciphertext:
    return cts[0].with_data(torch.stack([c.c0 for c in cts]),
                            torch.stack([c.c1 for c in cts]))


def _stack_cat(cts: list[Ciphertext]) -> Ciphertext:
    return cts[0].with_data(torch.cat([c.c0 for c in cts]),
                            torch.cat([c.c1 for c in cts]))
