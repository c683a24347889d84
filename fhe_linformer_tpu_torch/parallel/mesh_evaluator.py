"""An Evaluator whose key switches run on a (dp x limb) mesh
(`parallel/mesh.py`), over the same Context and KeySet as a
single-process Evaluator.  Every rank must run the same ops on the same
(replicated) ciphertexts.

  * dp (when the mesh's dp axis has more than one rank): a key-switching
    op (`Evaluator._run` with keyswitches > 0: ct x ct products, the
    Chebyshev nodes, Galois key switches, accumulated rotations) whose
    batch gives every dp rank at least one ciphertext is cut into one
    contiguous block per rank: this rank runs its block and the blocks are
    all-gathered, so every rank returns the whole result (each
    ciphertext's ops are independent of the others', so it equals the
    single-process result bit for bit).  An op without a key switch runs
    its chunks on every rank: gathering its output would cost more than
    computing it.
  * limb (when the mesh's limb axis has more than one rank): an unbatched
    Galois key switch or rotation combo runs limb-sharded
    (`parallel/ksprod.py`).  The JAX package's conditions apply: an
    extended basis (nl + k) that divides the limb axis, full-basis keys,
    coefficient plaintexts and no identity term; any other switch runs on
    this process alone, as there.
"""

from __future__ import annotations

import torch

from ..ckks.ciphertext import Ciphertext, CoeffPlaintext
from ..ckks.evaluator import Evaluator, _count, _flat, _run_chunks, _unflat
from ..ckks.keys import KSKey
from ..utils.timing import GLOBAL_TIMERS as _COUNTS
from .ksprod import (build_sharded_ks, ext_block, gather_rows, rank_tables,
                     sharded_combo, sharded_galois)


class MeshEvaluator(Evaluator):
    def __init__(self, ctx, keys, mesh):
        super().__init__(ctx, keys)
        self.mesh = mesh
        self._dp = mesh.comms["dp"] if mesh.shape["dp"] > 1 else None
        self._limb = mesh.comms["limb"] if mesh.shape["limb"] > 1 else None
        self._rank_ks: dict = {}

    # -- dp ------------------------------------------------------------------

    def _run(self, core, arrays, shape, keyswitches: int):
        dp = self._dp
        count = _count(shape)
        per = count if dp is None else -(-count // dp.size)
        if dp is None or keyswitches == 0 or (dp.size - 1) * per >= count:
            return super()._run(core, arrays, shape, keyswitches)
        lo, hi = dp.rank * per, min((dp.rank + 1) * per, count)
        _COUNTS.count("keyswitch", keyswitches * (hi - lo))
        flat = [f[lo:hi] for f in _flat(arrays, shape)]
        outs = torch.stack(_run_chunks(core, flat, self.heavy_chunk))
        if hi - lo < per:                                # (k, hi - lo, ...)
            outs = torch.cat([outs, outs.new_zeros(
                (outs.shape[0], per - (hi - lo)) + outs.shape[2:])], 1)
        return _unflat(dp.all_gather(outs, 1)[:, :count], shape)

    # -- limb ----------------------------------------------------------------

    def _rank(self, nl: int):
        if nl not in self._rank_ks:
            self._rank_ks[nl] = rank_tables(
                self.ctx, build_sharded_ks(self.ctx, nl,
                                           self.mesh.shape["limb"]),
                self.mesh.coords["limb"])
        return self._rank_ks[nl]

    def _shardable(self, ct: Ciphertext) -> bool:
        return self._limb is not None and ct.c0.dim() == 2 and \
            (ct.nl + self.ctx.k_sp) % self.mesh.shape["limb"] == 0

    def _galois(self, ct: Ciphertext, perm, key: KSKey) -> Ciphertext:
        if not self._shardable(ct) or key.max_nl is not None:
            return super()._galois(ct, perm, key)
        _COUNTS.count("rotation")
        _COUNTS.count("keyswitch")
        _COUNTS.count("keyswitch_sharded")
        rk = self._rank(ct.nl)
        o = sharded_galois(
            self.ctx, rk, self._limb, ext_block(rk, ct.c0),
            ext_block(rk, ct.c1), perm, key.b.index_select(1, rk.key_rows),
            key.a.index_select(1, rk.key_rows))
        return gather_rows(rk, self._limb, o, ct.scale)

    def rotate_combo(self, ct: Ciphertext, items) -> Ciphertext:
        slots = self.ctx.cfg.slots
        if not self._shardable(ct) or self.keys is None or not all(
                isinstance(p, CoeffPlaintext) and r % slots != 0
                for r, p in items):
            return super().rotate_combo(ct, items)
        keys = [self._rot_key(r) for r, _ in items]
        if any(k.max_nl is not None for k in keys):
            return super().rotate_combo(ct, items)
        scale = items[0][1].scale
        for _, p in items:
            assert abs(p.scale / scale - 1.0) < 1e-12
        _COUNTS.count("combo_rot", len(items))
        _COUNTS.count("keyswitch")
        _COUNTS.count("keyswitch_sharded")
        rk = self._rank(ct.nl)
        o = sharded_combo(
            self.ctx, rk, self._limb, ext_block(rk, ct.c0),
            ext_block(rk, ct.c1), [self._perm(r) for r, _ in items],
            [k.b.index_select(1, rk.key_rows) for k in keys],
            [k.a.index_select(1, rk.key_rows) for k in keys],
            torch.stack([p.coeffs for _, p in items]))
        return gather_rows(rk, self._limb, o, ct.scale * scale)
