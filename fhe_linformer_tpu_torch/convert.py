"""Carry state across from the JAX package, as plain numpy arrays.

The tests call `np.asarray` on the JAX package's objects and hand the
arrays here; nothing in this module imports the JAX package.  Residues
arrive as uint32 (all below 2**30) and are stored as int32.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from .ckks.ciphertext import Ciphertext
from .ckks.context import Context
from .ckks.keys import KeySet, KSKey, PublicKey, SecretKey
from .models.golden import LinformerWeights


def _res(ctx: Context, a) -> torch.Tensor:
    return ctx.tensor(np.asarray(a).astype(np.int32))


def weights_from_numpy(arrays: dict) -> LinformerWeights:
    """{field name: array} -> LinformerWeights (float64)."""
    return LinformerWeights(**{f.name: np.asarray(arrays[f.name], np.float64)
                               for f in fields(LinformerWeights)})


def keys_from_numpy(ctx: Context, sk_coeffs, sk_eval, pk_p0, pk_p1,
                    relin: tuple, rot: dict, conj: tuple | None = None
                    ) -> KeySet:
    """Key arrays -> KeySet.  relin, conj: (b, a); rot: {shift: (b, a)}
    or, for a reduced-basis key, {shift: (b, a, max_nl)}; each half
    (ndig, rows, N), rows num_q + k_sp or max_nl + k_sp."""
    ks = lambda ba: KSKey(_res(ctx, ba[0]), _res(ctx, ba[1]),
                          max_nl=ba[2] if len(ba) > 2 else None)
    return KeySet(
        sk=SecretKey(np.asarray(sk_coeffs, np.int8), _res(ctx, sk_eval)),
        pk=PublicKey(_res(ctx, pk_p0), _res(ctx, pk_p1)),
        relin=ks(relin), rot={int(r): ks(ba) for r, ba in rot.items()},
        conj=None if conj is None else ks(conj))


def ciphertext_from_numpy(ctx: Context, c0, c1, nl: int,
                          scale: float) -> Ciphertext:
    return Ciphertext(_res(ctx, c0), _res(ctx, c1), int(nl), float(scale))


def ciphertext_to_numpy(ct: Ciphertext):
    """(c0, c1, nl, scale) with uint32 residues, the JAX package's dtype."""
    to = lambda t: t.cpu().numpy().astype(np.uint32)
    return to(ct.c0), to(ct.c1), ct.nl, ct.scale
