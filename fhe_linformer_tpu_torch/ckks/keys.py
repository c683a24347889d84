"""Key material and key generation.

Sampling is host numpy from `default_rng(cfg.seed)` in the JAX package's
exact order (ternary secret, public key, relinearization key, the rotation
keys in the order given, then the conjugation key), and each key's uniform
`a` halves come from their own named seed (`seeded_uniform_eval`), so the
key arrays equal the JAX package's for the same config.  The polynomial
arithmetic (NTTs, products) runs on the context's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import ntt
from ..ops.modarith import addmod, mulmod, submod
from .context import Context


@dataclass
class SecretKey:
    coeffs: np.ndarray           # (n,) int8 ternary, host
    eval_full: torch.Tensor      # (num_q + k_sp, N) int32 eval domain


@dataclass
class PublicKey:
    p0: torch.Tensor             # (num_q, N) int32 eval
    p1: torch.Tensor


@dataclass
class KSKey:
    """One hybrid key-switch key (relinearization, a rotation or the
    conjugation) over the full extended basis: (ndig, num_q + k_sp, N)
    int32 per half.  The uniform `a` halves come from the named seed
    `a_seed`, so a keystore may hold the seed instead of them."""
    b: torch.Tensor
    a: torch.Tensor
    a_seed: tuple | None = None


@dataclass
class KeySet:
    """Everything the evaluator needs; rotation keys keyed by slot shift,
    and the conjugation key the bootstrap needs."""
    sk: SecretKey | None
    pk: PublicKey
    relin: KSKey
    rot: dict[int, KSKey]
    conj: KSKey | None = None


def seeded_uniform_eval(seed, qs, ndig: int, n: int) -> np.ndarray:
    """(ndig, len(qs), n) uint32 uniform residues from a named seed."""
    rng = np.random.default_rng(seed)
    out = np.empty((ndig, len(qs), n), np.uint32)
    for j in range(ndig):
        for i, q in enumerate(qs):
            out[j, i] = rng.integers(0, int(q), n, dtype=np.uint32)
    return out


def rns_residues(coeffs: np.ndarray, primes) -> np.ndarray:
    """Centered int coeffs (..., n) -> (..., L, n) residues (int32)."""
    c = np.asarray(coeffs, np.int64)[..., None, :]
    qs = np.asarray(primes, np.int64)[:, None]
    return (c % qs).astype(np.int32)


class KeyGenerator:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.rng = np.random.default_rng(ctx.cfg.seed)

    def ternary(self) -> np.ndarray:
        cfg = self.ctx.cfg
        if cfg.secret_hw is None:
            return self.rng.integers(-1, 2, cfg.n).astype(np.int64)
        s = np.zeros(cfg.n, np.int64)
        idx = self.rng.choice(cfg.n, cfg.secret_hw, replace=False)
        s[idx] = self.rng.choice([-1, 1], cfg.secret_hw)
        return s

    def gauss(self) -> np.ndarray:
        return np.rint(self.rng.normal(0.0, self.ctx.cfg.sigma, self.ctx.cfg.n)
                       ).astype(np.int64)

    def uniform_eval(self, limbs) -> torch.Tensor:
        """Uniform ring element directly in the eval domain."""
        out = np.empty((len(limbs), self.ctx.cfg.n), np.uint32)
        for i, l in enumerate(limbs):
            out[i] = self.rng.integers(0, self.ctx.basis[l], self.ctx.cfg.n,
                                       dtype=np.uint32)
        return self.ctx.tensor(out.astype(np.int32))

    def to_eval(self, coeffs: np.ndarray, limbs) -> torch.Tensor:
        res = rns_residues(coeffs, [self.ctx.basis[i] for i in limbs])
        return ntt.fwd(self.ctx.tensor(res), self.ctx.ntt, limbs)

    def secret_key(self) -> SecretKey:
        s = self.ternary()
        full = self.ctx.limb_idx(self.ctx.num_q, specials=True)
        return SecretKey(s.astype(np.int8), self.to_eval(s, full))

    def public_key(self, sk: SecretKey) -> PublicKey:
        ctx = self.ctx
        limbs = ctx.limb_idx(ctx.num_q)
        q = ctx.mod(limbs)
        a = self.uniform_eval(limbs)
        e = self.to_eval(self.gauss(), limbs)
        s = sk.eval_full[: ctx.num_q]
        return PublicKey(submod(e, mulmod(a, s, q), q), a)

    def _ks_key(self, sk: SecretKey, s_prime: torch.Tensor,
                tag: tuple) -> KSKey:
        """Digits encrypting P*F_j*s' under s over the full basis; `tag`
        names the seed of the uniform halves."""
        ctx = self.ctx
        full = ctx.limb_idx(ctx.num_q, specials=True)
        q = ctx.mod(full)
        P = 1
        for p in ctx.ps:
            P *= p
        groups = ctx.digit_groups_full()
        seed = (ctx.cfg.seed & 0x7FFFFFFF, 0xA5) + tuple(tag)
        a_all = ctx.tensor(seeded_uniform_eval(
            seed, [ctx.basis[i] for i in full], len(groups),
            ctx.cfg.n).astype(np.int32))
        bs = []
        for dj, g_full in enumerate(groups):
            F_j = 1
            for i, qq in enumerate(ctx.qs):
                if i not in g_full:
                    F_j *= qq
            factor = ctx.tensor(np.asarray(
                [(P * F_j) % ctx.basis[i] for i in full],
                np.int64).reshape(-1, 1).astype(np.int32))
            e_j = self.to_eval(self.gauss(), full)
            b_j = addmod(submod(e_j, mulmod(a_all[dj], sk.eval_full, q), q),
                         mulmod(s_prime, factor, q), q)
            bs.append(b_j)
        return KSKey(torch.stack(bs), a_all, seed)

    def relin_key(self, sk: SecretKey) -> KSKey:
        q = self.ctx.mod(self.ctx.limb_idx(self.ctx.num_q, specials=True))
        s2 = mulmod(sk.eval_full, sk.eval_full, q)
        return self._ks_key(sk, s2, tag=(0, 0))

    def rotation_key(self, sk: SecretKey, rot: int) -> KSKey:
        """Key switching tau_t(s) -> s for a rotation by `rot` slots."""
        return self._galois_key(sk, self.ctx.galois_t(rot))

    def conjugation_key(self, sk: SecretKey) -> KSKey:
        """Key switching tau_{2n-1}(s) -> s (complex conjugation)."""
        return self._galois_key(sk, self.ctx.conj_t())

    def _galois_key(self, sk: SecretKey, t: int) -> KSKey:
        s_rot = sk.eval_full[:, self.ctx.galois_perm(t)]
        return self._ks_key(sk, s_rot, tag=(1, t))


def generate_keys(ctx: Context, rotations=(), conj: bool = False,
                  keep_secret: bool = True) -> KeySet:
    kg = KeyGenerator(ctx)
    sk = kg.secret_key()
    pk = kg.public_key(sk)
    relin = kg.relin_key(sk)
    rot = {r: kg.rotation_key(sk, r) for r in rotations}
    ck = kg.conjugation_key(sk) if conj else None
    return KeySet(sk if keep_secret else None, pk, relin, rot, ck)
