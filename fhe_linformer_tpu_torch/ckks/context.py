"""CKKS context: parameters, modulus chain, and the derived device tables.

The counterpart of the JAX package's `ckks/context.py`, with its numbers
(primes, key-switch and rescale constants) computed the same way so every
table equals the JAX one; the tables hold only the fields this port reads,
as int32 tensors on the context's device.

Hybrid key switching uses the level-robust factorization: the key for
digit j encrypts P * F_j * s' with F_j = (full chain)/(full group j), and
the decomposition at level l multiplies limb t by
  [F_j^{-1}]_{q_t} * [(Qhat_{j,l}/q_t)^{-1}]_{q_t}
before fast-base-converting group j's limbs to the full active basis, so
one fixed key serves every level.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.basecvt import plane_fragments
from ..ops.modarith import shoup_precompute
from ..ops.ntt import NttTables
from ..primes import ntt_primes, scaling_primes


@dataclass(frozen=True)
class CKKSConfig:
    """Scheme hyper-parameters (the JAX package's CKKSConfig)."""
    n: int = 1 << 15                  # ring dimension
    scale_bits: int = 26              # target scale Delta
    num_scaling: int = 20             # scaling primes = usable mult depth
    first_mod_bits: int = 30          # q0 headroom modulus (<= 30)
    dnum: int = 4                     # hybrid key-switch digits
    secret_hw: int | None = None      # sparse ternary HW; None = uniform
    sigma: float = 3.19               # error stddev
    seed: int = 20260817              # deterministic keygen/test vectors

    @property
    def slots(self) -> int:
        return self.n // 2


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def modulus_chain(cfg: CKKSConfig):
    """(qs, ps, alpha): the RNS prime chain a config resolves to."""
    two_n = 2 * cfg.n
    alpha = (cfg.num_scaling + 1 + cfg.dnum - 1) // cfg.dnum
    big = ntt_primes(two_n, 1 + alpha, max_bits=cfg.first_mod_bits)
    qs = (big[0],) + scaling_primes(two_n, cfg.num_scaling, cfg.scale_bits)
    return qs, tuple(big[1:]), alpha


def resolve_device(device=None) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class BCTables:
    """Fused base-conversion tables (ops/basecvt.py): source rows cover nd
    digit groups of alpha limbs (zero fold / unit prime on pad rows).

    `planes` and `rowc` are kernel K3's: the conversion matrix expanded to
    C[j, p, t, e2] = conv[j alpha + t, p] * 2**(8 e2) mod p, split into four
    balanced s8 planes C_e and laid out as the A fragments of
    mma.m16n8k32 (`ops.basecvt.plane_fragments`); `rowc` holds per target
    row the prime, bias (the least multiple of p >= 2**30),
    sh1 = floor(2**32 / p), p16 = 2**16 mod p and its Shoup companion."""
    nd: int
    alpha: int
    fold: torch.Tensor        # (G,) fold constant per source row
    fold_s: torch.Tensor      # (G,) its Shoup companion (uint32 bits)
    gq: torch.Tensor          # (G,) source primes (1 on pad rows)
    conv: torch.Tensor        # (G, tgt) (Qhat/q_t) mod p
    q_out: torch.Tensor       # (tgt,) target primes
    planes: torch.Tensor      # (nd, RB, 2, KS, 32, 4) words of 4 s8
    rowc: torch.Tensor        # (5, tgt) q, bias, sh1, p16, p16_s (uint32 bits)


@dataclass(frozen=True)
class LevelKS:
    """Key-switch tables for one active q-limb count nl."""
    nl: int
    tgt_idx: tuple            # basis indices: active q then specials
    act_idx: tuple
    sp_idx: tuple
    groups: tuple             # active limbs of each digit (contiguous runs)
    dig_limbs: tuple          # per digit: tgt_idx, -1 at its own group
    q_act: torch.Tensor       # (nl, 1)
    q_tgt: torch.Tensor       # (nl + k, 1)
    q_sp: torch.Tensor        # (k, 1)
    pfold: torch.Tensor       # (k, 1) (P/p_t)^-1 mod p_t
    pinv: torch.Tensor        # (nl, 1) P^-1 mod q_i
    pmod: torch.Tensor        # (nl, 1) P mod q_i
    pfold_s: torch.Tensor     # Shoup companions floor(w 2^32 / q) of the
    pinv_s: torch.Tensor      # three (uint32 bits in int32; kernel K5)
    pmod_s: torch.Tensor
    mdq40: torch.Tensor       # (k, 1) int64 round(2^40 / p_t)
    own: torch.Tensor         # (nl, 1) F_j(t)^-1 mod q_t (own-group skip)
    bc: BCTables              # decomposition Q_l -> Q_l u P
    md: BCTables              # mod-down conversion P -> Q_l


@dataclass(frozen=True)
class RescalePlan:
    """Constants for dropping limb nl-1 onto limbs [0, nl-1)."""
    nl: int
    half: int                 # qd // 2
    inv: torch.Tensor         # (nl-1, 1) qd^-1 mod q_i
    qrem: torch.Tensor        # (nl-1, 1) remaining primes
    qdm: torch.Tensor         # (nl-1, 1) qd mod q_i


class Context:
    def __init__(self, cfg: CKKSConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.qs, self.ps, self.alpha = modulus_chain(cfg)
        self.num_q = len(self.qs)
        self.k_sp = len(self.ps)
        self.basis = self.qs + self.ps                 # full limb order
        assert len(set(self.basis)) == len(self.basis)
        self.delta = float(1 << cfg.scale_bits)
        self.ntt = NttTables(cfg.n, self.basis, self.device)
        self._mod: dict[tuple, torch.Tensor] = {}
        self._ks: dict[int, LevelKS] = {}
        self._rescale: dict[int, RescalePlan] = {}
        self._galois_perm: dict[int, torch.Tensor] = {}

    def tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # -- limb subsets --------------------------------------------------------

    def limb_idx(self, nl: int, specials: bool = False) -> tuple[int, ...]:
        idx = list(range(nl))
        if specials:
            idx += list(range(self.num_q, self.num_q + self.k_sp))
        return tuple(idx)

    def mod(self, limbs) -> torch.Tensor:
        """(L, 1) int32 moduli of a limb subset, cached."""
        key = tuple(limbs)
        if key not in self._mod:
            self._mod[key] = self.tensor(np.asarray(
                [self.basis[i] for i in key], np.int32).reshape(-1, 1))
        return self._mod[key]

    # -- rotations -----------------------------------------------------------

    def galois_t(self, rot: int) -> int:
        """Automorphism exponent for a rotation by `rot` slots."""
        return int(pow(5, rot % self.cfg.slots, 2 * self.cfg.n))

    def conj_t(self) -> int:
        """Automorphism exponent of complex conjugation (X -> X^-1)."""
        return 2 * self.cfg.n - 1

    def galois_perm(self, t: int) -> torch.Tensor:
        """Eval-domain gather index: new_eval[k] = old_eval[perm[k]]."""
        if t not in self._galois_perm:
            n = self.cfg.n
            k = np.arange(n, dtype=np.int64)
            e_new = (t * (2 * k + 1)) % (2 * n)
            self._galois_perm[t] = self.tensor((e_new - 1) // 2)
        return self._galois_perm[t]

    def auto_coeff(self, x: np.ndarray, t: int) -> np.ndarray:
        """Coefficient-domain automorphism X -> X^t of an integer
        coefficient vector (host numpy)."""
        n = self.cfg.n
        jt = np.arange(n, dtype=np.int64) * t % (2 * n)
        x = np.asarray(x)
        out = np.zeros_like(x)
        out[jt % n] = x * np.where(jt >= n, -1, 1)
        return out

    # -- rescale tables ------------------------------------------------------

    def rescale_tables(self, nl: int) -> RescalePlan:
        if nl not in self._rescale:
            qd = self.qs[nl - 1]
            rem = np.asarray(self.qs[: nl - 1], np.int64).reshape(-1, 1)
            inv = np.asarray([pow(qd, int(q) - 2, int(q)) for q in rem[:, 0]],
                             np.int64).reshape(-1, 1)
            i32 = lambda a: self.tensor(a.astype(np.int32))
            self._rescale[nl] = RescalePlan(
                nl=nl, half=qd // 2, inv=i32(inv), qrem=i32(rem),
                qdm=i32(int(qd) % rem))
        return self._rescale[nl]

    # -- hybrid key-switch tables --------------------------------------------

    def digit_groups_full(self) -> tuple[tuple[int, ...], ...]:
        out = []
        for j in range(self.cfg.dnum):
            g = tuple(range(j * self.alpha,
                            min((j + 1) * self.alpha, self.num_q)))
            if g:
                out.append(g)
        return tuple(out)

    def bc_tables(self, nd, alpha, fold, gq, conv, q_out) -> BCTables:
        """BCTables for nd digit groups of alpha source rows each (pad rows:
        fold 0, prime 1, conv 0) converting to the primes q_out."""
        i32 = lambda a: self.tensor(np.asarray(a, np.int64).astype(np.int32))
        u32 = lambda a: self.tensor(np.ascontiguousarray(
            np.asarray(a).astype(np.uint32)).view(np.int32))
        q = np.asarray(q_out, np.int64)
        p16 = (1 << 16) % q
        rowc = np.stack([q, ((1 << 30) // q + 1) * q, (1 << 32) // q, p16,
                         shoup_precompute(p16, q)])
        assert rowc[1].max() + (1 << 30) < (1 << 32)
        return BCTables(
            nd=nd, alpha=alpha, fold=i32(fold),
            fold_s=u32(shoup_precompute(fold, gq)),
            gq=i32(gq), conv=i32(conv), q_out=i32(q_out),
            planes=u32(plane_fragments(conv, q, nd, alpha)), rowc=u32(rowc))

    def ks_tables(self, nl: int) -> LevelKS:
        if nl in self._ks:
            return self._ks[nl]
        tgt_idx = self.limb_idx(nl, specials=True)
        tgt_primes = [self.basis[i] for i in tgt_idx]
        ntgt = len(tgt_primes)
        P = _prod(self.ps)
        groups, dig_limbs = [], []
        fold_rows, gq_rows, conv_rows = [], [], []
        own = np.empty(nl, np.int64)
        for g_full in self.digit_groups_full():
            g = tuple(i for i in g_full if i < nl)
            if not g:
                continue
            F_j = _prod(q for i, q in enumerate(self.qs) if i not in g_full)
            qhat = _prod(self.qs[i] for i in g)
            for t in g:
                qt = self.qs[t]
                qhat_t = qhat // qt
                fold_rows.append(pow(F_j % qt, qt - 2, qt)
                                 * pow(qhat_t % qt, qt - 2, qt) % qt)
                gq_rows.append(qt)
                conv_rows.append([qhat_t % p for p in tgt_primes])
                own[t] = pow(F_j % qt, qt - 2, qt)
            pad = self.alpha - len(g)
            fold_rows += [0] * pad
            gq_rows += [1] * pad
            conv_rows += [[0] * ntgt] * pad
            groups.append(g)
            dig_limbs.append(tuple(-1 if i in g else i for i in tgt_idx))
        bc = self.bc_tables(len(groups), self.alpha, fold_rows, gq_rows,
                      conv_rows, tgt_primes)
        # mod-down tables: P -> active q basis
        qs_act = [int(q) for q in self.qs[:nl]]
        pfold = [pow((P // pt) % pt, pt - 2, pt) for pt in self.ps]
        pconv = [[(P // pt) % q for q in qs_act] for pt in self.ps]
        md = self.bc_tables(1, self.k_sp, pfold, list(self.ps), pconv, qs_act)
        mdq40 = np.asarray([(((1 << 41) // pt) + 1) >> 1 for pt in self.ps],
                           np.int64).reshape(-1, 1)
        assert int(mdq40.max()) < (1 << 16), \
            "special prime too small for the 2^40 mod-down fixed point"
        assert self.k_sp * max(self.ps) / float(1 << 41) < 0.25, \
            "mod-down overflow fixed point too coarse for this chain"
        col = lambda v: self.tensor(np.asarray(v, np.int64).reshape(-1, 1)
                                    .astype(np.int32))
        shoup = lambda v, q: self.tensor(np.ascontiguousarray(
            shoup_precompute(v, q).reshape(-1, 1)).view(np.int32))
        pinv = [pow(P % q, q - 2, q) for q in qs_act]
        pmod = [P % q for q in qs_act]
        act_idx = self.limb_idx(nl)
        sp_idx = tuple(range(self.num_q, self.num_q + self.k_sp))
        lk = LevelKS(
            nl=nl, tgt_idx=tgt_idx, act_idx=act_idx, sp_idx=sp_idx,
            groups=tuple(groups), dig_limbs=tuple(dig_limbs),
            q_act=self.mod(act_idx), q_tgt=self.mod(tgt_idx),
            q_sp=self.mod(sp_idx),
            pfold=col(pfold), pinv=col(pinv), pmod=col(pmod),
            pfold_s=shoup(pfold, self.ps), pinv_s=shoup(pinv, qs_act),
            pmod_s=shoup(pmod, qs_act),
            mdq40=self.tensor(mdq40),
            own=col(own),
            bc=bc, md=md)
        self._ks[nl] = lk
        return lk
