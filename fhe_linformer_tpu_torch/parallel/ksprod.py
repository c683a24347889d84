"""The production hybrid key switch with the RNS limbs sharded over the
mesh's `limb` axis, its cross-limb base conversions as collectives: the
counterpart of the JAX package's `parallel/ksprod.py`.

The extended basis (nl active q-limbs, then the k specials; T = nl + k
rows) is cut into `limb` blocks of per = T / limb rows, and each rank owns
one.  A Galois key switch on a rank's (per, N) block of the extended
ciphertext (special rows zero):

  1. the Galois permutation of c0 and c1          - row-local
  2. K2 (inverse NTT) of the local c1 rows         - row-local
  3. the digit decomposition y[j, p] = sum_t fold_t c1_t conv[t, j, p]:
     each rank's partial sum over its own rows, by K3 on tables that hold
     the rank's slice of each digit group (`RankKS.bc`), then ONE
     int64 sum-reduce-scatter into the rank's row block of every digit
  4. K1 of the rank's digit rows, the key inner products - row-local
  5. the mod-down P -> Q: K2 of the local special rows, the local partial
     conversion by K3 and a second reduce-scatter, the overflow
     estimate's integer partial sums all-reduced before its one float32
     combine (`ops.moddown.md_partials` / `md_round`, the single-process
     mod-down's plain route), K1, subtract, multiply by P^-1

The partial residues are canonical (< p), and the JAX package splits them
into 16-bit u32 planes for its lazy u32 psum; the port sums them in int64
(exact for any practical rank count) and reduces once.  Every step is
exact modular arithmetic and the overflow's integer sums add over
disjoint rows, so the result equals the single-process key switch bit for
bit.  The double-hoisted combo decomposes once, accumulates every
rotation's inner products and plaintext products locally, and runs one
mod-down pair.

These are plain functions that each rank calls on its row block; the
evaluator reaches them through `Evaluator.enable_sharded_ks`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext
from ..ckks.context import BCTables, Context
from ..ops import ntt
from ..ops.basecvt import base_convert
from ..ops.modarith import addmod, mulmod, submod
from ..ops.moddown import md_partials, md_round


@dataclass(frozen=True)
class ShardedKSPlan:
    """Host tables of one (ctx, nl, nshard) sharded key switch over the
    full extended basis (int64, the JAX plan's arrays and row order); each
    rank takes its row block (`rank_tables`)."""
    nl: int
    k_sp: int
    nd: int
    per: int                  # extended rows per rank
    tgt_idx: tuple            # basis index of each extended row
    gq_full: np.ndarray       # (T, 1) extended-basis primes
    fold: np.ndarray          # (T, 1) decomposition fold (0 on specials)
    conv: np.ndarray          # (T, R) digit conversion, R = nd * T
    pfold: np.ndarray         # (T, 1) mod-down fold (0 on active rows)
    pconv: np.ndarray         # (T, nl) mod-down conversion (0 on active)
    q_act_row: np.ndarray     # (nl, 1)
    pinv: np.ndarray          # (T, 1) P^-1 mod q (0 on specials)
    pmod: np.ndarray          # (T, 1) P mod q (0 on specials)
    mdq40: np.ndarray         # (T, 1) round(2^40 / p) (0 on active rows)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.int64)


def build_sharded_ks(ctx: Context, nl: int, nshard: int) -> ShardedKSPlan:
    """The plan from the single-process key-switch tables of level nl;
    needs (nl + k) % nshard == 0."""
    T = nl + ctx.k_sp
    if T % nshard:
        raise ValueError(f"basis rows {T} not divisible by {nshard}")
    ks = ctx.ks_tables(nl)
    nd, alpha = ks.bc.nd, ks.bc.alpha
    tgt = np.asarray([ctx.basis[i] for i in ks.tgt_idx], np.int64)
    bc_fold, bc_conv = _host(ks.bc.fold), _host(ks.bc.conv)
    fold = np.zeros((T, 1), np.int64)
    conv = np.zeros((T, nd * T), np.int64)
    for j, group in enumerate(ks.groups):
        for ti, t in enumerate(group):
            fold[t, 0] = bc_fold[j * alpha + ti]
            conv[t, j * T:(j + 1) * T] = bc_conv[j * alpha + ti]
    pfold = np.zeros((T, 1), np.int64)
    pconv = np.zeros((T, nl), np.int64)
    mdq40 = np.zeros((T, 1), np.int64)
    pfold[nl:] = _host(ks.pfold)
    pconv[nl:] = _host(ks.md.conv)
    mdq40[nl:] = _host(ks.mdq40)
    pinv = np.zeros((T, 1), np.int64)
    pmod = np.zeros((T, 1), np.int64)
    pinv[:nl] = _host(ks.pinv)
    pmod[:nl] = _host(ks.pmod)
    return ShardedKSPlan(
        nl=nl, k_sp=ctx.k_sp, nd=nd, per=T // nshard, tgt_idx=ks.tgt_idx,
        gq_full=tgt.reshape(-1, 1), fold=fold, conv=conv, pfold=pfold,
        pconv=pconv,
        q_act_row=tgt[:nl].reshape(-1, 1), pinv=pinv, pmod=pmod, mdq40=mdq40)


@dataclass(frozen=True)
class RankKS:
    """One rank's device tables of a sharded key switch: its rows [lo, lo +
    per) of the extended basis."""
    plan: ShardedKSPlan
    lo: int
    limbs: tuple              # basis index of each local row
    key_rows: torch.Tensor    # the local rows' rows in a full-basis key
    q: torch.Tensor           # (per, 1) int32
    bc: BCTables | None       # K3 tables of the local digit slices
    src: torch.Tensor | None  # (nd * alpha_l,) local row (per: zero) per K3 row
    sp0: int                  # first local special row (per: none)
    md: BCTables | None       # K3 tables of the local special rows
    pfold: torch.Tensor       # (per - sp0, 1) int32
    mdq40: torch.Tensor       # (per - sp0, 1) int64
    pmod: torch.Tensor        # (per, 1) int32
    pinv: torch.Tensor        # (per, 1) int32


def rank_tables(ctx: Context, plan: ShardedKSPlan, index: int) -> RankKS:
    """The tables of row block `index`.  The digit decomposition's K3
    tables keep, for each digit, the digit group's rows that fall in the
    block (alpha_l = the largest such slice, pad rows fold 0), so K3 gives
    each target prime's partial residue over the block; a block without
    active rows converts nothing (its partial is zero)."""
    nl, T, per = plan.nl, plan.nl + plan.k_sp, plan.per
    lo = index * per
    rows = range(lo, lo + per)
    i32 = lambda a: ctx.tensor(np.asarray(a, np.int64).astype(np.int32))
    ks = ctx.ks_tables(nl)
    slices = [[t for t in g if t in rows] for g in ks.groups]
    alpha_l = max(len(s) for s in slices)
    bc = src = None
    if alpha_l:
        nd = plan.nd
        fold = np.zeros(nd * alpha_l, np.int64)
        gq = np.ones(nd * alpha_l, np.int64)
        conv = np.zeros((nd * alpha_l, T), np.int64)
        idx = np.full(nd * alpha_l, per, np.int64)
        for j, s in enumerate(slices):
            for i, t in enumerate(s):
                g = j * alpha_l + i
                fold[g] = plan.fold[t, 0]
                gq[g] = plan.gq_full[t, 0]
                conv[g] = plan.conv[t, j * T:(j + 1) * T]
                idx[g] = t - lo
        bc = ctx.bc_tables(nd, alpha_l, fold, gq, conv, plan.gq_full[:, 0])
        src = ctx.tensor(idx)
    sp0 = max(nl, lo) - lo
    sp = slice(lo + sp0, lo + per)
    md = None
    if sp0 < per:
        md = ctx.bc_tables(1, per - sp0, plan.pfold[sp, 0],
                           plan.gq_full[sp, 0], plan.pconv[sp],
                           plan.q_act_row[:, 0])
    limbs = plan.tgt_idx[lo:lo + per]
    key_rows = [t if t < nl else ctx.num_q + t - nl for t in rows]
    return RankKS(
        plan=plan, lo=lo, limbs=limbs, key_rows=ctx.tensor(
            np.asarray(key_rows, np.int64)),
        q=i32(plan.gq_full[lo:lo + per]), bc=bc, src=src, sp0=sp0, md=md,
        pfold=i32(plan.pfold[sp]), mdq40=ctx.tensor(plan.mdq40[sp]),
        pmod=i32(plan.pmod[lo:lo + per]), pinv=i32(plan.pinv[lo:lo + per]))


def ext_block(rk: RankKS, c: torch.Tensor) -> torch.Tensor:
    """The rank's rows of a (nl, N) polynomial embedded in the extended
    basis with zero special rows."""
    nl, per, lo = rk.plan.nl, rk.plan.per, rk.lo
    if lo + per <= nl:
        return c[lo:lo + per]
    z = torch.zeros((lo + per - max(lo, nl), c.shape[-1]), dtype=c.dtype,
                    device=c.device)
    return torch.cat([c[lo:nl], z]) if lo < nl else z


def _decompose(ctx: Context, rk: RankKS, comm, c1_l) -> torch.Tensor:
    """Steps 2-4: the eval-domain digit rows (nd, per, N) of the rank's
    block, from its (per, N) rows of c1."""
    plan = rk.plan
    T, n = plan.nl + plan.k_sp, c1_l.shape[-1]
    if rk.bc is None:
        part = torch.zeros((plan.nd, T, n), dtype=torch.int64,
                           device=c1_l.device)
    else:
        w = ntt.inv(c1_l, ctx.ntt, rk.limbs)
        z = torch.zeros((1, n), dtype=w.dtype, device=w.device)
        part = base_convert(torch.cat([w, z]).index_select(0, rk.src),
                            rk.bc).long()
    yd = torch.remainder(comm.reduce_scatter(part, 1), rk.q).int()
    return ntt.fwd(yd, ctx.ntt, rk.limbs)


def _inner(y_e, k_l, q):
    """sum_j y_e[j] * k_l[j] mod q over the digits."""
    prod = torch.remainder(y_e.long() * k_l[:y_e.shape[0]], q)
    return torch.remainder(prod.sum(0), q).int()


def sharded_mod_down(ctx: Context, rk: RankKS, comm, acc, radd=None):
    """Step 5: the rank's (per, N) rows of the P -> Q mod-down of a
    limb-sharded accumulator, rounded by the overflow correction; `radd`
    (or None) is added to the active rows.  Special rows come out zero."""
    plan = rk.plan
    T, n = plan.nl + plan.k_sp, acc.shape[-1]
    z = lambda *s: torch.zeros(s, dtype=torch.int64, device=acc.device)
    if rk.md is None:
        al, ahbb, part = z(1, n), z(1, n), z(T, n)
    else:
        w = mulmod(ntt.inv(acc[rk.sp0:], ctx.ntt, rk.limbs[rk.sp0:]),
                   rk.pfold, rk.q[rk.sp0:])
        al, ahbb = md_partials(w, rk.mdq40)
        part = torch.cat([base_convert(w, rk.md, prefolded=True)[0].long(),
                          z(plan.k_sp, n)])
    ov = comm.all_reduce(torch.stack([al, ahbb]))
    v = md_round(ov[0], ov[1])
    yq = torch.remainder(comm.reduce_scatter(part, 0), rk.q).int()
    yq = submod(yq, mulmod(v, rk.pmod, rk.q), rk.q)   # pmod 0 on specials
    y_e = ntt.fwd(yq, ctx.ntt, rk.limbs)
    out = mulmod(submod(acc, y_e, rk.q), rk.pinv, rk.q)  # pinv 0 on specials
    return out if radd is None else addmod(out, radd, rk.q)


def sharded_galois(ctx: Context, rk: RankKS, comm, c0_l, c1_l, perm,
                   kb_l, ka_l):
    """One Galois key switch of the rank's extended rows (c0_l, c1_l):
    returns the rank's rows of (r0 + k0, k1).  kb_l/ka_l: the key's
    (ndig, per, N) halves at the rank's rows."""
    r0 = c0_l.index_select(-1, perm)
    y_e = _decompose(ctx, rk, comm, c1_l.index_select(-1, perm))
    return (sharded_mod_down(ctx, rk, comm, _inner(y_e, kb_l, rk.q), r0),
            sharded_mod_down(ctx, rk, comm, _inner(y_e, ka_l, rk.q)))


def sharded_combo(ctx: Context, rk: RankKS, comm, c0_l, c1_l, perms,
                  kbs_l, kas_l, coeffs):
    """sum_i pt_i * rotate_i of the rank's extended rows, decomposed once
    with one mod-down pair: perms/kbs_l/kas_l per rotation, coeffs the
    (R, N) int64 plaintext coefficients.  Returns the rank's rows of the
    un-rescaled (c0, c1)."""
    q = rk.q
    y_e = _decompose(ctx, rk, comm, c1_l)
    pts = ntt.fwd(torch.remainder(coeffs[:, None, :], q).int(), ctx.ntt,
                  rk.limbs)                                  # (R, per, N)
    a0q = a0e = a1e = torch.zeros_like(c0_l)
    for perm, kb, ka, pt in zip(perms, kbs_l, kas_l, pts):
        yp = y_e.index_select(-1, perm)
        a0q = addmod(a0q, mulmod(c0_l.index_select(-1, perm), pt, q), q)
        a0e = addmod(a0e, mulmod(_inner(yp, kb, q), pt, q), q)
        a1e = addmod(a1e, mulmod(_inner(yp, ka, q), pt, q), q)
    return (sharded_mod_down(ctx, rk, comm, a0e, a0q),
            sharded_mod_down(ctx, rk, comm, a1e))


def gather_rows(rk: RankKS, comm, o0_l, o1_l, scale: float) -> Ciphertext:
    """Every rank's output rows all-gathered into the (nl, N) ciphertext."""
    nl = rk.plan.nl
    out = comm.all_gather(torch.stack([o0_l, o1_l]), 1)[:, :nl]
    return Ciphertext(out[0], out[1], nl, scale)


# ----------------------------------------------------------------------
# parity checks: the sharded switch against the single-process one
# ----------------------------------------------------------------------

def _check_setup(mesh, n, num_scaling, dnum, seed, rng_seed, shifts, device,
                 ct):
    from ..ckks.context import CKKSConfig
    from ..ckks.evaluator import Evaluator
    from ..ckks.keys import generate_keys
    from ..convert import ciphertext_from_numpy
    cfg = CKKSConfig(n=n, scale_bits=26, num_scaling=num_scaling, dnum=dnum,
                     seed=seed)
    ctx = Context(cfg, device)
    nshard = mesh.shape["limb"]
    if (ctx.num_q + ctx.k_sp) % nshard:
        raise ValueError(f"basis rows {ctx.num_q + ctx.k_sp} not divisible "
                         f"by {nshard}")
    ev = Evaluator(ctx, generate_keys(ctx, rotations=tuple(shifts)))
    rng = np.random.default_rng(rng_seed)
    z = rng.uniform(-1, 1, cfg.slots)
    ct = ev.encrypt(z) if ct is None else ciphertext_from_numpy(ctx, *ct)
    return ctx, ev, rng, z, ct


def _timed(mesh, ev, fn, reps: int) -> dict:
    """Milliseconds per call of `fn` on this process alone (limb rank 0,
    the other ranks waiting) and on the mesh (every rank, the evaluator
    routed to it), each after one warm-up call and ending in a device
    synchronise, the bytes this rank handed to each collective per
    sharded call and the kernel launches of the sharded calls."""
    import torch.distributed as dist
    from ..utils.timing import COLLECTIVE_BYTES, launches_into

    def ms(fn):
        fn()
        if ev.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        if ev.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3
    out = {"single_ms": ms(fn) if mesh.coords["limb"] == 0 else None,
           "launches": {}}
    dist.barrier()
    ev.enable_sharded_ks(mesh)
    b0 = dict(COLLECTIVE_BYTES)
    with launches_into(out["launches"]):
        out["sharded_ms"] = ms(fn)
    ev.enable_sharded_ks(None)
    out["collective_bytes_per_switch"] = {
        k: (COLLECTIVE_BYTES[k] - b0[k]) / (reps + 1) for k in b0}
    return out


def _add(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in a.keys() | b.keys()}


def _equal(a: Ciphertext, b: Ciphertext) -> bool:
    return (a.nl, a.scale) == (b.nl, b.scale) and \
        torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)


def sharded_rotate_parity_check(mesh, n: int = 2048, num_scaling: int = 11,
                                dnum: int = 3, rot: int = 3,
                                via_evaluator: bool = False,
                                device=None, ct=None, reps: int = 0) -> dict:
    """Rotate by `rot` on the limb-sharded key switch and require it to
    equal the single-process Evaluator.rotate bit for bit; directly
    through `sharded_galois` or, with via_evaluator, through
    Evaluator.rotate after enable_sharded_ks.  `ct`: (c0, c1, nl, scale)
    arrays to rotate instead of a fresh encryption (the same on every
    rank).  Returns the output residues, the decrypted slots' max error
    against the rotated message and the kernel launches of the sharded
    calls alone (the single-process reference and set-up not counted);
    with `reps` and via_evaluator, also the single-process and sharded
    milliseconds per switch and the collective bytes per switch
    (`_timed`)."""
    from ..utils.timing import GLOBAL_TIMERS, launches_into
    ctx, ev, _, z, ct = _check_setup(mesh, n, num_scaling, dnum, 77, 5,
                                     (rot,), device, ct)
    want = ev.rotate(ct, rot)
    launches = {}
    if via_evaluator:
        before = GLOBAL_TIMERS.counts["keyswitch_sharded"]
        ev.enable_sharded_ks(mesh)
        with launches_into(launches):
            got = ev.rotate(ct, rot)
        ev.enable_sharded_ks(None)
        if GLOBAL_TIMERS.counts["keyswitch_sharded"] != before + 1:
            raise AssertionError("Evaluator.rotate did not take the sharded "
                                 "key switch")
    else:
        comm = mesh.comms["limb"]
        rk = rank_tables(ctx, build_sharded_ks(ctx, ct.nl, comm.size),
                         mesh.coords["limb"])
        key = ev._rot_key(rot)
        with launches_into(launches):
            o0, o1 = sharded_galois(
                ctx, rk, comm, ext_block(rk, ct.c0), ext_block(rk, ct.c1),
                ev._perm(rot), key.b.index_select(1, rk.key_rows),
                key.a.index_select(1, rk.key_rows))
            got = gather_rows(rk, comm, o0, o1, ct.scale)
    if not _equal(got, want):
        raise AssertionError("the sharded rotation differs from "
                             "Evaluator.rotate")
    dec = np.real(ev.decrypt(got))
    out = {"c0": got.c0, "c1": got.c1,
           "err": float(np.abs(dec - np.roll(z, -rot)).max())}
    if reps and via_evaluator:
        out.update(_timed(mesh, ev, lambda: ev.rotate(ct, rot), reps))
    out["launches"] = _add(launches, out.get("launches", {}))
    return out


def sharded_combo_parity_check(mesh, n: int = 2048, num_scaling: int = 11,
                               dnum: int = 3, shifts=(1, 2, 3),
                               via_evaluator: bool = False, device=None,
                               ct=None, reps: int = 0) -> dict:
    """The limb-sharded double-hoisted combo sum_j pt_j * rot_j(ct)
    against the single-process Evaluator.rotate_combo, bit for bit
    (directly, or through rotate_combo after enable_sharded_ks).  Returns
    the un-rescaled output residues and the rescaled decrypt's max error
    against the plaintext combination, and the kernel launches of the
    sharded calls alone, as the rotate check."""
    from ..utils.timing import GLOBAL_TIMERS, launches_into
    ctx, ev, rng, z, ct = _check_setup(mesh, n, num_scaling, dnum, 78, 6,
                                       shifts, device, ct)
    items = []
    want_slots = np.zeros(ctx.cfg.slots)
    for i, r in enumerate(shifts):
        d = rng.uniform(-1, 1, ctx.cfg.slots)
        items.append((r, ev.encode_coeff_cached(("combo_par", i), d)))
        want_slots = want_slots + d * np.roll(z, -r)
    want = ev.rotate_combo(ct, items)
    launches = {}
    if via_evaluator:
        before = GLOBAL_TIMERS.counts["keyswitch_sharded"]
        ev.enable_sharded_ks(mesh)
        with launches_into(launches):
            got = ev.rotate_combo(ct, items)
        ev.enable_sharded_ks(None)
        if GLOBAL_TIMERS.counts["keyswitch_sharded"] != before + 1:
            raise AssertionError("Evaluator.rotate_combo did not take the "
                                 "sharded key switch")
    else:
        comm = mesh.comms["limb"]
        rk = rank_tables(ctx, build_sharded_ks(ctx, ct.nl, comm.size),
                         mesh.coords["limb"])
        keys = [ev._rot_key(r) for r in shifts]
        with launches_into(launches):
            o0, o1 = sharded_combo(
                ctx, rk, comm, ext_block(rk, ct.c0), ext_block(rk, ct.c1),
                [ev._perm(r) for r in shifts],
                [k.b.index_select(1, rk.key_rows) for k in keys],
                [k.a.index_select(1, rk.key_rows) for k in keys],
                torch.stack([p.coeffs for _, p in items]))
            got = gather_rows(rk, comm, o0, o1,
                              ct.scale * items[0][1].scale)
    if not _equal(got, want):
        raise AssertionError("the sharded combo differs from "
                             "Evaluator.rotate_combo")
    dec = np.real(ev.decrypt(ev.rescale(got)))
    out = {"c0": got.c0, "c1": got.c1,
           "err": float(np.abs(dec - want_slots).max())}
    if reps and via_evaluator:
        out.update(_timed(mesh, ev, lambda: ev.rotate_combo(ct, items),
                          reps))
    out["launches"] = _add(launches, out.get("launches", {}))
    return out
