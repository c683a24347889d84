"""Homomorphic evaluation: encode/encrypt/decrypt, arithmetic, rescale,
rotations (plain, hoisted, accumulated and the double-hoisted combo) and
the hybrid key switch, on one device.

The counterpart of the JAX package's `ckks/evaluator.py`, computing what
its jitted cores compute (each returns canonical residues, so results are
bit-identical given the same inputs).  Running scale lives on the host
wrapper.  Batched ops (key switches, products, rescales) process at most
`heavy_chunk` ciphertexts at a time (the fused Chebyshev nodes
`fused_chunk`) to bound their intermediates (the key switch's ~12x the
ciphertext volume).  With `enable_sharded_ks`, an unbatched Galois key
switch or rotation combo runs limb-sharded over a mesh
(`parallel/ksprod.py`); with `enable_dp`, each batched key-switching op
runs its share of the batch on this rank of a dp mesh
(`parallel/circuit.py`).

Every key switch funnels through `_galois_many` or `_relin`: inverse NTT
of the input (kernel K2), digit decomposition by fused base conversion
(K3) and forward NTT of the digit rows (K1), the key inner products
(`_inner_ext`, kernel K4 `ks_mac`, which reads each key's own rows:
full-basis or reduced-basis, KSKey.max_nl), then the mod-down
(`ops/moddown.py`: K2, kernel K5's fold, K3 prefolded, K5's lift, K1 and
K5's finish, which adds the caller's c0 or d0 / d1 terms in the same
pass).  A hoisted rotation hands K4 its Galois permutation, which it reads
in place; the rotation combo's plaintext sums run on K4 too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.native import crt_lift_center
from ..ops import ntt
from ..ops.basecvt import base_convert
from ..ops.ksmac import ks_mac
from ..ops.moddown import mod_down
from ..ops.modarith import addmod, mulmod, negmod, submod
from ..ops.ntt import NttTables
from ..utils.timing import GLOBAL_TIMERS as _COUNTS
from .ciphertext import Ciphertext, CoeffPlaintext, Plaintext
from .context import Context, LevelKS, RescalePlan
from .encoding import Encoder
from .keys import KeySet, KSKey


def _nct(ct: Ciphertext) -> int:
    """Ciphertext count of a batched ct."""
    return int(np.prod(ct.c0.shape[:-2], dtype=np.int64))


def _run_chunks(core, flat, chunk: int):
    """core over consecutive chunks of at most `chunk` rows of the
    flattened operands, each chunk's outputs written into the whole batch's
    as it ends (so the chunks' outputs and their concatenation are never
    held at once)."""
    n = flat[0].shape[0]
    if n <= chunk:
        return core(*flat)
    outs = None
    for s in range(0, n, chunk):
        part = core(*(f[s: s + chunk] for f in flat))
        if outs is None:
            outs = tuple(o.new_empty((n,) + o.shape[1:]) for o in part)
        for o, p in zip(outs, part):
            o[s: s + p.shape[0]] = p
        del part
    return outs


class Evaluator:
    """`heavy_chunk`: ciphertexts per key-switching call; `fused_chunk`:
    the same for the fused Chebyshev nodes (None: heavy_chunk)."""

    def __init__(self, ctx: Context, keys: KeySet, heavy_chunk: int = 8,
                 fused_chunk: int | None = None):
        self.ctx = ctx
        self.keys = keys
        self.heavy_chunk = heavy_chunk
        self.fused_chunk = fused_chunk or heavy_chunk
        self.encoder = Encoder(ctx.cfg.n)
        self._enc_rng = np.random.default_rng(ctx.cfg.seed ^ 0x5EED)
        self._enc_cache: dict = {}
        self._host_ntt: dict[int, NttTables] = {}
        self._sk_host: torch.Tensor | None = None
        self._baby_stack = None
        self._slotdec_cache: dict = {}
        self._shard_mesh = None
        self._shard_ks: dict = {}
        self._dp = None

    def prefetch_host_sk(self) -> None:
        """Keep a host copy of the secret key's eval-domain residues, so
        decrypt_host works after release_device_keys()."""
        if self._sk_host is None and self.keys is not None \
                and self.keys.sk is not None:
            self._sk_host = self.keys.sk.eval_full.cpu()

    def release_device_keys(self) -> None:
        """Drop every key the evaluator holds (the host secret key is
        copied first): afterwards only decrypt_host works, and any key
        consuming op raises."""
        self.prefetch_host_sk()
        self.keys = None
        self._baby_stack = None

    # ------------------------------------------------------------------
    # encode / encrypt / decrypt
    # ------------------------------------------------------------------

    def _spread(self, coeffs: torch.Tensor, limbs) -> torch.Tensor:
        """(..., N) int64 coefficients -> (..., L, N) int32 residues."""
        return torch.remainder(coeffs[..., None, :], self.ctx.mod(limbs)).int()

    def encode(self, values, nl: int | None = None, scale: float | None = None,
               batch: bool = False, specials: bool = False) -> Plaintext:
        """Slot values -> eval-domain plaintext at (nl, scale).  `specials`
        encodes over the extended basis (nl actives, then the special
        primes): only the rotation combo consumes such plaintexts."""
        ctx = self.ctx
        nl = ctx.num_q if nl is None else nl
        scale = ctx.delta if scale is None else scale
        vals = np.atleast_2d(np.asarray(values)) if batch else \
            np.asarray(values)[None]
        coeffs = np.stack([self.encoder.encode(v, scale) for v in vals])
        limbs = ctx.limb_idx(nl, specials=specials)
        data = ntt.fwd(self._spread(ctx.tensor(coeffs), limbs), ctx.ntt, limbs)
        return Plaintext(data if batch else data[0], nl, scale)

    def cached(self, key, make, holds=None):
        """make() memoized in the plaintext cache by a caller-supplied
        stable key.  A key that names an object by id() passes the object
        as `holds`: the entry keeps it alive, so its id cannot pass to
        another object while the entry lives."""
        if key not in self._enc_cache:
            self._enc_cache[key] = (holds, make())
        return self._enc_cache[key][1]

    def encode_cached(self, key, values, nl: int | None = None,
                      scale: float | None = None, specials: bool = False,
                      holds=None, batch: bool = False) -> Plaintext:
        """encode() memoized by a caller-supplied stable key (`holds` as
        for cached)."""
        return self.cached(
            (key, nl, scale, specials) + (("batch",) if batch else ()),
            lambda: self.encode(values, nl=nl, scale=scale, batch=batch,
                                specials=specials), holds)

    def encode_coeff_cached(self, key, values, scale: float | None = None,
                            holds=None) -> CoeffPlaintext:
        """Level-independent plaintext (scaled int64 coefficients on the
        device), memoized by a caller-supplied stable key (`holds` as for
        cached)."""
        sc = self.ctx.delta if scale is None else scale
        return self.cached(
            (key, float(scale) if scale is not None else None, "coeff"),
            lambda: CoeffPlaintext(self.ctx.tensor(self.encoder.encode(
                np.asarray(values), sc)), sc), holds)

    def encode_coeff_many(self, rows, scale: float | None = None
                          ) -> list[CoeffPlaintext]:
        """Level-independent plaintexts of the rows of `rows` (R, <=
        slots), uncached, the transforms on the device
        (Encoder.encode_many)."""
        sc = self.ctx.delta if scale is None else scale
        coeffs = self.encoder.encode_many(rows, sc, self.ctx.device)
        return [CoeffPlaintext(c, sc) for c in coeffs]

    def encode_const(self, c: float, nl: int | None = None,
                     scale: float | None = None) -> Plaintext:
        """Constant-in-all-slots plaintext as an (nl, 1) broadcast (a
        constant polynomial is constant in the eval domain)."""
        ctx = self.ctx
        nl = ctx.num_q if nl is None else nl
        scale = ctx.delta if scale is None else scale
        v = int(round(c * scale))
        assert abs(v) < 1 << 62
        qs = np.asarray([ctx.basis[i] for i in ctx.limb_idx(nl)], np.int64)
        res = (np.int64(v) % qs).reshape(-1, 1).astype(np.int32)
        return Plaintext(ctx.tensor(res), nl, scale)

    def encrypt(self, values=None, pt: Plaintext | None = None,
                nl: int | None = None, scale: float | None = None,
                batch: bool = False) -> Ciphertext:
        """Public-key encryption.  The noise (v ternary, e0/e1 rounded
        Gaussians) is sampled on the device from a torch.Generator seeded
        by the same host draw the JAX package seeds its threefry with."""
        ctx = self.ctx
        if pt is None:
            pt = self.encode(values, nl, scale, batch)
        nl = pt.nl
        limbs = ctx.limb_idx(nl)
        q = ctx.mod(limbs)
        n = ctx.cfg.n
        shape = tuple(pt.data.shape[:-2]) + (n,)
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(int(self._enc_rng.integers(0, 2 ** 31)))
        sigma = float(ctx.cfg.sigma)
        v = torch.randint(0, 3, shape, generator=gen, device=ctx.device) - 1
        e0, e1 = (torch.round(sigma * torch.randn(
            shape, generator=gen, device=ctx.device, dtype=torch.float64)
        ).long() for _ in range(2))
        v_e, e0_e, e1_e = (ntt.fwd(self._spread(x, limbs), ctx.ntt, limbs)
                           for x in (v, e0, e1))
        pk = self._require_keys("encrypt").pk
        c0 = addmod(addmod(mulmod(pk.p0[:nl], v_e, q), e0_e, q), pt.data, q)
        c1 = addmod(mulmod(pk.p1[:nl], v_e, q), e1_e, q)
        return Ciphertext(c0, c1, nl, pt.scale)

    def decrypt(self, ct: Ciphertext, crt_limbs: int = 3) -> np.ndarray:
        """Decrypt + decode to complex slot values (batched): m_eval and
        its inverse NTT on the device, then the centered CRT lift of the
        first crt_limbs limbs and the decode on the host in float64."""
        ct = self.drop_to(ct, min(ct.nl, max(crt_limbs, 1)))
        coeffs = self._coeff_residues(ct, "decrypt").cpu().numpy()
        return self._decode(coeffs, ct, min(crt_limbs, ct.nl))

    def _coeff_residues(self, ct: Ciphertext, what: str) -> torch.Tensor:
        """The coefficient residues of c0 + c1*s over ct's limbs, on the
        device (the inverse NTT is K2 on a CUDA tensor)."""
        ctx = self.ctx
        sk = self._require_keys(what).sk
        if sk is None:
            raise RuntimeError(f"{what} needs the secret key")
        limbs = ctx.limb_idx(ct.nl)
        q = ctx.mod(limbs)
        m_eval = addmod(ct.c0, mulmod(ct.c1, sk.eval_full[: ct.nl], q), q)
        return ntt.inv(m_eval, ctx.ntt, limbs)

    def decrypt_host(self, ct: Ciphertext, crt_limbs: int = 3) -> np.ndarray:
        """decrypt() entirely on the host: the first crt_limbs rows are
        copied to the CPU and reduced there with the plain NTT."""
        m = min(crt_limbs, ct.nl)
        if m not in self._host_ntt:
            self._host_ntt[m] = NttTables(self.ctx.cfg.n, self.ctx.qs[:m],
                                          "cpu")
        t = self._host_ntt[m]
        c0 = ct.c0[..., :m, :].cpu()
        c1 = ct.c1[..., :m, :].cpu()
        self.prefetch_host_sk()
        if self._sk_host is None:
            raise RuntimeError("decrypt_host needs the secret key")
        s = self._sk_host[:m]
        q = t.q.view(-1, 1)
        coeffs = ntt.inv_plain(addmod(c0, mulmod(c1, s, q), q), t,
                               tuple(range(m)))
        return self._decode(coeffs.numpy(), ct, m)

    def decrypt_slots_device(self, ct: Ciphertext, slot_idx,
                             crt_limbs: int = 3) -> np.ndarray:
        """Decrypt and decode only the slots `slot_idx`, on the device:
        float32 (*batch, len(slot_idx)), the only copy to the host.

        Exact integers until the decode: m = c0 + c1*s over the first m =
        min(crt_limbs, nl) limbs, its inverse NTT (K2 on a CUDA tensor),
        then the JAX package's centred CRT without big integers
        (`_crt_low_and_carry`, bit for bit): t_i = r_i*(Q/q_i)^-1 mod q_i,
        the overflow k = round(sum t_i/q_i) in float32 (exact while
        |x| << Q), the low word y = x mod 2^32 = sum t_i*U_i - k*(Q mod
        2^32) and the carry c = (r_0 - y)*2^-32 mod q_0, centred in
        integers.  The decode is a float32 product of three planes of x =
        lo + 2^16 hi + 2^32 c with the requested rows of the inverse
        canonical embedding (cos(pi*j*5^s/n)), in true float32 (TF32 would
        lose 10 bits: it raises unless torch.get_float32_matmul_precision()
        is "highest").

        The planes are balanced (`_balanced_planes`: lo and hi in
        [-2^15, 2^15]), unlike the JAX package's unsigned 16-bit halves of
        y, where a small negative coefficient is 65535 in hi16 and -1 in
        the carry: those planes' dot products cancel, and their float32
        rounding, scaled by 2^16 and 2^32, cost 0.153 per slot against the
        host decrypt on config 5's output (n = 2^15, scale 2^25.9, an
        H100; the JAX package's own record is 0.032 at S = 700).
        Balanced, the error is about sqrt(n)*2^-24*|x|_rms/scale: 2e-8
        there, 8e-8 at n = 256 where the JAX split gives 2.3e-4
        (tests/test_torch_slot_decrypt.py).  Still a check of a run, never
        the parity number: that is decrypt_host's float64 decode."""
        m = min(crt_limbs, ct.nl)
        ct = self.drop_to(ct, m)
        r = self._coeff_residues(ct, "decrypt_slots_device")
        key = (m, tuple(int(i) for i in slot_idx))
        if key not in self._slotdec_cache:
            self._slotdec_cache[key] = _slot_tables(self.ctx, self.encoder,
                                                    *key)
        out = _slots_from_residues(r, self.ctx.mod(self.ctx.limb_idx(m)),
                                   self._slotdec_cache[key], 1.0 / ct.scale)
        return out.cpu().numpy()

    def _decode(self, coeffs: np.ndarray, ct: Ciphertext, m: int):
        """The centered CRT lift of the first m limbs of every ciphertext's
        coefficient residues in one call of the native lifter
        (io/native.py), then the float64 decode of each."""
        sub = coeffs[..., :m, :]
        flat = np.moveaxis(sub, -2, 0).reshape(m, -1)
        ints = crt_lift_center(flat, self.ctx.qs[:m])
        out = np.stack([self.encoder.decode(c, ct.scale)
                        for c in ints.reshape(-1, self.ctx.cfg.n)])
        return out.reshape(*ct.batch_shape, self.ctx.cfg.slots)

    def _require_keys(self, what: str) -> KeySet:
        if self.keys is None:
            raise RuntimeError(
                f"{what} needs keys, but the evaluator holds none (none "
                "given, or release_device_keys() was called): only "
                "decrypt_host() works")
        return self.keys

    # -- debug probes (they decrypt: the caller holds the secret key) -----

    def probe(self, ct: Ciphertext, count: int = 8) -> np.ndarray:
        return np.real(self.decrypt(ct))[..., :count]

    def probe_expanded(self, ct: Ciphertext, stride: int,
                       count: int = 8) -> np.ndarray:
        """Slot j*stride for j < count (the expanded layout's values)."""
        return np.real(self.decrypt_host(ct))[..., : count * stride: stride]

    def probe_padded(self, ct: Ciphertext, padding: int,
                     count: int = 8) -> np.ndarray:
        """Every `padding`-th slot."""
        return np.real(self.decrypt_host(ct))[..., : count * padding: padding]

    def probe_min_max(self, ct: Ciphertext) -> tuple[float, float]:
        """(min, max) over the real slots."""
        vals = np.real(self.decrypt_host(ct))
        return float(vals.min()), float(vals.max())

    # ------------------------------------------------------------------
    # arithmetic and level/scale management
    # ------------------------------------------------------------------

    def drop_to(self, ct: Ciphertext, nl: int) -> Ciphertext:
        """Modulus reduction by dropping limbs (free: slicing)."""
        if ct.nl == nl:
            return ct
        assert nl < ct.nl
        return ct.with_data(ct.c0[..., :nl, :], ct.c1[..., :nl, :], nl=nl)

    def _align(self, a: Ciphertext, b: Ciphertext):
        nl = min(a.nl, b.nl)
        a = self.drop_to(a, nl)
        b = self.drop_to(b, nl)
        assert abs(a.scale / b.scale - 1.0) < 1e-9, \
            f"scale mismatch {a.scale} vs {b.scale}: adjust first"
        return a, b

    def adjust(self, ct: Ciphertext, nl: int, scale: float) -> Ciphertext:
        """Bring ct to exactly (nl, scale), spending one level on a
        unit-constant multiply unless already matching."""
        if ct.nl == nl and abs(ct.scale / scale - 1.0) < 1e-9:
            return ct
        assert ct.nl > nl, f"cannot raise level {ct.nl} -> {nl}"
        ct = self.drop_to(ct, nl + 1)
        if abs(ct.scale / scale - 1.0) < 1e-9:
            return self.drop_to(ct, nl)
        qd = float(self.ctx.qs[nl])
        pt = self.encode_const(1.0, nl + 1, scale * qd / ct.scale)
        out = self.mul_plain(ct, pt, rescale=True)
        out.scale = scale  # exact by construction; avoid float drift
        return out

    def match(self, a: Ciphertext, b: Ciphertext):
        """Bring two ciphertexts to a common exact (nl, scale), spending at
        most one level on whichever branches need it."""
        if a.nl == b.nl:
            if abs(a.scale / b.scale - 1.0) < 1e-9:
                return a, b
            nl = a.nl - 1
            s = self.ctx.delta
            return self.adjust(a, nl, s), self.adjust(b, nl, s)
        if a.nl > b.nl:
            return self.adjust(a, b.nl, b.scale), b
        return a, self.adjust(b, a.nl, a.scale)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        a, b = self._align(a, b)
        q = self.ctx.mod(self.ctx.limb_idx(a.nl))
        return a.with_data(addmod(a.c0, b.c0, q), addmod(a.c1, b.c1, q))

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        a, b = self._align(a, b)
        q = self.ctx.mod(self.ctx.limb_idx(a.nl))
        return a.with_data(submod(a.c0, b.c0, q), submod(a.c1, b.c1, q))

    def add_many(self, cts: list[Ciphertext]) -> Ciphertext:
        out = cts[0]
        for ct in cts[1:]:
            out = self.add(out, ct)
        return out

    def neg(self, ct: Ciphertext) -> Ciphertext:
        q = self.ctx.mod(self.ctx.limb_idx(ct.nl))
        return ct.with_data(negmod(ct.c0, q), negmod(ct.c1, q))

    def _pt_to(self, pt: Plaintext, nl: int) -> Plaintext:
        if pt.nl == nl:
            return pt
        assert nl < pt.nl
        return Plaintext(pt.data[..., :nl, :], nl, pt.scale)

    def add_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        pt = self._pt_to(pt, ct.nl)
        assert abs(ct.scale / pt.scale - 1.0) < 1e-9
        q = self.ctx.mod(self.ctx.limb_idx(ct.nl))
        return ct.with_data(addmod(ct.c0, pt.data, q), ct.c1)

    def sub_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        pt = self._pt_to(pt, ct.nl)
        assert abs(ct.scale / pt.scale - 1.0) < 1e-9
        q = self.ctx.mod(self.ctx.limb_idx(ct.nl))
        return ct.with_data(submod(ct.c0, pt.data, q), ct.c1)

    def mul_plain(self, ct: Ciphertext, pt: Plaintext,
                  rescale: bool = True) -> Ciphertext:
        _COUNTS.count("ctpt_mult", _nct(ct))
        pt = self._pt_to(pt, ct.nl)
        nl = ct.nl
        q = self.ctx.mod(self.ctx.limb_idx(nl))
        plan = self.ctx.rescale_tables(nl) if rescale else None
        p = pt.data

        def core(a0, a1, b=p):
            c0, c1 = mulmod(a0, b, q), mulmod(a1, b, q)
            return (c0, c1) if plan is None else \
                _rescale_body(self.ctx, c0, c1, plan)
        # a batched plaintext rides the batch
        c0, c1 = self._batched(core, (ct.c0, ct.c1) + ((p,) if p.dim() > 2
                                                       else ()),
                               keyswitches=0)
        scale = ct.scale * pt.scale
        if plan is None:
            return ct.with_data(c0, c1, scale=scale)
        _COUNTS.count("rescale", int(np.prod(c0.shape[:-2], dtype=np.int64)))
        return Ciphertext(c0, c1, nl - 1, scale / float(self.ctx.qs[nl - 1]))

    def mul_scalar_int(self, ct: Ciphertext, k: int) -> Ciphertext:
        """Multiply by a small integer (scale unchanged, message *= k)."""
        limbs = self.ctx.limb_idx(ct.nl)
        kv = np.asarray([k % self.ctx.basis[i] for i in limbs],
                        np.int64).reshape(-1, 1).astype(np.int32)
        kt = self.ctx.tensor(kv)
        q = self.ctx.mod(limbs)
        return ct.with_data(mulmod(ct.c0, kt, q), mulmod(ct.c1, kt, q))

    def mul_scalar(self, ct: Ciphertext, x: float,
                   rescale: bool = True) -> Ciphertext:
        """Multiply by a real scalar via an integer at the working scale."""
        qd = self.ctx.qs[ct.nl - 1]
        out = self.mul_scalar_int(ct, int(round(x * qd)))
        out.scale = ct.scale * qd
        return self.rescale(out) if rescale else out

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """Drop the top limb; scale /= q_dropped (FLEXIBLEAUTO tracking)."""
        nl = ct.nl
        assert nl >= 2, "no scaling limb left to drop"
        _COUNTS.count("rescale", _nct(ct))
        plan = self.ctx.rescale_tables(nl)
        c0, c1 = self._batched(
            lambda a0, a1: _rescale_body(self.ctx, a0, a1, plan),
            (ct.c0, ct.c1), keyswitches=0)
        return Ciphertext(c0, c1, nl - 1, ct.scale / float(self.ctx.qs[nl - 1]))

    def _batched(self, core, arrays, chunk: int | None = None,
                 keyswitches: int = 1):
        """core(*arrays) over chunks of at most `chunk` (heavy_chunk)
        ciphertexts of the broadcast leading batch (operands are broadcast
        first), so a large batch never holds the whole batch's
        temporaries.  `keyswitches`: the key switches core runs per
        ciphertext, counted here for the ciphertexts this process runs.
        Under enable_dp a key-switching op (keyswitches > 0) whose batch
        gives every dp rank at least one ciphertext is cut into one
        contiguous block per rank: this rank runs its block and the blocks
        are all-gathered, so every rank returns the whole result (each
        ciphertext's ops are independent of the others', so it equals the
        single-process result bit for bit).  An op without a key switch
        runs its chunks on every rank: gathering its output would cost more
        than computing it."""
        chunk = chunk or self.heavy_chunk
        shape = torch.broadcast_shapes(*(a.shape[:-2] for a in arrays))
        count = int(np.prod(shape, dtype=np.int64))
        dp = self._dp
        per = count if dp is None else -(-count // dp.size)
        if dp is None or keyswitches == 0 or (dp.size - 1) * per >= count:
            _COUNTS.count("keyswitch", keyswitches * count)
            # a key-switching core takes one batch axis, the others any
            if count <= chunk and (len(shape) <= 1 or keyswitches == 0):
                return core(*arrays)
            flat = [a.expand(shape + a.shape[-2:])
                    .reshape((count,) + a.shape[-2:]) for a in arrays]
            return tuple(o.reshape(shape + o.shape[-2:])
                         for o in _run_chunks(core, flat, chunk))
        lo, hi = dp.rank * per, min((dp.rank + 1) * per, count)
        _COUNTS.count("keyswitch", keyswitches * (hi - lo))
        flat = [a.expand(shape + a.shape[-2:])
                .reshape((count,) + a.shape[-2:])[lo:hi] for a in arrays]
        outs = torch.stack(_run_chunks(core, flat, chunk))    # (k, hi-lo, ...)
        if hi - lo < per:
            outs = torch.cat([outs, outs.new_zeros(
                (outs.shape[0], per - (hi - lo)) + outs.shape[2:])], 1)
        full = dp.all_gather(outs, 1)[:, :count]
        return tuple(o.reshape(shape + o.shape[-2:]) for o in full)

    def enable_dp(self, mesh) -> None:
        """Run the heavy batched ops (ct x ct products, the Chebyshev nodes,
        Galois key switches, accumulated rotations) split over `mesh`'s dp
        axis (None: off).  Every rank must run the same ops on the same
        (replicated) ciphertexts."""
        self._dp = None if mesh is None else mesh.comms["dp"]

    def mul(self, a: Ciphertext, b: Ciphertext,
            rescale: bool = True) -> Ciphertext:
        """ct x ct with relinearization."""
        a, b = self._align_mult(a, b)
        _COUNTS.count("ctct_mult", _nct(a))
        ks = self.ctx.ks_tables(a.nl)
        relin = self._require_keys("mul/relin").relin
        c0, c1 = self._batched(
            lambda a0, a1, b0, b1: _mul_relin_core(self.ctx, a0, a1, b0, b1,
                                                   relin, ks),
            (a.c0, a.c1, b.c0, b.c1))
        out = Ciphertext(c0, c1, a.nl, a.scale * b.scale)
        return self.rescale(out) if rescale else out

    def square(self, a: Ciphertext, rescale: bool = True) -> Ciphertext:
        return self.mul(a, a, rescale)

    def _align_mult(self, a: Ciphertext, b: Ciphertext):
        nl = min(a.nl, b.nl)
        return self.drop_to(a, nl), self.drop_to(b, nl)

    def mul_double_sub(self, a: Ciphertext, b: Ciphertext, c: Ciphertext,
                       wide: bool = False) -> Ciphertext:
        """2*a*b - c (the Chebyshev T_{a+b} node): relinearized product,
        doubling, rescale (two with `wide`, the paired working scale), and
        c's scale-matched subtraction.  c must sit at least one level above
        the output."""
        ctx = self.ctx
        a, b = self._align_mult(a, b)
        nl = a.nl
        _COUNTS.count("ctct_mult", _nct(a))
        s_prod = a.scale * b.scale
        if wide:
            nl_out = nl - 2
            s_out = s_prod / float(ctx.qs[nl - 1]) / float(ctx.qs[nl - 2])
        else:
            nl_out = nl - 1
            s_out = s_prod / float(ctx.qs[nl - 1])
        _COUNTS.count("rescale", (3 if wide else 2) * _nct(a))
        assert c.nl >= nl_out + 1, (c.nl, nl_out)
        c = self.drop_to(c, nl_out + 1)
        # c's scale-matching constant (the inlined `adjust`)
        v_c = int(round(s_out * float(ctx.qs[nl_out]) / c.scale))
        assert 0 < v_c < 1 << 62
        limbs_c = ctx.limb_idx(nl_out + 1)
        qs_c = np.asarray([ctx.basis[i] for i in limbs_c],
                          np.int64).reshape(-1, 1)
        vc = ctx.tensor((v_c % qs_c).astype(np.int32))
        ks = ctx.ks_tables(nl)
        relin = self._require_keys("mul/relin").relin
        plans = [ctx.rescale_tables(m) for m in range(nl, nl_out, -1)]
        plan_c = ctx.rescale_tables(nl_out + 1)
        qc = ctx.mod(limbs_c)

        def core(a0, a1, b0, b1, e0, e1):
            c0, c1 = _mul2_tail(ctx, a0, a1, b0, b1, relin, ks)
            for plan in plans:
                c0, c1 = _rescale_body(ctx, c0, c1, plan)
            f0, f1 = _rescale_body(ctx, mulmod(e0, vc, qc),
                                   mulmod(e1, vc, qc), plan_c)
            return submod(c0, f0, plan_c.qrem), submod(c1, f1, plan_c.qrem)
        c0, c1 = self._batched(core, (a.c0, a.c1, b.c0, b.c1, c.c0, c.c1),
                               self.fused_chunk)
        return Ciphertext(c0, c1, nl_out, s_out)

    def square_double_minus_one(self, a: Ciphertext,
                                wide: bool = False) -> Ciphertext:
        """2*a^2 - 1 (the Chebyshev T_{2m} node): relinearized square,
        doubling, rescale (two with `wide`) and the -1."""
        ctx = self.ctx
        nl = a.nl
        _COUNTS.count("ctct_mult", _nct(a))
        _COUNTS.count("rescale", (2 if wide else 1) * _nct(a))
        ks = ctx.ks_tables(nl)
        relin = self._require_keys("mul/relin").relin
        s_prod = a.scale * a.scale
        if wide:
            assert nl >= 3
            s_out = s_prod / float(ctx.qs[nl - 1]) / float(ctx.qs[nl - 2])
            nl_out = nl - 2
        else:
            assert nl >= 2
            s_out = s_prod / float(ctx.qs[nl - 1])
            nl_out = nl - 1
        plans = [ctx.rescale_tables(m) for m in range(nl, nl_out, -1)]
        qs = np.asarray([ctx.basis[i] for i in ctx.limb_idx(nl_out)], np.int64)
        v = int(round(s_out))
        assert 0 < v < 1 << 62
        m1 = ctx.tensor(((-v) % qs).reshape(-1, 1).astype(np.int32))

        def core(a0, a1):
            c0, c1 = _mul2_tail(ctx, a0, a1, a0, a1, relin, ks)
            for plan in plans:
                c0, c1 = _rescale_body(ctx, c0, c1, plan)
            return addmod(c0, m1, plans[-1].qrem), c1
        c0, c1 = self._batched(core, (a.c0, a.c1), self.fused_chunk)
        return Ciphertext(c0, c1, nl_out, s_out)

    # ------------------------------------------------------------------
    # rotations
    # ------------------------------------------------------------------

    def _rot_key(self, r: int) -> KSKey:
        slots = self.ctx.cfg.slots
        rot = self._require_keys("rotate").rot
        key = rot.get(r % slots) or rot.get(r % slots - slots)
        assert key is not None, f"no rotation key for shift {r}"
        return key

    def _perm(self, r: int) -> torch.Tensor:
        return self.ctx.galois_perm(self.ctx.galois_t(r % self.ctx.cfg.slots))

    def has_rotation_keys(self, shifts) -> bool:
        """True when every shift has a dedicated rotation key."""
        if self.keys is None:
            return False
        slots = self.ctx.cfg.slots
        for r in shifts:
            rr = r % slots
            if rr and rr not in self.keys.rot and \
                    (rr - slots) not in self.keys.rot:
                return False
        return True

    def rotate(self, ct: Ciphertext, r: int) -> Ciphertext:
        """Cyclic slot rotation: out slot j = in slot (j + r) mod slots."""
        if r % self.ctx.cfg.slots == 0:
            return ct
        return self._galois(ct, self._perm(r), self._rot_key(r))

    def conjugate(self, ct: Ciphertext) -> Ciphertext:
        """Complex conjugation of every slot (the automorphism X -> X^-1)."""
        ck = self._require_keys("conjugate").conj
        assert ck is not None, "no conjugation key"
        return self._galois(ct, self.ctx.galois_perm(self.ctx.conj_t()), ck)

    def _galois(self, ct: Ciphertext, perm, key: KSKey) -> Ciphertext:
        _COUNTS.count("rotation", _nct(ct))
        out = self._galois_sharded(ct, perm, key)
        if out is not None:
            return out
        ks = self.ctx.ks_tables(ct.nl)
        c0, c1 = self._batched(
            lambda a0, a1: _galois_core(self.ctx, a0, a1, perm, key, ks),
            (ct.c0, ct.c1))
        return ct.with_data(c0, c1)

    def rotate_any(self, ct: Ciphertext, r: int) -> Ciphertext:
        """Rotate by r, composing from available keys when no dedicated key
        exists (signed binary over the +/- power-of-two set)."""
        slots = self.ctx.cfg.slots
        rr = r % slots
        if rr == 0:
            return ct
        if self.has_rotation_keys([rr]):
            return self.rotate(ct, rr)
        for step in self._compose_shifts(rr):
            ct = self.rotate(ct, step)
        return ct

    def _compose_shifts(self, rr: int) -> list[int]:
        """The shorter of the binary expansions of rr and rr - slots whose
        every step has a key."""
        slots = self.ctx.cfg.slots
        best = None
        for v in (rr, rr - slots):
            steps, x, b = [], abs(v), 0
            sgn = 1 if v > 0 else -1
            while x:
                if x & 1:
                    steps.append(sgn * (1 << b))
                x >>= 1
                b += 1
            if self.has_rotation_keys(steps) and \
                    (best is None or len(steps) < len(best)):
                best = steps
        assert best is not None, f"cannot compose rotation {rr}"
        return best

    def rotate_accumulate_tree(self, ct: Ciphertext, shifts) -> Ciphertext:
        """ct := ct + rotate(ct, s) sequentially over `shifts` (the
        rotsum/repeat log-trees).  Needs a dedicated key per shift."""
        ctx = self.ctx
        live = [s for s in shifts if s % ctx.cfg.slots != 0]
        if not live:
            return ct
        _COUNTS.count("rotation", len(live) * _nct(ct))
        steps = [(self._perm(s), self._rot_key(s)) for s in live]
        ks = ctx.ks_tables(ct.nl)
        q = ks.q_act

        def core(c0, c1):
            for perm, key in steps:
                o0, o1 = _galois_core(ctx, c0, c1, perm, key, ks)
                c0, c1 = addmod(c0, o0, q), addmod(c1, o1, q)
            return c0, c1
        c0, c1 = self._batched(core, (ct.c0, ct.c1), keyswitches=len(live))
        return ct.with_data(c0, c1)

    def multi_rotate_stack(self, ct: Ciphertext, shifts) -> Ciphertext:
        """[rotate(ct, r) for r in shifts] stacked on a new leading axis,
        with ONE hoisted decomposition shared by every rotation (each
        rotation permutes the decomposed digits; dedicated keys only)."""
        ctx = self.ctx
        _COUNTS.count("keyswitch", len(shifts) * _nct(ct))
        _COUNTS.count("rotation_hoisted", len(shifts) * _nct(ct))
        ks = ctx.ks_tables(ct.nl)
        y_e = _hoist_decompose(ctx, ct.c1, ks)
        acc = y_e.new_empty((2, len(shifts)) + y_e.shape[1:])
        c0ps = []
        for i, r in enumerate(shifts):
            perm = self._perm(r)
            c0ps.append(ct.c0.index_select(-1, perm))
            _inner_ext(ctx, y_e, self._rot_key(r), ks, perm, out=acc[:, i])
        k = _mod_down(ctx, acc, ks, add=(torch.stack(c0ps), None))
        return ct.with_data(k[0], k[1])                 # (S, ..., nl, N) each

    def multi_rotate_sum(self, cts: Ciphertext, shifts) -> Ciphertext:
        """sum_g rotate(cts[g], shifts[g]); shift-0 entries skip the switch
        and are added directly."""
        ctx = self.ctx
        slots = ctx.cfg.slots
        ks = ctx.ks_tables(cts.nl)
        rot_idx = [i for i, r in enumerate(shifts) if r % slots != 0]
        id_idx = [i for i, r in enumerate(shifts) if r % slots == 0]
        out = None
        if rot_idx:
            one = cts.with_data(cts.c0[0], cts.c1[0])
            _COUNTS.count("keyswitch", len(rot_idx) * _nct(one))
            perms = [self._perm(shifts[i]) for i in rot_idx]
            keys = [self._rot_key(shifts[i]) for i in rot_idx]
            o0, o1 = _galois_many(ctx, cts.c0[rot_idx], cts.c1[rot_idx],
                                  perms, keys, ks)
            q = ks.q_act
            acc0, acc1 = o0[0], o1[0]
            for g in range(1, len(rot_idx)):
                acc0, acc1 = addmod(acc0, o0[g], q), addmod(acc1, o1[g], q)
            out = one.with_data(acc0, acc1)
        for i in id_idx:
            t = cts.with_data(cts.c0[i], cts.c1[i])
            out = t if out is None else self.add(out, t)
        return out

    def rotate_hoisted(self, ct: Ciphertext, rots) -> dict:
        """{r: rotate(ct, r)} with the key-switch decomposition of ct.c1
        computed once and permuted per shift (multi_rotate_stack).  Needs
        a dedicated key per shift."""
        slots = self.ctx.cfg.slots
        rots = list(rots)
        live = [r for r in rots if r % slots]
        out = {r: ct for r in rots if r % slots == 0}
        if live:
            stk = self.multi_rotate_stack(ct, live)
            out.update({r: stk.with_data(stk.c0[i], stk.c1[i])
                        for i, r in enumerate(live)})
        return {r: out[r] for r in rots}

    # ------------------------------------------------------------------
    # double-hoisted rotation combo (BSGS engine)
    # ------------------------------------------------------------------

    def hoist_decompose(self, ct: Ciphertext, ks: LevelKS) -> torch.Tensor:
        """The key-switch decomposition of ct.c1, shared by every rotation
        of a BSGS transform."""
        return _hoist_decompose(self.ctx, ct.c1, ks)

    def rotate_combo(self, ct: Ciphertext, items) -> Ciphertext:
        """sum_j pt_j * rotate(ct, r_j) with one decomposition and one lazy
        mod-down of the accumulated inner products (double hoisting).
        items: [(shift, plaintext)], the plaintexts CoeffPlaintexts or
        encode(..., specials=True) eval plaintexts at a common scale.
        Returns the un-rescaled sum at scale ct.scale * pt.scale."""
        out = self._combo_sharded(ct, items)
        if out is not None:
            return out
        ks = self.ctx.ks_tables(ct.nl)
        return self.combo_from_decomp(ct, _hoist_decompose(self.ctx, ct.c1, ks),
                                      items, ks)

    # ------------------------------------------------------------------
    # the limb-sharded key switch (parallel/ksprod.py)
    # ------------------------------------------------------------------

    def enable_sharded_ks(self, mesh) -> None:
        """Route Galois key switches and rotation combos through the
        limb-sharded key switch over `mesh`'s limb axis (None: off).  Every
        rank of the limb axis must run the same ops on the same (replicated)
        ciphertexts.  The JAX package's conditions apply: an unbatched
        ciphertext, an extended basis (nl + k) that divides the limb axis,
        full-basis keys, coefficient plaintexts and no identity term; any
        other switch runs on this process alone, as there."""
        self._shard_mesh = mesh
        self._shard_ks = {}

    def _rank_ks(self, nl: int):
        from ..parallel.ksprod import build_sharded_ks, rank_tables
        if nl not in self._shard_ks:
            mesh = self._shard_mesh
            self._shard_ks[nl] = rank_tables(
                self.ctx, build_sharded_ks(self.ctx, nl, mesh.shape["limb"]),
                mesh.coords["limb"])
        return self._shard_ks[nl]

    def _shardable(self, ct: Ciphertext) -> bool:
        return self._shard_mesh is not None and ct.c0.dim() == 2 and \
            (ct.nl + self.ctx.k_sp) % self._shard_mesh.shape["limb"] == 0

    def _galois_sharded(self, ct: Ciphertext, perm, key: KSKey):
        """One unbatched Galois key switch on the limb mesh, or None when
        it cannot ride it."""
        if not self._shardable(ct) or key.max_nl is not None:
            return None
        from ..parallel.ksprod import ext_block, gather_rows, sharded_galois
        rk = self._rank_ks(ct.nl)
        comm = self._shard_mesh.comms["limb"]
        _COUNTS.count("keyswitch")
        _COUNTS.count("keyswitch_sharded")
        o0, o1 = sharded_galois(
            self.ctx, rk, comm, ext_block(rk, ct.c0), ext_block(rk, ct.c1),
            perm, key.b.index_select(1, rk.key_rows),
            key.a.index_select(1, rk.key_rows))
        return gather_rows(rk, comm, o0, o1, ct.scale)

    def _combo_sharded(self, ct: Ciphertext, items):
        """rotate_combo on the limb mesh, or None when the ciphertext or the
        items cannot ride it (coefficient plaintexts at one scale, no
        identity term, full-basis keys)."""
        if not self._shardable(ct) or self.keys is None:
            return None
        slots = self.ctx.cfg.slots
        if not all(isinstance(p, CoeffPlaintext) and r % slots != 0
                   for r, p in items):
            return None
        keys = [self._rot_key(r) for r, _ in items]
        if any(k.max_nl is not None for k in keys):
            return None
        from ..parallel.ksprod import ext_block, gather_rows, sharded_combo
        scale = items[0][1].scale
        for _, p in items:
            assert abs(p.scale / scale - 1.0) < 1e-12
        _COUNTS.count("combo_rot", len(items))
        _COUNTS.count("keyswitch")
        _COUNTS.count("keyswitch_sharded")
        rk = self._rank_ks(ct.nl)
        comm = self._shard_mesh.comms["limb"]
        o0, o1 = sharded_combo(
            self.ctx, rk, comm, ext_block(rk, ct.c0), ext_block(rk, ct.c1),
            [self._perm(r) for r, _ in items],
            [k.b.index_select(1, rk.key_rows) for k in keys],
            [k.a.index_select(1, rk.key_rows) for k in keys],
            torch.stack([p.coeffs for _, p in items]))
        return gather_rows(rk, comm, o0, o1, ct.scale * scale)

    def combo_from_decomp(self, ct: Ciphertext, y_e, items,
                          ks: LevelKS) -> Ciphertext:
        """rotate_combo with a caller-held decomposition y_e of ct.c1."""
        nl = ct.nl
        slots = self.ctx.cfg.slots
        rot_items = [(r, p) for r, p in items if r % slots != 0]
        id_items = [(r, p) for r, p in items if r % slots == 0]
        scale = items[0][1].scale
        out = None
        if rot_items:
            _COUNTS.count("combo_rot", len(rot_items) * _nct(ct))
            _COUNTS.count("keyswitch", _nct(ct))         # the one mod-down
            for _, p in rot_items:
                assert abs(p.scale / scale - 1.0) < 1e-12
            stage1 = self.combo_stage1(ct, y_e, [r for r, _ in rot_items], ks)
            a0q, a01 = self._stage2_sums(
                stage1, list(range(len(rot_items))),
                [p for _, p in rot_items], ks)
            k = _mod_down(self.ctx, a01, ks, add=(a0q, None))
            out = Ciphertext(k[0], k[1], nl, ct.scale * scale)
        for _, p in id_items:
            pq = self._pt_expand_q(p, ks) if isinstance(p, CoeffPlaintext) \
                else Plaintext(p.data[..., :nl, :], nl, p.scale)
            t = self.mul_plain(ct, pq, rescale=False)
            out = t if out is None else self.add(out, t)
        return out

    def baby_key_stack(self, shifts, nl: int):
        """(kb, ka): the rotation keys of `shifts` stacked, each (ndig,
        nl + k, N) rows of level nl (actives, then specials; each key's own
        rows, so full-basis and reduced-basis keys mix), cached for the
        last (shifts, nl) asked."""
        key = (tuple(shifts), nl)
        if self._baby_stack is not None and self._baby_stack[0] == key:
            return self._baby_stack[1]
        ctx = self.ctx
        kbs, kas = [], []
        for r in shifts:
            k = self._rot_key(r)
            sp = k.sp_row(ctx, nl)
            rows = torch.tensor([*range(nl), *range(sp, sp + ctx.k_sp)],
                                device=ctx.device)
            kbs.append(k.b.index_select(1, rows))
            kas.append(k.a.index_select(1, rows))
        val = (torch.stack(kbs), torch.stack(kas))
        self._baby_stack = (key, val)
        return val

    def combo_stage1(self, ct: Ciphertext, y_e, shifts, ks: LevelKS):
        """Per-baby work shared by every giant group: the Galois
        permutation of (c0, y_e) and the extended-basis key inner products.
        Returns (c0p, t01): c0p (S, ..., nl, N) and t01 (S, 2, ..., nl + k,
        N), the two key halves' products, with a row per shift."""
        c0ps = []
        t01 = y_e.new_empty((len(shifts), 2) + y_e.shape[1:])
        for i, r in enumerate(shifts):
            perm = self._perm(r)
            c0ps.append(ct.c0.index_select(-1, perm))
            _inner_ext(self.ctx, y_e, self._rot_key(r), ks, perm, out=t01[i])
        return torch.stack(c0ps), t01

    def _pt_expand_q(self, p: CoeffPlaintext, ks: LevelKS) -> Plaintext:
        """Coefficient plaintext -> eval rows over the active Q basis."""
        data = ntt.fwd(self._spread(p.coeffs, ks.act_idx), self.ctx.ntt,
                       ks.act_idx)
        return Plaintext(data, ks.nl, p.scale)

    def _ext_rows(self, pts, ks: LevelKS) -> torch.Tensor:
        """(R, nl + k, N) eval rows over Q u P of the plaintexts `pts`:
        coefficient plaintexts spread and transformed (counted in
        `pt_rows`, one per residue row made), extended-basis eval
        plaintexts (encode(..., specials=True)) as they are."""
        if isinstance(pts[0], CoeffPlaintext):
            _COUNTS.count("pt_rows", len(pts) * len(ks.tgt_idx))
            coeffs = torch.stack([p.coeffs for p in pts])
            return ntt.fwd(self._spread(coeffs, ks.tgt_idx), self.ctx.ntt,
                           ks.tgt_idx)
        for p in pts:
            assert p.data.shape[-2] == len(ks.tgt_idx), \
                "rotation-combo plaintexts need encode(..., specials=True)"
        return torch.stack([p.data for p in pts])

    def _stage2_sums(self, stage1, idx, pts, ks: LevelKS, out=None,
                     out0=None):
        """Plaintext-weighted sums of stage-1 rows `idx` for one giant
        group: (a0 over Q, the t0 and t1 sums over Q u P stacked), written
        into `out0` (..., nl, N) and `out` (2, ..., nl + k, N) when
        given."""
        c0ps, t01 = stage1
        pt = (self._ext_rows(pts, ks),)           # (R, nl + k, N) weights
        wrap = lambda o: None if o is None else o[None]
        return (ks_mac(c0ps, pt, ks.q_act, sel=idx, out=wrap(out0))[0],
                ks_mac(t01, pt, ks.q_tgt, sel=idx, out=wrap(out))[0])

    def combo_stage2(self, ct: Ciphertext, stage1, items, shifts,
                     ks: LevelKS) -> Ciphertext:
        """One giant group's accumulation over stage-1 rows + a single lazy
        mod-down.  items: (shift, CoeffPlaintext)."""
        nl = ct.nl
        slots = self.ctx.cfg.slots
        pos = {r: i for i, r in enumerate(shifts)}
        rot_items = [(r, p) for r, p in items if r % slots != 0]
        id_items = [(r, p) for r, p in items if r % slots == 0]
        scale = items[0][1].scale
        out = None
        if rot_items:
            _COUNTS.count("combo_rot", len(rot_items) * _nct(ct))
            _COUNTS.count("keyswitch", _nct(ct))
            for _, p in rot_items:
                assert abs(p.scale / scale - 1.0) < 1e-12
            a0q, a01 = self._stage2_sums(
                stage1, [pos[r] for r, _ in rot_items],
                [p for _, p in rot_items], ks)
            k = _mod_down(self.ctx, a01, ks, add=(a0q, None))
            out = Ciphertext(k[0], k[1], nl, ct.scale * scale)
        for _, p in id_items:
            t = self.mul_plain(ct, self._pt_expand_q(p, ks), rescale=False)
            out = t if out is None else self.add(out, t)
        return out

    def combo_stage2_all(self, ct: Ciphertext, stage1, groups, shifts,
                         ks: LevelKS):
        """Every giant group's accumulation and ONE batched mod-down.
        groups: list of (giant_shift, [(baby_shift, CoeffPlaintext)]);
        identity-baby terms fold in after the mod-down.  Returns
        (giant_shifts, Ciphertext with a leading group axis)."""
        ctx = self.ctx
        slots = ctx.cfg.slots
        pos = {r: i for i, r in enumerate(shifts)}
        scale = groups[0][1][0][1].scale
        c0ps, t01 = stage1
        a01 = t01.new_empty((len(groups),) + t01.shape[1:])  # (G, 2, ...)
        a0q = c0ps.new_empty((len(groups),) + c0ps.shape[1:])
        id_extra = []
        n_rot = 0
        for g, (_, items) in enumerate(groups):
            rot = []
            for r, p in items:
                assert abs(p.scale / scale - 1.0) < 1e-12
                if r % slots == 0:
                    id_extra.append((g, p))
                else:
                    rot.append((r, p))
            n_rot += len(rot)
            if rot:
                self._stage2_sums(stage1, [pos[r] for r, _ in rot],
                                  [p for _, p in rot], ks, out=a01[g],
                                  out0=a0q[g])
            else:
                a0q[g].zero_()
                a01[g].zero_()
        _COUNTS.count("combo_rot", n_rot * _nct(ct))
        _COUNTS.count("keyswitch", len(groups) * _nct(ct))      # G mod-downs
        k = _mod_down(ctx, a01, ks, add=(a0q, None), half_dim=1)
        c0, c1 = k[:, 0], k[:, 1]   # (G, ..., nl, N), each c[g] contiguous
        for g, p in id_extra:
            t = self.mul_plain(ct, self._pt_expand_q(p, ks), rescale=False)
            c0[g] = addmod(c0[g], t.c0, ks.q_act)
            c1[g] = addmod(c1[g], t.c1, ks.q_act)
        return ([gs for gs, _ in groups],
                Ciphertext(c0, c1, ct.nl, ct.scale * scale))


# ----------------------------------------------------------------------
# key-switch and rescale cores (plain functions on tensors)
# ----------------------------------------------------------------------

def _rescale_body(ctx: Context, c0, c1, plan: RescalePlan):
    """Drop limb nl-1 of (c0, c1) with a centered lift: out = (c - lift(v))
    * qd^-1 over the remaining limbs, v the dropped limb's coefficients."""
    nl = plan.nl
    x = torch.stack((c0, c1))
    v = ntt.inv(x[..., nl - 1:, :], ctx.ntt, (nl - 1,))
    vm = torch.remainder(v, plan.qrem)
    lift = torch.where(v <= plan.half, vm, submod(vm, plan.qdm, plan.qrem))
    lift_e = ntt.fwd(lift, ctx.ntt, ctx.limb_idx(nl - 1))
    out = mulmod(submod(x[..., : nl - 1, :], lift_e, plan.qrem), plan.inv,
                 plan.qrem)
    return out[0], out[1]


def _ks_decompose(ctx: Context, cx_coeff, ks: LevelKS, cx_eval):
    """Digit-decompose + base-convert + NTT: returns the eval-domain digit
    stack (nd, ..., nl + k, N).  Digit j's rows at its own group limbs skip
    the NTT: fast base conversion is exact at the source primes, so those
    rows are F_j^-1 * cx_eval."""
    y = ntt.fwd(base_convert(cx_coeff, ks.bc), ctx.ntt, ks.dig_limbs)
    own_e = mulmod(cx_eval, ks.own, ks.q_act)      # the rows fwd skipped
    for j, g in enumerate(ks.groups):
        y[j, ..., g[0]:g[-1] + 1, :] = own_e[..., g[0]:g[-1] + 1, :]
    return y


def _hoist_decompose(ctx: Context, c1, ks: LevelKS):
    return _ks_decompose(ctx, ntt.inv(c1, ctx.ntt, ks.act_idx), ks, c1)


def _inner_ext(ctx: Context, y_e, key: KSKey, ks: LevelKS, perm=None,
               out=None):
    """Key-digit inner products over the extended basis Q u P (the mod-down
    is the caller's) of the digits y_e (nd, ..., nl + k, N), Galois-permuted
    by `perm` when given: (2, ..., nl + k, N), the key's b and a halves,
    written into `out` when given.  The key's rows are read in place:
    actives [0, nl) and the specials block, which starts at row num_q of a
    full-basis key and at row max_nl of a reduced-basis one (a level above
    max_nl raises)."""
    nl = ks.nl
    return ks_mac(y_e, (key.b, key.a), ks.q_tgt, split=nl,
                  w_off=key.sp_row(ctx, nl) - nl, perm=perm, out=out)


def _mod_down(ctx: Context, x, ks: LevelKS, add=None, half_dim: int = 0):
    """(..., nl + k, N) over Q*P -> (..., nl, N) over Q: divide by P,
    rounded (centered by the overflow correction), with the key halves on
    `half_dim` and `add` (add0, add1) added to them (`ops/moddown.py`)."""
    return mod_down(x, ctx.ntt, ks, add, half_dim)


def _galois_many(ctx: Context, c0s, c1s, perms, keys, ks: LevelKS):
    """Independent Galois key switches of cts[g] by (perms[g], keys[g]),
    batched through one decomposition and one mod-down.  Each ct is
    permuted BEFORE its decomposition (not hoisted)."""
    r0 = torch.stack([c.index_select(-1, p) for c, p in zip(c0s, perms)])
    r1 = torch.stack([c.index_select(-1, p) for c, p in zip(c1s, perms)])
    y_e = _hoist_decompose(ctx, r1, ks)              # (nd, G, ..., tgt, N)
    acc = y_e.new_empty((2,) + y_e.shape[1:])
    for g, key in enumerate(keys):
        _inner_ext(ctx, y_e[:, g], key, ks, out=acc[:, g])
    k = _mod_down(ctx, acc, ks, add=(r0, None))       # (2, G, ..., nl, N)
    return k[0], k[1]


def _galois_core(ctx: Context, c0, c1, perm, key: KSKey, ks: LevelKS):
    o0, o1 = _galois_many(ctx, c0[None], c1[None], [perm], [key], ks)
    return o0[0], o1[0]


def _relin(ctx: Context, d2, relin: KSKey, ks: LevelKS, add=None):
    """The relinearization key switch of d2, `add` (d0, d1) added to its
    halves in the mod-down's last pass."""
    y_e = _hoist_decompose(ctx, d2, ks)
    k = _mod_down(ctx, _inner_ext(ctx, y_e, relin, ks), ks, add=add)
    return k[0], k[1]


def _mul_relin_core(ctx: Context, a0, a1, b0, b1, relin: KSKey, ks: LevelKS):
    q = ks.q_act
    d0 = mulmod(a0, b0, q)
    d1 = addmod(mulmod(a0, b1, q), mulmod(a1, b0, q), q)
    return _relin(ctx, mulmod(a1, b1, q), relin, ks, add=(d0, d1))


def _mul2_tail(ctx: Context, a0, a1, b0, b1, relin: KSKey, ks: LevelKS):
    """Relinearized product, doubled (head of the Chebyshev nodes)."""
    q = ks.q_act
    c0, c1 = _mul_relin_core(ctx, a0, a1, b0, b1, relin, ks)
    return addmod(c0, c0, q), addmod(c1, c1, q)


# ----------------------------------------------------------------------
# the on-device slot decode
# ----------------------------------------------------------------------

def _slot_tables(ctx: Context, encoder: Encoder, m: int, slot_idx):
    """The constants of decrypt_slots_device over the first m limbs:
    (Q/q_i)^-1 mod q_i, U_i = (Q/q_i) mod 2^32, Q mod 2^32, 2^-32 mod q_0
    (int64) and the requested rows of the inverse canonical embedding
    (float32 (k, n))."""
    qs = [int(x) for x in ctx.qs[:m]]
    big_q = 1
    for x in qs:
        big_q *= x
    as_col = lambda v: ctx.tensor(np.asarray(v, np.int64).reshape(-1, 1))
    n = ctx.cfg.n
    kf = encoder.k_fwd[np.asarray(slot_idx, np.int64)]
    j = np.arange(n, dtype=np.float64)
    # slot_s = sum_j x_j * cos(pi * j * (2 k_fwd[s] + 1) / n) / scale
    rows = np.cos(np.pi * np.outer(2 * kf + 1, j) / n).astype(np.float32)
    return (as_col([pow(big_q // qi, -1, qi) for qi in qs]),
            as_col([(big_q // qi) % (1 << 32) for qi in qs]),
            big_q % (1 << 32), pow((1 << 32) % qs[0], -1, qs[0]),
            ctx.tensor(rows))


def _crt_low_and_carry(r, q, tab):
    """(t, k, y, c), int64: x = y + 2^32 c is the centred CRT lift of the
    coefficient residues r (..., m, n), with t_i = r_i (Q/q_i)^-1 mod q_i,
    the overflow count k, the low word y = x mod 2^32 in [0, 2^32) and
    the carry c centred in (-q_0/2, q_0/2].  The JAX package's u32
    wraparound is int64 arithmetic masked to 32 bits (products < 2^62)."""
    inv_t, u_i, uq, inv32 = tab[:4]
    mask = 0xFFFFFFFF
    t = mulmod(r, inv_t, q).long()
    qf = q.float()
    frac = t[..., 0, :].float() / qf[0]
    for i in range(1, t.shape[-2]):              # the JAX sum's order
        frac = frac + t[..., i, :].float() / qf[i]
    k = torch.round(frac).long()
    y = ((t * u_i) & mask).sum(-2) & mask
    y = (y - ((k * uq) & mask)) & mask
    q0 = q[0].long()
    d = submod(r[..., 0, :].long(), y % q0, q0)
    c = (d * inv32) % q0
    return t, k, y, torch.where(c > q0 // 2, c - q0, c)


def _balanced_planes(y, c):
    """(lo, hi, c') int64 with x = y + 2^32 c = lo + 2^16 hi + 2^32 c',
    lo and hi in [-2^15, 2^15]: y taken as a signed word (c' = c + 1
    where y >= 2^31, so c' = 0 for |x| < 2^31), then split in balanced
    16-bit digits."""
    top = y >= 1 << 31
    ys = torch.where(top, y - (1 << 32), y)
    lo = ((ys + (1 << 15)) & 0xFFFF) - (1 << 15)
    return lo, (ys - lo) >> 16, c + top.long()


def _slots_from_residues(r, q, tab, scale_inv: float):
    """The requested slots (..., k) float32 from coefficient residues
    (..., m, n): the decode of x's balanced planes in float32."""
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "decrypt_slots_device needs true float32 products, but "
            "torch.get_float32_matmul_precision() is "
            f"{torch.get_float32_matmul_precision()!r}")
    rows = tab[4]
    _, _, y, c = _crt_low_and_carry(r, q, tab)
    planes = torch.stack([p.float() for p in _balanced_planes(y, c)])
    dots = planes @ rows.T                       # (3, ..., k)
    v = dots[0] + 65536.0 * dots[1] + 4294967296.0 * dots[2]
    return v * float(np.float32(scale_inv))
