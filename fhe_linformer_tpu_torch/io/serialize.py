"""Ciphertext checkpoints and the keystore, in the JAX package's format, so
files cross between the two packages in both directions.

Ciphertext file: MAGIC, a u32 header length, a JSON header {"nl", "scale",
"shape", "pages"}, then the pages.  "native" pages (what this package
writes, through the host codec `io/native.py`) live in a sidecar
`<path>.pages`: a u64 count, the u32 residues of c0 then c1, and the CRC-32
of those bytes.  "inline" pages (read only) follow the header as two blobs,
c0 then c1, each a u32 ndim, ndim int64 dimensions and the u32 residues.
`read_pages` is the plain numpy and zlib reader of the sidecar.

Keystore: a directory of npz files, `public.npz` (p0, p1), `relin.npz`,
`rot_<shift>.npz`, `conj.npz` and, unless withheld, `secret.npz`.  A
key-switch key holds `b` and either `a` or, compressed, the seed `a_seed`
that regenerates `a`, and a reduced-basis key (KSKey.max_nl) its
`max_nl`.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

from ..ckks.ciphertext import Ciphertext
from ..ckks.context import Context
from ..ckks.keys import KeySet, KSKey, PublicKey, SecretKey, \
    seeded_uniform_eval
from . import native

MAGIC = b"FHETPU01"


def _u32(t) -> np.ndarray:
    return np.ascontiguousarray(t.cpu().numpy().astype(np.uint32))


def _read_blob(f) -> np.ndarray:
    ndim = struct.unpack("<I", f.read(4))[0]
    shape = struct.unpack(f"<{ndim}q", f.read(8 * ndim))
    n = int(np.prod(shape))
    return np.frombuffer(f.read(4 * n), np.uint32).reshape(shape)


def read_pages(path: str) -> np.ndarray:
    """A native sidecar page file -> its u32 residues, CRC-32 checked (the
    plain version of `native.read_blob`)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 12:
        raise IOError(f"short page file {path}")
    n = struct.unpack("<Q", raw[:8])[0]
    if len(raw) != 12 + 4 * n:
        raise IOError(f"page file {path}: {len(raw)} bytes for {n} pages")
    body = raw[8: 8 + 4 * n]
    if zlib.crc32(body) != struct.unpack("<I", raw[8 + 4 * n:])[0]:
        raise IOError(f"crc mismatch in {path}")
    return np.frombuffer(body, np.uint32)


def save_ciphertext(path: str, ct: Ciphertext):
    """The header at `path`, the residues as native pages at
    `path + ".pages"`."""
    c0, c1 = _u32(ct.c0), _u32(ct.c1)
    meta = {"nl": ct.nl, "scale": ct.scale, "shape": list(c0.shape),
            "pages": "native"}
    if not native.write_blob(path + ".pages",
                             np.concatenate([c0.reshape(-1), c1.reshape(-1)])):
        raise IOError(f"cannot write {path}.pages")
    with open(path, "wb") as f:
        f.write(MAGIC)
        hdr = json.dumps(meta).encode()
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)


def load_ciphertext(path: str, ctx: Context) -> Ciphertext:
    """Either layout, onto ctx's device."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path} is not a ciphertext file")
        ln = struct.unpack("<I", f.read(4))[0]
        meta = json.loads(f.read(ln))
        if meta.get("pages") == "native":
            flat = native.read_blob(path + ".pages")
            half = flat.size // 2
            shape = tuple(meta["shape"])
            c0, c1 = flat[:half].reshape(shape), flat[half:].reshape(shape)
        else:
            c0, c1 = _read_blob(f), _read_blob(f)
    res = lambda a: ctx.tensor(a.astype(np.int32))
    return Ciphertext(res(c0), res(c1), int(meta["nl"]), float(meta["scale"]))


def save_keys(dirpath: str, keys: KeySet, include_secret: bool = False,
              compress: bool = True):
    """Writes the keystore; with `compress`, keys that carry their seed
    store it in place of the `a` halves."""
    os.makedirs(dirpath, exist_ok=True)
    np.savez(os.path.join(dirpath, "public.npz"), p0=_u32(keys.pk.p0),
             p1=_u32(keys.pk.p1))

    def _save(name, k):
        path = os.path.join(dirpath, name)
        extra = {} if k.max_nl is None else \
            {"max_nl": np.asarray(k.max_nl, np.int64)}
        if compress and k.a_seed is not None:
            np.savez(path, b=_u32(k.b), a_seed=np.asarray(k.a_seed, np.int64),
                     **extra)
        else:
            np.savez(path, b=_u32(k.b), a=_u32(k.a), **extra)

    _save("relin.npz", keys.relin)
    for r, k in keys.rot.items():
        _save(f"rot_{r}.npz", k)
    if keys.conj is not None:
        _save("conj.npz", keys.conj)
    if include_secret and keys.sk is not None:
        np.savez(os.path.join(dirpath, "secret.npz"), coeffs=keys.sk.coeffs,
                 eval_full=_u32(keys.sk.eval_full))


def load_keys(dirpath: str, ctx: Context) -> KeySet:
    """The keystore onto ctx's device; compressed keys regenerate their
    `a` halves over ctx's basis: the full extended basis, or a
    reduced-basis key's q-limbs [0, max_nl) and the specials."""
    res = lambda a: ctx.tensor(np.asarray(a).astype(np.int32))

    def _ksk(name):
        z = np.load(os.path.join(dirpath, name))
        max_nl = int(z["max_nl"]) if "max_nl" in z else None
        rows = ctx.limb_idx(ctx.num_q if max_nl is None else max_nl,
                            specials=True)
        ndig, nlimb, n = z["b"].shape
        if nlimb != len(rows) or n != ctx.cfg.n:
            raise ValueError(f"{name} holds ({nlimb}, {n}) rows, the context "
                             f"({len(rows)}, {ctx.cfg.n}) for max_nl "
                             f"{max_nl}")
        if "a" in z:
            return KSKey(res(z["b"]), res(z["a"]), max_nl=max_nl)
        seed = tuple(int(v) for v in z["a_seed"])
        a = seeded_uniform_eval(seed, [ctx.basis[i] for i in rows], ndig, n)
        return KSKey(res(z["b"]), res(a), seed, max_nl)

    zp = np.load(os.path.join(dirpath, "public.npz"))
    pk = PublicKey(res(zp["p0"]), res(zp["p1"]))
    relin = _ksk("relin.npz")
    rot = {int(fn[4:-4]): _ksk(fn) for fn in sorted(os.listdir(dirpath))
           if fn.startswith("rot_")}
    conj = _ksk("conj.npz") if os.path.exists(
        os.path.join(dirpath, "conj.npz")) else None
    sk = None
    sp = os.path.join(dirpath, "secret.npz")
    if os.path.exists(sp):
        z = np.load(sp)
        sk = SecretKey(z["coeffs"], res(z["eval_full"]))
    return KeySet(sk, pk, relin, rot, conj)
