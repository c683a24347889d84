"""The port's fused digit fold + fast base conversion
(fhe_linformer_tpu_torch.ops.basecvt) against the JAX package's Pallas
kernel in interpret mode and its XLA loop, bit-exact: the decomposition
(Q_l -> Q_l u P) at every level nl = num_q ... 1, including partly filled
last digit groups, and the prefolded mod-down conversion (P -> Q_l).

Same ring and chain as the JAX package's own test (n = 2^11, num_scaling
7, dnum 3).  The port's CUDA kernel K3 is held against this plain version
on the card by chip_smoke.py; `base_convert_planes_plain` repeats K3's
int8 digit-plane arithmetic from the port's fragment tables and is held
against both here, also with the production chain's 20-limb digits."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fhe_linformer_tpu.ckks import CKKSConfig as JConfig, Context as JContext
from fhe_linformer_tpu.ops import basecvt as jbc
from fhe_linformer_tpu.ops import modarith as jma
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ops import basecvt

PARAMS = dict(n=1 << 11, scale_bits=26, num_scaling=7, dnum=3)


@pytest.fixture(scope="module")
def ctxs():
    torch.set_num_threads(2)
    return JContext(JConfig(**PARAMS)), Context(CKKSConfig(**PARAMS),
                                                device="cpu")


def _xla_decompose(cx, ks):
    ys = []
    for dg in ks.digits:
        lo = dg.group[0]
        w = jma.shoup_mulmod(cx[..., lo: lo + len(dg.group), :],
                             dg.fold, dg.fold_s, dg.gq)
        y = None
        for ti in range(len(dg.group)):
            term = jma.shoup_mulmod(w[..., ti: ti + 1, :], dg.conv[ti],
                                    dg.conv_s[ti], ks.q_tgt)
            y = term if y is None else jma.addmod(y, term, ks.q_tgt)
        ys.append(y)
    return np.asarray(jnp.stack(ys))


def _pallas_decompose(cx, ks):
    pad = ks.bc.fold.shape[0] - cx.shape[-2]
    xp = jnp.concatenate([cx, jnp.zeros(cx.shape[:-2] + (pad,) +
                                        cx.shape[-1:], jnp.uint32)], axis=-2)
    return np.asarray(jbc.base_convert(xp, ks.bc, interpret=True))


def _port(x, bc, prefolded=False):
    out = basecvt.base_convert(torch.from_numpy(x.astype(np.int32)), bc,
                               prefolded=prefolded)
    assert out.dtype == torch.int32
    return out.numpy().astype(np.uint32)


_LEVELS: dict = {}


def _level_case(ctxs, nl):
    """Inputs at level nl and the Pallas kernel's output, made once per
    level for the tests that share them."""
    if nl not in _LEVELS:
        jctx, ctx = ctxs
        rng = np.random.default_rng(3 + nl)
        qs = [ctx.basis[i] for i in ctx.limb_idx(nl)]
        x = np.stack([[rng.integers(0, q, ctx.cfg.n, dtype=np.uint32)
                       for q in qs] for _ in range(2)])
        _LEVELS[nl] = x, _pallas_decompose(jnp.asarray(x), jctx.ks_tables(nl))
    return _LEVELS[nl]


@pytest.mark.parametrize("level", range(8))
def test_decompose_every_level(ctxs, level):
    jctx, ctx = ctxs
    nl = ctx.num_q - level
    x, pallas = _level_case(ctxs, nl)
    got = _port(x, ctx.ks_tables(nl).bc)
    np.testing.assert_array_equal(got, _xla_decompose(jnp.asarray(x),
                                                      jctx.ks_tables(nl)))
    np.testing.assert_array_equal(got, pallas)


def test_moddown_convert_prefolded(ctxs):
    jctx, ctx = ctxs
    nl = ctx.num_q - 2
    jks = jctx.ks_tables(nl)
    rng = np.random.default_rng(5)
    vp = jnp.asarray(np.stack(
        [[rng.integers(0, p, ctx.cfg.n, dtype=np.uint32) for p in ctx.ps]
         for _ in range(2)]))
    w = jma.shoup_mulmod(vp, jks.pfold, jks.pfold_s, jks.q_sp)
    y = None
    for ti in range(w.shape[-2]):
        term = jma.shoup_mulmod(w[..., ti: ti + 1, :], jks.pconv[ti],
                                jks.pconv_s[ti], jks.q_act)
        y = term if y is None else jma.addmod(y, term, jks.q_act)
    want = np.asarray(jbc.base_convert(w, jks.md, interpret=True,
                                       prefolded=True))
    np.testing.assert_array_equal(want[0], np.asarray(y))
    got = _port(np.asarray(w), ctx.ks_tables(nl).md, prefolded=True)
    np.testing.assert_array_equal(got, want)
    # unfolded input: the port folds with the same pfold tables
    np.testing.assert_array_equal(_port(np.asarray(vp),
                                        ctx.ks_tables(nl).md), want)


def test_cuda_wrapper_refuses_cpu_tensor(ctxs):
    _, ctx = ctxs
    x = torch.zeros((2, ctx.num_q, ctx.cfg.n), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        basecvt.base_convert_cuda(x, ctx.ks_tables(ctx.num_q).bc)


@pytest.mark.parametrize("level", range(8))
def test_planes_mirror_every_level(ctxs, level):
    """K3's digit-plane arithmetic, from the port's fragment tables, equals
    the plain conversion and the JAX Pallas kernel at every level (partly
    filled last digit groups included)."""
    _, ctx = ctxs
    nl = ctx.num_q - level
    x, pallas = _level_case(ctxs, nl)
    bc = ctx.ks_tables(nl).bc
    xt = torch.from_numpy(x.astype(np.int32))
    got = basecvt.base_convert_planes_plain(xt, bc)
    np.testing.assert_array_equal(got.numpy(),
                                  basecvt.base_convert_plain(xt, bc).numpy())
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), pallas)


def test_planes_mirror_moddown_prefolded(ctxs):
    jctx, ctx = ctxs
    nl = ctx.num_q - 2
    jks = jctx.ks_tables(nl)
    rng = np.random.default_rng(6)
    vp = jnp.asarray(np.stack(
        [[rng.integers(0, p, ctx.cfg.n, dtype=np.uint32) for p in ctx.ps]
         for _ in range(3)]))
    w = np.asarray(jma.shoup_mulmod(vp, jks.pfold, jks.pfold_s, jks.q_sp))
    want = np.asarray(jbc.base_convert(jnp.asarray(w), jks.md,
                                       interpret=True, prefolded=True))
    got = basecvt.base_convert_planes_plain(
        torch.from_numpy(w.astype(np.int32)), ctx.ks_tables(nl).md,
        prefolded=True)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.fixture(scope="module")
def wide_ctx():
    """The linformer-boot-w chain's digits (alpha = 20, three k-steps of the
    int8 product, up to 79 targets) on a 2^11 ring."""
    return Context(CKKSConfig(n=1 << 11, scale_bits=26, num_scaling=58,
                              dnum=3, secret_hw=32), device="cpu")


@pytest.mark.parametrize("nl", [59, 25])
def test_planes_mirror_wide_digits(wide_ctx, nl):
    ctx = wide_ctx
    ks = ctx.ks_tables(nl)
    assert ks.bc.alpha == 20 and ks.bc.planes.shape[3] == 3
    rng = np.random.default_rng(nl)
    qs = [ctx.basis[i] for i in ctx.limb_idx(nl)]
    x = torch.from_numpy(np.stack(
        [[rng.integers(0, q, ctx.cfg.n) for q in qs]]).astype(np.int32))
    np.testing.assert_array_equal(
        basecvt.base_convert_planes_plain(x, ks.bc).numpy(),
        basecvt.base_convert_plain(x, ks.bc).numpy())
    w = torch.from_numpy(np.stack(
        [[rng.integers(0, p, ctx.cfg.n) for p in ctx.ps]] * 2
    ).astype(np.int32))
    np.testing.assert_array_equal(
        basecvt.base_convert_planes_plain(w, ks.md, prefolded=True).numpy(),
        basecvt.base_convert_plain(w, ks.md, prefolded=True).numpy())


def test_fragment_layout_covers_tile():
    """The mma.m16n8k32 A fragment places each (row, column) of the 16 x 32
    s8 tile in exactly one (lane, word, byte)."""
    rows, cols = basecvt.fragment_rows_cols()
    cells = {(int(rows[ln, r]), int(cols[ln, r, b]))
             for ln in range(32) for r in range(4) for b in range(4)}
    assert cells == {(i, j) for i in range(16) for j in range(32)}
