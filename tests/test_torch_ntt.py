"""The port's NTT (fhe_linformer_tpu_torch.ops.ntt) against the JAX
package's XLA four-step (`ops.ntt._fwd/_inv`) and its Pallas kernels run
in interpret mode (`ops.ntt_pallas.fwd/inv`), bit-exact, at n = 2^11 and
at the production ring n = 2^15 (L = 3 limbs, batch 2).

The port's CUDA kernels K1/K2 compute the same butterflies as the plain
version tested here; chip_smoke.py holds them against it on the card.
`ntt_cuda.fwd_phased_plain` / `inv_phased_plain` repeat K1's and K2's
schedules (thread/element mapping, twiddle indices, exchanges, K2's
cross-block last stage with n^-1 folded in) in int64 and are held against
both here, also at 2^13, where phase 1 has two stages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fhe_linformer_tpu.ops import ntt_pallas
from fhe_linformer_tpu.ops.ntt import NttContext, _fwd, _inv
from fhe_linformer_tpu.primes import ntt_primes
from fhe_linformer_tpu_torch.ops import ntt, ntt_cuda
from fhe_linformer_tpu_torch.primes import root_of_unity

L, B = 3, 2


@pytest.fixture(scope="module", params=[1 << 11, 1 << 15], ids=["n2^11", "n2^15"])
def case(request):
    torch.set_num_threads(2)
    n = request.param
    qs = ntt_primes(2 * n, L)
    rng = np.random.default_rng(7)
    x = np.stack([[rng.integers(0, q, n, dtype=np.uint32) for q in qs]
                  for _ in range(B)])
    jctx = NttContext(n, qs)
    xj = jnp.asarray(x)
    want = {"fwd": np.asarray(_fwd(xj, jctx.full)),
            "inv": np.asarray(_inv(xj, jctx.full))}
    tables = ntt.NttTables(n, qs, "cpu")
    return jctx, tables, x, want


def _port(tables, x, direction, limbs=(0, 1, 2)):
    f = ntt.fwd if direction == "fwd" else ntt.inv
    out = f(torch.from_numpy(x.astype(np.int32)), tables, limbs)
    assert out.dtype == torch.int32
    return out.numpy().astype(np.uint32)


@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_matches_jax_xla(case, direction):
    _, tables, x, want = case
    np.testing.assert_array_equal(_port(tables, x, direction), want[direction])


@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_matches_pallas_interpret(case, direction):
    jctx, tables, x, _ = case
    kern = ntt_pallas.fwd if direction == "fwd" else ntt_pallas.inv
    want = np.asarray(kern(jnp.asarray(x), jctx.full, interpret=True))
    np.testing.assert_array_equal(_port(tables, x, direction), want)


def test_limb_subset_and_roundtrip(case):
    """A row subset named by basis index uses that limb's tables (the
    lazy limb subsets of the JAX NttContext.tables)."""
    jctx, tables, x, want = case
    sub = np.ascontiguousarray(x[:, [2, 0]])
    got = _port(tables, sub, "fwd", limbs=(2, 0))
    np.testing.assert_array_equal(got, want["fwd"][:, [2, 0]])
    back = _port(tables, got, "inv", limbs=(2, 0))
    np.testing.assert_array_equal(back, sub)


def test_cuda_wrapper_refuses_cpu_tensor(case):
    _, tables, x, _ = case
    with pytest.raises(ValueError, match="CUDA tensor"):
        ntt_cuda.fwd(torch.from_numpy(x.astype(np.int32)), tables, (0, 1, 2))


def test_k1_schedule_mirror(case):
    """K1's phased schedule (two blocks per row, register phases, skewed
    exchanges, bit-reversed store) mirrored in int64 equals the plain
    transform, and at 2^11 the Pallas kernel too."""
    jctx, tables, x, want = case
    xt = torch.from_numpy(x.astype(np.int32))
    got = ntt_cuda.fwd_phased_plain(xt, tables, (0, 1, 2))
    np.testing.assert_array_equal(got.numpy(),
                                  ntt.fwd_plain(xt, tables, (0, 1, 2)).numpy())
    if tables.n == 1 << 11:
        pallas = ntt_pallas.fwd(jnp.asarray(x), jctx.full, interpret=True)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      np.asarray(pallas))


def test_limb_map_skips_rows(case):
    """A limb map transforms each leading-axis entry with its own limbs in
    one call; entries < 0 leave their rows unset (zero on the CPU)."""
    _, tables, x, want = case
    xt = torch.from_numpy(np.stack([x, x[:, ::-1]]).astype(np.int32))
    lmap = ((0, -1, 2), (-1, 1, 0))
    got = ntt.fwd(xt, tables, lmap).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got[0][:, [0, 2]], want["fwd"][:, [0, 2]])
    np.testing.assert_array_equal(got[1][:, 1], want["fwd"][:, 1])
    np.testing.assert_array_equal(got[1][:, 2], want["fwd"][:, 0])
    assert not got[0][:, 1].any() and not got[1][:, 0].any()


def test_launch_tables_cached(case):
    """The kernels' per-launch limb tables are built once per key."""
    _, tables, _, _ = case
    assert tables.limb_map((2, 0)) is tables.limb_map((2, 0))
    assert tuple(tables.limb_map(((0, -1), (1, 2))).shape) == (2, 2)
    lm = tables.limb_map((2, 0))
    assert lm.tolist() == [[2, 0]] and lm.dtype == torch.int32
    with pytest.raises(ValueError, match="below K1"):
        ntt_cuda.fwd_phased_plain(torch.zeros((1, 1 << 10), dtype=torch.int32),
                                  ntt.NttTables(1 << 10, tables.qs[:1], "cpu"),
                                  (0,))


def test_k2_schedule_mirror(case):
    """K2's phased schedule (parity loads, phases 3-2-1 with the inverse
    butterflies, skewed exchanges, the last stage split across the cluster
    with n^-1 folded in) mirrored in int64 equals the plain transform and
    the JAX package's, and at 2^11 the Pallas kernel too."""
    jctx, tables, x, want = case
    xt = torch.from_numpy(x.astype(np.int32))
    got = ntt_cuda.inv_phased_plain(xt, tables, (0, 1, 2))
    np.testing.assert_array_equal(got.numpy(),
                                  ntt.inv_plain(xt, tables, (0, 1, 2)).numpy())
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want["inv"])
    if tables.n == 1 << 11:
        pallas = ntt_pallas.inv(jnp.asarray(x), jctx.full, interpret=True)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      np.asarray(pallas))


@pytest.fixture(scope="module")
def case_2_13():
    """n = 2^13, where phase 1 of K1/K2 has 2 stages (0 at 2^11, 4 at
    2^15) and the exchange skew is 2."""
    n = 1 << 13
    qs = ntt_primes(2 * n, 2)
    rng = np.random.default_rng(13)
    x = np.stack([rng.integers(0, q, n, dtype=np.uint32) for q in qs])[None]
    return ntt.NttTables(n, qs, "cpu"), NttContext(n, qs), x


@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_schedule_mirrors_n2_13(case_2_13, direction):
    tables, jctx, x = case_2_13
    xt = torch.from_numpy(x.astype(np.int32))
    mirror, plain, ref = ((ntt_cuda.fwd_phased_plain, ntt.fwd_plain, _fwd)
                          if direction == "fwd" else
                          (ntt_cuda.inv_phased_plain, ntt.inv_plain, _inv))
    got = mirror(xt, tables, (0, 1))
    np.testing.assert_array_equal(got.numpy(), plain(xt, tables, (0, 1)).numpy())
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(ref(jnp.asarray(x), jctx.full)))


def test_folded_ninv_tables(case):
    """K2's last-stage constants: n^-1 and psi^-(n/2) n^-1 per prime (the
    inverse's twiddle 1 is psi^-bitrev(1)), each with its Shoup companion
    floor(v 2^32 / q), against Python big-int arithmetic."""
    _, tables, _, _ = case
    n = tables.n
    u32 = lambda a: (a.numpy().astype(np.int64) & 0xFFFFFFFF).tolist()
    for i, q in enumerate(tables.qs):
        psi = root_of_unity(2 * n, q)
        ninv = pow(n, -1, q)
        ninv_w = pow(psi, -(n // 2), q) * ninv % q
        assert int(tables.ipsi_rev[i, 1]) == pow(psi, -(n // 2), q)
        assert int(tables.n_inv[i]) == ninv
        assert int(tables.n_inv_w[i]) == ninv_w
        assert u32(tables.n_inv_s)[i] == (ninv << 32) // q
        assert u32(tables.n_inv_ws)[i] == (ninv_w << 32) // q


def test_inv_limb_slice(case):
    """ntt.inv of a limb slice (the rescale's and mod-down's x[..., l:, :])
    equals it on the slice's contiguous copy."""
    _, tables, x, _ = case
    xt = torch.from_numpy(x.astype(np.int32))
    for sl in (xt[..., 1:, :], xt[..., 2:, :], xt[None, :, 1:].expand(2, -1,
                                                                     -1, -1)):
        limbs = tuple(range(3 - sl.shape[-2], 3))
        assert not sl.is_contiguous()
        np.testing.assert_array_equal(
            ntt.inv(sl, tables, limbs).numpy(),
            ntt.inv(sl.contiguous(), tables, limbs).numpy())


def test_k2_entry_stride():
    """K2's wrapper reads a limb slice in place: rows n apart and the
    leading axes at one stride; any other layout raises."""
    n = 1 << 11
    x = torch.zeros((2, 8, 57, n), dtype=torch.int32)
    assert ntt_cuda.entry_stride(x) == 57 * n
    assert ntt_cuda.entry_stride(x[..., 56:, :]) == 57 * n      # rescale
    assert ntt_cuda.entry_stride(x[:, :, 37:]) == 57 * n        # mod-down
    assert ntt_cuda.entry_stride(x[:1, 3:4, 5:]) == 52 * n      # one entry
    assert ntt_cuda.entry_stride(x[:, ::2]) == 2 * 57 * n
    for bad in (x.transpose(0, 1), x[..., ::2], x[:, :, ::2]):
        with pytest.raises(ValueError):
            ntt_cuda.entry_stride(bad)


def test_cuda_inverse_refuses_cpu_tensor(case):
    _, tables, x, _ = case
    with pytest.raises(ValueError, match="CUDA tensor"):
        ntt_cuda.inv(torch.from_numpy(x.astype(np.int32))[..., 1:, :], tables,
                     (1, 2))
