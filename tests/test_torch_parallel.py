"""The port's `parallel/` on gloo CPU ranks, against the JAX package and
the port's single-process path.

One spawn per world size (2 and 4 ranks) runs `parallel.dryrun`'s worker,
which carries every multi-rank check; the parametrised tests below assert
on its results.  While the ranks run, this process builds the references:

  * `build_sharded_ks` against the JAX package's plan, array by array;
  * the limb-sharded Galois switch and combo (n = 2^11, 12 q-limbs + 4
    special, dnum 3) on 2 and 4 limb ranks, directly and through the
    evaluator: each rank requires its result to equal its single-process
    switch, and here the result must equal the JAX package's
    `Evaluator.rotate` / `rotate_combo` on the same JAX-encrypted
    ciphertext; every rank's `keyswitch_sharded` count is positive;
  * `make_attention_step` on (1 x 2) and (2 x 2) meshes against the JAX
    package's `NttPlan`;
  * both dp forwards at the dry-run's trimmed profile (n = 256, d = 8,
    degree 5, num_scaling 40, dnum 3; per-token S_total 6, packed 32 as
    2 chunks) on 2 ranks: bit-exact with the single-process forward from
    the same encryption, argmax equal to golden, each rank's key switches
    below the single-process count;
  * `PackedLinformer(batch_chunks=True)` against the chunk loop;
  * a failing rank raising in the launcher.

Without a spawn: the evaluator counts each key switch where it runs (a
dp rank its own block's), and runs plaintext products and rescales in
chunks equal to one call.
"""

import concurrent.futures
import types

import numpy as np
import pytest
import torch

from fhe_linformer_tpu.ckks import CKKSConfig as JConfig, Context as JContext
from fhe_linformer_tpu.ckks import Evaluator as JEvaluator
from fhe_linformer_tpu.ckks import generate_keys as jgenerate_keys
from fhe_linformer_tpu.parallel.ksprod import build_sharded_ks as jbuild
from fhe_linformer_tpu.reference import NttPlan
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
from fhe_linformer_tpu_torch.ckks.keys import generate_keys
from fhe_linformer_tpu_torch.parallel import ksprod
from fhe_linformer_tpu_torch.convert import (ciphertext_from_numpy,
                                             ciphertext_to_numpy)
from fhe_linformer_tpu_torch.parallel.circuit import dryrun_circuit
from fhe_linformer_tpu_torch.parallel.dryrun import dryrun_worker
from fhe_linformer_tpu_torch.parallel.mesh import launch
from fhe_linformer_tpu_torch.primes import ntt_primes
from fhe_linformer_tpu_torch.utils.timing import GLOBAL_TIMERS

KS = dict(n=2048, num_scaling=11, dnum=3)
ROT, SHIFTS = 3, (1, 2, 3)
DRY = (5, 40, 3)                       # degree, num_scaling, dnum
S_TOKEN, S_PACKED = 6, 32
FORWARDS = ("token", "packed")         # the order of the 2-rank forwards
ATT_N = 512


def _jct(ct):
    return (np.asarray(ct.c0), np.asarray(ct.c1), ct.nl, ct.scale)


def _jax_switches():
    """The JAX package's rotate and rotate_combo on ciphertexts it
    encrypted (the parity checks' seeds and draws): (inputs, the calls
    that give the outputs)."""
    slots = KS["n"] // 2

    def jev(seed, rotations):
        ctx = JContext(JConfig(n=KS["n"], scale_bits=26, seed=seed,
                               num_scaling=KS["num_scaling"],
                               dnum=KS["dnum"]))
        return JEvaluator(ctx, jgenerate_keys(ctx, rotations=rotations))
    rev, cev = jev(77, (ROT,)), jev(78, SHIFTS)
    ct_rot = rev.encrypt(np.random.default_rng(5).uniform(-1, 1, slots))
    rng = np.random.default_rng(6)
    ct_combo = cev.encrypt(rng.uniform(-1, 1, slots))
    items = [(r, cev.encode_coeff_cached(("combo_par", i),
                                         rng.uniform(-1, 1, slots)))
             for i, r in enumerate(SHIFTS)]
    return ((_jct(ct_rot), _jct(ct_combo)),
            (lambda: _jct(rev.rotate(ct_rot, ROT)),
             lambda: _jct(cev.rotate_combo(ct_combo, items))))


def _attention_inputs(limb, dp):
    qs = ntt_primes(2 * ATT_N, limb)
    rng = np.random.default_rng(1)
    x = np.stack([[rng.integers(0, q, ATT_N) for q in qs]
                  for _ in range(2 * dp)]).astype(np.int32)
    wt = np.stack([rng.integers(0, q, ATT_N) for q in qs]).astype(np.int32)
    return {"dp": dp, "limb": limb, "n": ATT_N, "x": x, "wt": wt}


def _single(circ, inputs, S, packed):
    """The single-process forward from the same encrypted inputs."""
    x, xe, xf = (ciphertext_from_numpy(circ.ev.ctx, *a) for a in inputs)
    ks0 = GLOBAL_TIMERS.counts["keyswitch"]
    y = circ.encoder_layer(x, xe, xf, S)
    out = circ.pooler_classifier(y if packed
                                 else y.with_data(y.c0[0], y.c1[0]))
    return {"layer": y, "out": out,
            "keyswitch": GLOBAL_TIMERS.counts["keyswitch"] - ks0,
            "logits": circ.decrypt_logits(out)}


@pytest.fixture(scope="module")
def run():
    """Both spawns (and a failing one) in the background; the references
    here meanwhile."""
    torch.set_num_threads(2)
    (ct_rot, ct_combo), jax_out = _jax_switches()
    ksspec = dict(**KS, rot=ROT, shifts=SHIFTS, ct_rot=ct_rot,
                  ct_combo=ct_combo)
    fwd = {}
    for kind, S in (("token", S_TOKEN), ("packed", S_PACKED)):
        make_args = (S, *DRY, kind == "packed", None, 11, "cpu")
        circ, emb, want = dryrun_circuit(*make_args)
        x, xe, xf, St = circ.encrypt_inputs(emb)
        inputs = [ciphertext_to_numpy(c) for c in (x, xe, xf)]
        fwd[kind] = (circ, inputs, St, want)
    spec2 = {"device": "cpu", "attention": _attention_inputs(2, 1),
             "ksprod": ksspec,
             "forwards": [{"make_args": (S, *DRY, k == "packed", None, 11,
                                         "cpu"), "inputs": fwd[k][1],
                           "S_total": fwd[k][2], "packed": k == "packed"}
                          for k, S in (("token", S_TOKEN),
                                       ("packed", S_PACKED))]}
    spec4 = {"device": "cpu", "attention": _attention_inputs(2, 2),
             "ksprod": ksspec}
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        f2 = pool.submit(launch, dryrun_worker, 2, spec2, threads=1,
                         timeout=300)
        f4 = pool.submit(launch, dryrun_worker, 4, spec4, threads=1,
                         timeout=300)
        # a 3 x 1 mesh on 2 ranks: every rank raises
        fbad = pool.submit(launch, dryrun_worker, 2,
                           {"attention": {"dp": 3, "limb": 1}}, timeout=120)
        refs = {"jax_rotate": jax_out[0](), "jax_combo": jax_out[1]()}
        for kind, (circ, inputs, St, want) in fwd.items():
            refs[kind] = _single(circ, inputs, St, kind == "packed")
            refs[kind]["golden"] = want
        circ = fwd["packed"][0]
        circ.batch_chunks = False
        refs["packed_loop"] = _single(circ, fwd["packed"][1],
                                      fwd["packed"][2], True)
        with pytest.raises(Exception) as bad:
            fbad.result()
        return {2: f2.result(), 4: f4.result(), "refs": refs,
                "bad": bad.value}


@pytest.mark.parametrize("nshard", [2, 4, 8])
def test_sharded_plan_matches_jax(nshard):
    cfg = dict(n=256, scale_bits=26, num_scaling=11, dnum=3, seed=77)
    ctx = Context(CKKSConfig(**cfg), device="cpu")
    jctx = JContext(JConfig(**cfg))
    for nl in (ctx.num_q, ctx.num_q - nshard):
        plan = ksprod.build_sharded_ks(ctx, nl, nshard)
        jplan = jbuild(jctx, nl, nshard)
        assert (plan.nl, plan.k_sp, plan.nd, plan.per) == \
            (jplan.nl, jplan.k_sp, jplan.nd, jplan.per)
        for name in ("gq_full", "fold", "conv", "pfold", "pconv",
                     "q_act_row", "pinv", "pmod", "mdq40"):
            np.testing.assert_array_equal(
                getattr(plan, name),
                np.asarray(getattr(jplan, name)).astype(np.int64), name)


def test_sharded_plan_refuses_a_basis_that_does_not_divide():
    ctx = Context(CKKSConfig(n=256, scale_bits=26, num_scaling=11, dnum=3),
                  device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        ksprod.build_sharded_ks(ctx, ctx.num_q, 3)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("route", ["direct", "evaluator"])
@pytest.mark.parametrize("op", ["rotate", "combo"])
def test_sharded_switch_equals_jax(run, world, route, op):
    want = run["refs"][f"jax_{op}"]
    for rank in run[world]:
        got = rank[op][route == "evaluator"]
        np.testing.assert_array_equal(got["c0"].astype(np.uint32), want[0])
        np.testing.assert_array_equal(got["c1"].astype(np.uint32), want[1])
        assert got["err"] < 1e-2


@pytest.mark.parametrize("world", [2, 4])
def test_keyswitch_sharded_counted_on_every_rank(run, world):
    assert [r["keyswitch_sharded"] for r in run[world]] == [2] * world


@pytest.mark.parametrize("world", [2, 4])
def test_attention_step_vs_nttplan(run, world):
    spec = _attention_inputs(2, world // 2)
    qs = ntt_primes(2 * ATT_N, 2)
    plans = [NttPlan(ATT_N, q) for q in qs]
    for rank in run[world]:
        a = rank["attention"]
        (b0, b1), (r0, r1) = a["batch"], a["rows"]
        assert a["z"].shape == (b1 - b0, r1 - r0, ATT_N)
        for b in range(b0, b1):
            for i in range(r0, r1):
                want = plans[i].inv(plans[i].fwd(spec["x"][b, i])
                                    .astype(np.int64)
                                    * spec["wt"][i] % qs[i])
                np.testing.assert_array_equal(a["z"][b - b0, i - r0], want)
        z0 = np.stack([plans[i].inv(plans[i].fwd(spec["x"][b0, i])
                                    .astype(np.int64) * spec["wt"][i] % qs[i])
                       for i in range(2)]).astype(np.int64)
        conv = (np.asarray(qs, np.int64) // 3) % qs[0]
        total = (z0 * conv[:, None] % qs[0]).sum(0) % qs[0]
        np.testing.assert_array_equal(a["total"][0], total)


@pytest.mark.parametrize("kind", ["token", "packed"])
def test_dp_forward_bit_exact(run, kind):
    ref = run["refs"][kind]
    ranks = [r["forwards"][FORWARDS.index(kind)] for r in run[2]]
    holders = [r for r in ranks if r["out"] is not None]
    assert len(holders) == (1 if kind == "packed" else 2)
    for r in holders:
        c0, c1, nl, scale = r["out"]
        assert (nl, scale) == (ref["out"].nl, ref["out"].scale)
        np.testing.assert_array_equal(c0, ref["out"].c0.numpy())
        np.testing.assert_array_equal(c1, ref["out"].c1.numpy())
    if kind == "packed":          # each rank's chunk block of the layer
        for i, r in enumerate(ranks):
            c0, c1, nl, scale = r["layer"]
            np.testing.assert_array_equal(c0, ref["layer"].c0[i:i + 1].numpy())
            np.testing.assert_array_equal(c1, ref["layer"].c1[i:i + 1].numpy())


@pytest.mark.parametrize("kind", ["token", "packed"])
def test_dp_forward_golden_argmax(run, kind):
    ref = run["refs"][kind]
    assert np.argmax(ref["logits"]) == np.argmax(ref["golden"])
    np.testing.assert_allclose(ref["logits"], ref["golden"], atol=0.05)


@pytest.mark.parametrize("kind", ["token", "packed"])
def test_dp_rank_runs_fewer_keyswitches(run, kind):
    single = run["refs"][kind]["keyswitch"]
    counts = [r["forwards"][FORWARDS.index(kind)]["keyswitch"]
              for r in run[2]]
    assert all(0 < c < single for c in counts), (counts, single)


def test_token_dp_gathers_every_split(run):
    ranks = [r["forwards"][0] for r in run[2]]
    assert all(r["collective_bytes"]["all_gather"] > 0 for r in ranks)
    assert ranks[0]["collective_bytes"] == ranks[1]["collective_bytes"]


def test_batch_chunks_equals_loop(run):
    a, b = run["refs"]["packed"], run["refs"]["packed_loop"]
    assert a["keyswitch"] == b["keyswitch"]
    for x, y in ((a["layer"], b["layer"]), (a["out"], b["out"])):
        assert (x.nl, x.scale) == (y.nl, y.scale)
        assert torch.equal(x.c0, y.c0) and torch.equal(x.c1, y.c1)


def test_launch_raises_when_a_rank_fails(run):
    assert isinstance(run["bad"], RuntimeError)
    assert "needs 3 ranks" in str(run["bad"])


class _HalfDp:
    """Rank 0 of a 2-rank dp axis whose other rank's block comes back as
    zeros: enough to count this rank's key switches without a spawn."""
    size, rank = 2, 0

    def all_gather(self, t, dim):
        return torch.cat([t, torch.zeros_like(t)], dim)


@pytest.fixture(scope="module")
def small_ev():
    ctx = Context(CKKSConfig(n=256, scale_bits=26, num_scaling=6, dnum=3),
                  device="cpu")
    ev = Evaluator(ctx, generate_keys(ctx, rotations=(1, 2)))
    rng = np.random.default_rng(2)
    a = ev.encrypt(rng.uniform(-1, 1, (1, ctx.cfg.slots)), batch=True)
    b = ev.encrypt(rng.uniform(-1, 1, (4, ctx.cfg.slots)), batch=True)
    return ev, a, b


@pytest.mark.parametrize("dp", [False, True])
def test_keyswitch_counted_where_it_runs(small_ev, dp):
    """a (batch 1) broadcasts over b (batch 4) in the product: 4 switches,
    2 on a dp rank; the accumulated rotations 2 per ciphertext."""
    ev, a, b = small_ev
    ev.enable_dp(types.SimpleNamespace(comms={"dp": _HalfDp()})
                 if dp else None)
    try:
        k0 = GLOBAL_TIMERS.counts["keyswitch"]
        ev.mul(a, b, rescale=False)
        ev.rotate_accumulate_tree(b, (1, 2))
        got = GLOBAL_TIMERS.counts["keyswitch"] - k0
    finally:
        ev.enable_dp(None)
    assert got == (2 + 2 * 2 if dp else 4 + 2 * 4)


@pytest.mark.parametrize("op", ["mul_plain", "mul_plain_batched_pt",
                                "rescale"])
def test_chunked_batch_ops_equal_one_call(small_ev, op):
    ev, _, _ = small_ev
    rng = np.random.default_rng(3)
    slots = ev.ctx.cfg.slots
    ct = ev.encrypt(rng.uniform(-1, 1, (20, slots)), batch=True)
    pt = ev.encode(rng.uniform(-1, 1, (20, slots)), batch=True) \
        if op == "mul_plain_batched_pt" else \
        ev.encode(rng.uniform(-1, 1, slots))
    run = ev.rescale if op == "rescale" else (lambda c: ev.mul_plain(c, pt))
    chunk = ev.heavy_chunk
    assert chunk < 20
    try:
        chunked = run(ct)
        ev.heavy_chunk = 20
        whole = run(ct)
    finally:
        ev.heavy_chunk = chunk
    assert (chunked.nl, chunked.scale) == (whole.nl, whole.scale)
    assert torch.equal(chunked.c0, whole.c0)
    assert torch.equal(chunked.c1, whole.c1)
