#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fhe_linformer_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, each printing one JSON line:
  1. card     - nvidia-smi name, power limit and maximum SM clock,
                torch/CUDA versions, and the build of fhe_linformer_tpu_torch/
                csrc: every kernel by nvcc (with ptxas registers/spills) and
                the host codec fastio.cpp by g++, all at once
  2. kernels  - each CUDA kernel against its plain PyTorch version on the
                card at every shape the main paths send it (K2 through the
                port's `ntt.inv`, on the limb slices it reads in place; the
                ring-2^8 kernels of the CLI phase; the ring-2^16 shapes of
                phase ring16; the device slot decrypt's 3 limbs; the
                sharded key switch's per-rank shapes of phase 9): exact
                equality, median time, the plain version's time, and the
                least time the card could take (`bound`)
  3. keyswitch - the CLI `bench` case: one Galois key switch at N = 2^15,
                24 limbs, dnum 3, batch 4 (the yardstick for later speed
                work); rotate_hoisted of the same ciphertext by 3 shifts,
                bit for bit against the port's CPU path, ms per shift
                beside a rotation's; the same switch on config 5's chain
                with a full-basis key and with a reduced-basis key
                (KSKey.max_nl 25), each bit for bit against the CPU path,
                with their ms and key MB side by side
  4. forward  - the block-major encrypted Linformer (d = 128, k_lin = 32,
                d_ffn = 512, 20 classes, random weights of seed 3) on the
                linformer-boot-w parameters without bootstrapping, answering
                two requests (S = 128 and S = 200 tokens); per stage wall
                time, key switches, kernel launches, and the decrypted
                logits against the plaintext golden model; then one traced
                warm S = 128 request (device time per kernel, idle share,
                and the shapes each kernel was launched at, with their
                device time)
  5. bootstrap - the wide production bootstrap (BootConfig.wide_production
                with scale_boost 4, the linformer-boot-w chain) of a batch of
                4 ciphertexts dropped to one limb, first and warm: seconds,
                output level, precision in bits against the message, key
                generation, memory, and a traced warm bootstrap
  6. boot_forward - the bootstrapped packed Linformer (the production path:
                linformer-boot-w, wide bootstrap at scale_boost 2, refreshes
                mid-exp, before the GELU and at the pooler; degree-119
                inverse and GELU, degree-247 tanh, inputs at 12 limbs)
                answering S = 128 (cold, warm) and S = 700 (6 chunks),
                each checked against the golden model, then one traced warm
                S = 128 request (every request of phases 4, 6 and 7 also
                decrypts its logit slots with decrypt_slots_device:
                seconds, error against golden and the host decrypt, argmax;
                it fails unless they are finite, within 0.05 of the host
                decrypt and of the same argmax)
  6b. native  - the host codec (csrc/fastio.cpp through io/native.py) on
                phase 6's path: its g++ build seconds; the S = 700 request's
                encoder output (6 chunks) lifted from 3 limbs by the native
                lifter and by Python ints, equal bit for bit, ms each; that
                output saved as a checkpoint with native pages, loaded and
                the request resumed from it, equal bit for bit to the
                request without the round trip (bytes, save and load
                seconds), and a copy with one flipped byte raising the CRC
                error; Gadgets.relu (degree 119) on 4 fresh ciphertexts:
                seconds, key switches, the host decrypt against cheb_eval of
                the fit (fails above 0.05) and against max(x, 0)
  7. token_forward - config 5: the per-token circuit (EncryptedLinformer)
                with two bootstrapped layers on preset multi-layer, the
                second layer's E/F compression homomorphic, S = 32; keys for
                the CLI's rotation set through save_keys -> load_keys;
                cold and warm requests with seconds, key switches and
                bootstrapped ciphertexts per layer and stage, peak memory,
                the host decrypt against the 2-layer golden, the warm
                request's ciphertext against the cold one's (the same
                encryption draws: equal bit for bit); at the start of each
                request and layer, memory allocated and what each plaintext
                and key cache holds; one per-token single-layer request
                at S = 128
 7b. token_forward_ref - config 5 with tools/config5_run.py's key set
                (the bootstrap's rotations full-basis, the other +/-2^i
                reduced-basis at max_nl 25, conjugation, relinearisation)
                through save_keys -> load_keys: cold and warm requests as
                in phase 7 and a traced warm request, then its key GB,
                keystore bytes, load seconds, per-layer peaks, key
                switches per layer and stage and request seconds beside
                the full-basis set's
  8. ring16   - preset linformer-128c (ring 2^16, 47 q-limbs, uniform
                ternary secret, >= 128-bit classical security): context,
                keys for the bootstrap's rotations and conjugation, the
                uniform-secret wide bootstrap (K = 512, degree-201 sine,
                6 double angles) of 2 ciphertexts dropped to one limb, cold
                and warm; limbs out, precision through the host decrypt,
                peak memory, and a traced warm bootstrap
  9. parallel - fhe_linformer_tpu_torch/parallel on 2-4 processes that
                share the card and exchange data through gloo, staged
                through host buffers (the kernels are built before any
                rank starts): the limb-sharded Galois switch and rotation
                combo at ring 2^15 (24 + 8 rows, 8 per rank on 4 ranks)
                through Evaluator.rotate / rotate_combo, equal to each
                rank's single-process switch, with ms and collective bytes
                per switch and each rank's keyswitch_sharded count; the
                attention step on a 2 x 2 mesh against the plain NTT; then
                2 ranks run the dp forwards: the dry-run's tiny profile
                (per-token S = 6, packed S = 32) and, at full width, phase
                6's bootstrapped packed S = 700 (6 chunks, batch_chunks)
                and phase 7's per-token S = 128, each rank's output
                ciphertext equal to this process's single-process one from
                the same encryption (host decrypt against golden), each
                rank below its key switches; one card measures no
                multi-card speed
 10. cli      - `python -m fhe_linformer_tpu_torch.cli` keygen, infer
                (--keys-dir, --cls-only) and golden as subprocesses at
                preset tiny on the card: exit codes and argmax
 11. the `kernels` line: every kernel with its launches over phases 4-9,
     6b and 7b included (phase 9's ranks send theirs to this process)

It ends with {"ok": true, "device": {...}}.  Any failure raises and exits
non-zero before that line.  There is no CPU path: the script refuses to run
without CUDA.  `--only card,kernels` runs a subset of the phases (and
prints no result line), for a quick check of a new kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
INT8_TC_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core rate
# 32-bit integer multiplies: the CUDA C++ Programming Guide's arithmetic
# instruction throughput table gives compute capability 9.0 64 results per
# clock per SM for 32-bit integer multiply(-add), half the float32 FMA rate
INT_MUL_PER_CLOCK_PER_SM = 64
PORT = "fhe_linformer_tpu_torch"
KERNELS = ("ntt_fwd", "ntt_inv", "base_convert", "ks_mac", "md_fold",
           "md_lift", "md_finish")
# the limb-sharded key switch has its own inner product (parallel/ksprod.py)
SHARDED_KERNELS = ("ntt_fwd", "ntt_inv", "base_convert")
REFERENCE = PORT.removesuffix("_torch")      # the JAX package the port mirrors
REPLACES = {"ntt_fwd": f"{REFERENCE}/ops/ntt_pallas.py:195",
            "ntt_inv": f"{REFERENCE}/ops/ntt_pallas.py:199",
            "base_convert": f"{REFERENCE}/ops/basecvt.py:81",
            "ks_mac": "none: plain XLA in the JAX package",
            **{k: "none: plain XLA in the JAX package"
               for k in ("md_fold", "md_lift", "md_finish")}}
SOURCES = {"ntt_fwd": f"{PORT}/csrc/ntt.cu", "ntt_inv": f"{PORT}/csrc/ntt.cu",
           "base_convert": f"{PORT}/csrc/basecvt.cu",
           "ks_mac": f"{PORT}/csrc/ksmac.cu",
           **{k: f"{PORT}/csrc/moddown.cu"
              for k in ("md_fold", "md_lift", "md_finish")}}
LOG2N = 15
MODDOWN_BATCH = 16       # the mod-down's batch on the forward (2 halves x 8)
# the JAX package's records of the same requests on its own chip: counts
# and levels only (bench_layer_S128_packed_boot.json,
# bench_layer_S700_packed_boot.json, bench_details.json)
REFERENCE_BOOTSTRAPS = {128: 3, 700: 13}
REFERENCE_KEYSWITCHES_S128 = {"attention": 1383, "ffn_gelu": 482,
                              "pooler_classifier": 196}
REFERENCE_BOOT = {"out_nl": 23, "precision_bits": 7.03, "rotation_keys": 46}
# ring128c_run.json (tools/ring128c_run.py on linformer-128c, batch 1); the
# phase requires out_nl as the JAX package's current code leaves it on the
# same chain (tests/test_torch_ring16.py) and at least 4.0 bits
REFERENCE_RING16 = {"out_nl": 2, "precision_bits": 4.61, "rotation_keys": 38}
BOOT_CHUNK_CONFIG5 = 8   # ciphertexts per bootstrap in phase 7
# tools/config5_run.py's reduced-key ceiling: the wide bootstrap consumes 36
# of the multi-layer preset's 58 scaling limbs, plus a margin of 3
BOOT_CONSUMED_WIDE = 36
# the config-5 key set whose warm request is traced ("cli", phase 7, or
# "reference", phase 7b): one traced request keeps the script at 720-820 s
# on an H100
TRACED_CONFIG5_KEYS = "reference"
# config 5's model widths (tools/config5_run.py)
CONFIG5_MODEL = {"d": 128, "k_lin": 32, "d_ffn": 512, "n_classes": 20}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2, inner: int = 1) -> float:
    """Median milliseconds of one fn() call: `reps` samples, each timed by
    CUDA events around `inner` back-to-back calls.  Each sample is queued
    behind a 1 ms device sleep, so the host has enqueued its calls before
    the first runs and a short kernel's time is the device's, not the
    host's launch time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    sleep_cycles = int(card_clock()[1] * 1e3)        # 1 ms at the max clock
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return float(np.median(times))


@functools.cache
def card_clock() -> tuple[int, float, float]:
    """(SMs, maximum SM clock in MHz, 32-bit integer multiplies per second
    = SMs x 64 x that clock) of card 0."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms, mhz, sms * INT_MUL_PER_CLOCK_PER_SM * mhz * 1e6


def bound(nbytes: float, int_muls: float, tc_ops: float = 0.0
          ) -> tuple[float, str]:
    """The least time (ms) the card could take: bytes over the memory rate,
    or operations over their unit's peak (32-bit multiplies on the CUDA
    cores, int8 operations on the tensor cores), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_muls / card_clock()[2],
                tc_ops / INT8_TC_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_residues(shape, qs, gen, device):
    """Uniform residues below each limb's prime on the limb axis (-2)."""
    import torch
    q = torch.tensor(qs, dtype=torch.int64, device=device).view(-1, 1)
    x = torch.randint(0, 1 << 62, shape, generator=gen, device=device)
    return (x % q).int()


# ---------------------------------------------------------------------------
# phase 1

# phase card's build of csrc/ (seconds and compiler output per source)
BUILD_REPORT: dict = {}


def phase_card():
    import torch
    from fhe_linformer_tpu_torch.ops import cuda_build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    sms, mhz, int_mul_per_s = card_clock()
    t0 = time.perf_counter()
    report = cuda_build.build()
    BUILD_REPORT.update(report)
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "sms": sms,
          "max_sm_clock_mhz": mhz, "int_mul_per_s": int_mul_per_s,
          "build_s": time.perf_counter() - t0,
          "build": {k: {"seconds": v["seconds"],
                        "ptxas": [ln.strip() for ln in v["ptxas"].splitlines()
                                  if "registers" in ln or "spill" in ln
                                  or "Compiling entry" in ln]}
                    for k, v in report.items()}})


# ---------------------------------------------------------------------------
# phase 2


def _held(name, got, want, shape):
    import torch
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err != 0:
        raise AssertionError(f"{name} differs from its plain version at "
                             f"{shape}: max |diff| {err}")
    return err


def _fwd_case(tables, B, L, gen, reps, limb_map=None):
    """K1 on (B, L, n) rows of the first L limbs; with `limb_map` on the
    (D, B, L, n) digit stack of a decomposition, rows of entry < 0 skipped
    (and left out of the comparison)."""
    import torch
    from fhe_linformer_tpu_torch.ops import ntt, ntt_cuda
    name = "ntt_fwd"
    n = tables.n
    if limb_map is None:
        limbs = tuple(range(L))
        x = random_residues((B, L, n), tables.qs[:L], gen, "cuda")
        run = lambda: ntt_cuda.fwd(x, tables, limbs)
        run_plain = lambda: ntt.fwd_plain(x, tables, limbs)
        shape, active = [B, L, n], B * L
    else:
        D, L = len(limb_map), len(limb_map[0])
        col = [max(row[i] for row in limb_map) for i in range(L)]
        x = random_residues((D, B, L, n), [tables.qs[i] for i in col], gen,
                            "cuda")
        keep = torch.tensor([[v >= 0 for v in row] for row in limb_map],
                            device="cuda")[:, None, :, None]
        run = lambda: ntt_cuda.fwd(x, tables, limb_map)

        def run_plain():
            out = torch.zeros_like(x)
            for d, row in enumerate(limb_map):
                sel = [i for i, v in enumerate(row) if v >= 0]
                out[d][..., sel, :] = ntt.fwd_plain(
                    x[d][..., sel, :], tables, [row[i] for i in sel])
            return out
        shape = [D, B, L, n]
        active = B * sum(v >= 0 for row in limb_map for v in row)
    got = run()
    if limb_map is not None:
        got = torch.where(keep, got, 0)
    err = _held(name, got, run_plain(), shape)
    # 3 multiplies per Shoup butterfly; rows in and out, tables read once
    mults = active * (n // 2) * (n.bit_length() - 1) * 3
    nbytes = active * n * 8 + L * n * 8
    b_ms, b_by = bound(nbytes, mults)
    return {"kernel": name, "shape": shape, "active_rows": active,
            "max_abs_err": err, "ms": cuda_ms(run, reps, inner=10),
            "plain_ms": cuda_ms(run_plain, 3, 1),
            "bound_ms": b_ms, "bound_by": b_by}


def _inv_case(tables, lead, limbs, start, gen, reps, stop=None):
    """K2 through the port's `ntt.inv`, as the evaluator calls it, on the
    limb slice x[..., start:stop, :] of a (*lead, len(limbs), n) tensor (the
    rescale's top limb, the mod-down's special limbs, the mod-raise's limb
    0; start 0, no stop: the whole tensor).  `read_in_place`: the kernel's
    wrapper got the slice itself, not a copy."""
    from fhe_linformer_tpu_torch.ops import ntt, ntt_cuda
    n = tables.n
    full = random_residues(tuple(lead) + (len(limbs), n),
                           [tables.qs[i] for i in limbs], gen, "cuda")
    x = full[..., start:stop, :]
    sub = tuple(limbs[start:stop])
    kernel, seen = ntt_cuda.inv, []

    def spy(y, t, lim):
        seen.append(y.data_ptr() == x.data_ptr() and y.stride() == x.stride())
        return kernel(y, t, lim)
    ntt_cuda.inv = spy
    try:
        got = ntt.inv(x, tables, sub)
    finally:
        ntt_cuda.inv = kernel
    shape = list(x.shape)
    err = _held("ntt_inv", got, ntt.inv_plain(x, tables, sub), shape)
    active, L = x.numel() // n, len(sub)
    # the Shoup butterflies of all but the last stage, then n^-1 folded
    # into the last stage's two outputs: 3 multiplies each
    mults = active * ((n // 2) * (n.bit_length() - 2) + n) * 3
    nbytes = active * n * 8 + L * n * 8
    b_ms, b_by = bound(nbytes, mults)
    return {"kernel": "ntt_inv", "shape": shape,
            "source": list(full.shape), "limbs_from": start,
            "limbs_to": len(limbs) if stop is None else stop,
            "active_rows": active, "read_in_place": seen == [True],
            "max_abs_err": err,
            "ms": cuda_ms(lambda: ntt.inv(x, tables, sub), reps, inner=10),
            "plain_ms": cuda_ms(lambda: ntt.inv_plain(x, tables, sub), 3, 1),
            "bound_ms": b_ms, "bound_by": b_by}


def _bc_case(bc, g_valid, B, prefolded, gen, reps, n=1 << LOG2N):
    from fhe_linformer_tpu_torch.ops import basecvt
    qs = bc.gq[:g_valid].long().cpu().tolist()
    x = random_residues((B, g_valid, n), qs, gen, "cuda")
    if prefolded:        # the mod-down hands in w = x * fold mod p
        f = bc.fold[:g_valid, None].long()
        x = (x.long() * f % bc.gq[:g_valid, None].long()).int()
    tgt = bc.q_out.shape[0]
    err = _held("base_convert", basecvt.base_convert_cuda(x, bc, prefolded),
                basecvt.base_convert_plain(x, bc, prefolded),
                (B, g_valid, bc.nd, tgt))
    # tensor-core operations: one (4 tgt) x (4 alpha_j) product per digit
    # and coefficient, over the digit's own sources (g_valid in all); CUDA
    # core multiplies: the fold (3 per source) and the epilogue's two Shoup
    # steps (6 per output)
    tc_ops = 2 * B * n * (4 * tgt) * (4 * g_valid)
    muls = B * n * ((0 if prefolded else 3 * g_valid) + 6 * bc.nd * tgt)
    nbytes = 4 * B * n * (g_valid + bc.nd * tgt)
    b_ms, b_by = bound(nbytes, muls, tc_ops)
    return {"kernel": "base_convert", "n": n, "B": B, "G": bc.nd * bc.alpha,
            "alpha": bc.alpha, "g_valid": g_valid, "nd": bc.nd, "tgt": tgt,
            "prefolded": prefolded, "max_abs_err": err,
            "ms": cuda_ms(lambda: basecvt.base_convert_cuda(x, bc, prefolded),
                          reps, inner=10),
            "plain_ms": cuda_ms(
                lambda: basecvt.base_convert_plain(x, bc, prefolded), 3, 1),
            "bound_ms": b_ms, "bound_by": b_by}


def _ksmac_case(ctx, nl, B, gen, reps, gather=False, sel=None,
                lead=None):
    """K4 at level nl of `ctx`'s chain: the key inner products of B
    ciphertexts' digits against a random full-basis key (H = 2), or with
    `sel`, a rotation combo's plaintext sums over the key halves' stage-1
    rows (a: (S, *lead, nl + k, n), H = 1); `gather`: through a Galois
    permutation read in place."""
    import torch
    from fhe_linformer_tpu_torch.ops import ksmac
    ks = ctx.ks_tables(nl)
    n, R = ctx.cfg.n, len(ks.tgt_idx)
    tgt = [ctx.basis[i] for i in ks.tgt_idx]
    perm = ctx.galois_perm(ctx.galois_t(5)) if gather else None
    if sel is None:
        nd = ks.bc.nd
        J = nd
        a = random_residues((nd, B, R, n), tgt, gen, "cuda")
        w = tuple(random_residues((nd, len(ctx.basis), n), ctx.basis, gen,
                                  "cuda") for _ in range(2))
        kw = dict(split=nl, w_off=ctx.num_q - nl, perm=perm)
        shape = [nd, B, R, n]
    else:
        J = len(sel)
        a = random_residues((max(sel) + 1,) + tuple(lead) + (R, n), tgt, gen,
                            "cuda")
        w = (random_residues((J, R, n), tgt, gen, "cuda"),)
        kw = dict(sel=sel, perm=perm)
        B = int(np.prod(lead))
        shape = [J, *lead, R, n]
    run = lambda: ksmac.ks_mac_cuda(a, w, ks.q_tgt, **kw)
    err = _held("ks_mac", run(), ksmac.ks_mac_plain(a, w, ks.q_tgt, **kw),
                shape)
    H = len(w)
    # each residue of a read once, each weight row once, each output once;
    # a product is a 32 x 32 -> 64-bit multiply (2 multiplies), a Barrett
    # reduction per 8 products 5 more
    nbytes = 4 * R * n * (J * B + H * J + H * B)
    muls = H * B * R * n * (2 * J + 5 * -(-J // 8))
    b_ms, b_by = bound(nbytes, muls)
    return {"kernel": "ks_mac", "n": n, "nl": nl, "rows": R, "J": J, "B": B,
            "H": H, "gather": gather, "shape": shape, "max_abs_err": err,
            "ms": cuda_ms(run, reps, inner=10),
            "plain_ms": cuda_ms(lambda: ksmac.ks_mac_plain(
                a, w, ks.q_tgt, **kw), 3, 1),
            "bound_ms": b_ms, "bound_by": b_by}


def _moddown_case(ctx, nl, lead, half_dim, gen, reps):
    """K5 at level nl of `ctx`'s chain on x (*lead, nl + k, n) with its key
    halves on `half_dim` and a c0 addend on half 0, as the evaluator sends
    it: each entry point held exactly against its plain version and timed
    beside it, then the whole mod-down (K2, md_fold, K3, md_lift, K1,
    md_finish) against the plain route on the card (K1-K3 and the torch
    chain).  One row per entry point, then a `mod_down` row."""
    from fhe_linformer_tpu_torch.ops import moddown, ntt
    from fhe_linformer_tpu_torch.ops.basecvt import base_convert
    ks = ctx.ks_tables(nl)
    n, k = ctx.cfg.n, ctx.k_sp
    x = random_residues(tuple(lead) + (nl + k, n),
                        [ctx.basis[i] for i in ks.tgt_idx], gen, "cuda")
    rest = tuple(lead[:half_dim]) + tuple(lead[half_dim + 1:])
    add = (random_residues(rest + (nl, n), ctx.qs[:nl], gen, "cuda"), None)
    B = x.numel() // ((nl + k) * n)
    vp = ntt.inv(x[..., nl:, :], ctx.ntt, ks.sp_idx)
    w, v = moddown.md_fold_plain(vp, ks)
    y = base_convert(w, ks.md, prefolded=True)[0]
    y_e = ntt.fwd(moddown.md_lift_plain(y, v, ks), ctx.ntt, ks.act_idx)
    shape = [*lead, nl + k, n]
    got_w, got_v = moddown.md_fold(vp, ks)
    errs = {"md_fold": max(_held("md_fold", got_w, w, shape),
                           _held("md_fold", got_v, v, shape)),
            "md_lift": _held("md_lift", moddown.md_lift(y.clone(), v, ks),
                             moddown.md_lift_plain(y, v, ks), shape),
            "md_finish": _held(
                "md_finish", moddown.md_finish(x, y_e, ks, add, half_dim),
                moddown.md_finish_plain(x, y_e, ks, add, half_dim), shape),
            "mod_down": _held(
                "mod_down", moddown.mod_down_cuda(x, ctx.ntt, ks, add,
                                                  half_dim),
                moddown.mod_down_plain(x, ctx.ntt, ks, add, half_dim),
                shape)}
    # each residue read once and written once (4 bytes); multiplies: a
    # Shoup product is 3, the fold's two partial products 2 more
    work = {"md_fold": (4 * B * n * (2 * k + 1), 5 * B * n * k,
                        lambda: moddown.md_fold(vp, ks),
                        lambda: moddown.md_fold_plain(vp, ks)),
            "md_lift": (4 * B * n * (2 * nl + 1), 3 * B * n * nl,
                        lambda: moddown.md_lift(y, v, ks),
                        lambda: moddown.md_lift_plain(y, v, ks)),
            "md_finish": (4 * B * n * nl * 3 + 4 * (B // 2) * n * nl,
                          3 * B * n * nl,
                          lambda: moddown.md_finish(x, y_e, ks, add,
                                                    half_dim),
                          lambda: moddown.md_finish_plain(x, y_e, ks, add,
                                                          half_dim))}
    out = []
    for name, (nbytes, muls, run, run_plain) in work.items():
        b_ms, b_by = bound(nbytes, muls)
        out.append({"kernel": name, "n": n, "nl": nl, "k": k, "B": B,
                    "shape": shape, "half_dim": half_dim,
                    "max_abs_err": errs[name],
                    "ms": cuda_ms(run, reps, inner=10),
                    "plain_ms": cuda_ms(run_plain, 3, 1),
                    "bound_ms": b_ms, "bound_by": b_by})
    out.append({"kernel": "mod_down", "n": n, "nl": nl, "k": k, "B": B,
                "shape": shape, "half_dim": half_dim,
                "max_abs_err": errs["mod_down"],
                "k5_ms": sum(r["ms"] for r in out),
                "k5_bound_ms": sum(r["bound_ms"] for r in out),
                "ms": cuda_ms(lambda: moddown.mod_down_cuda(
                    x, ctx.ntt, ks, add, half_dim), reps, inner=5),
                "plain_ms": cuda_ms(lambda: moddown.mod_down_plain(
                    x, ctx.ntt, ks, add, half_dim), 3, 1)})
    return out


def _ring16_cases(ctx, gen):
    """The kernels at ring 2^16 (linformer-128c), at the shapes of phase
    ring16's batch-2 bootstrap: its mod-raise (K2 on limb 0 read in place,
    K1 on the 47 limbs) and the top-level decomposition's digit map; its
    most launched classes (launch_shapes of a warm bootstrap): K1 on 168
    and 232 rows (8 plaintexts over 21 and 29 limbs, 21 and 19 launches),
    K2 on the rescale of 4 ciphertexts (8 rows of one limb, 117) and on
    their mod-down's specials (8 x 16 rows, 37), K3's batch-4 decomposition
    at level 33 and its mod-down (8 each)."""
    top, mid = ctx.ks_tables(ctx.num_q), ctx.ks_tables(33)
    n = ctx.cfg.n
    return [_inv_case(ctx.ntt, (2,), top.act_idx, 0, gen, 20, stop=1),
            _fwd_case(ctx.ntt, 2, ctx.num_q, gen, 20),
            _fwd_case(ctx.ntt, 2, None, gen, 10, limb_map=top.dig_limbs),
            _fwd_case(ctx.ntt, 8, 21, gen, 20),
            _fwd_case(ctx.ntt, 8, 29, gen, 20),
            _inv_case(ctx.ntt, (2, 4), mid.act_idx, 32, gen, 20),
            _inv_case(ctx.ntt, (2, 4), mid.act_idx + mid.sp_idx, 33, gen,
                      20),
            _bc_case(mid.bc, 33, 4, False, gen, 20, n=n),
            _bc_case(mid.md, ctx.k_sp, 8, True, gen, 20, n=n)]


def phase_kernels(ctx, tiny, ring16):
    """Each kernel against its plain version on the card, at the shapes the
    main paths send it (`tiny`: the CLI phase's context, ring 2^8;
    `ring16`: the ring16 phase's, linformer-128c at 2^16).  Returns the
    main-shape numbers per kernel for the final `kernels` line, and every
    row."""
    import torch
    from fhe_linformer_tpu_torch.ops.ntt import NttTables
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    L = ctx.num_q + ctx.k_sp                       # 79: the key switch's basis
    nl = ctx.num_q
    ks = ctx.ks_tables(nl)
    # the forward's key switches: batch 8 (HEAVY_CHUNK) from level 57 down,
    # mod-downs of both halves (batch 16); low levels reach partly filled
    # last digit groups at batch 1 (phase 4's launch_shapes)
    fw = ctx.ks_tables(57)
    low = ctx.ks_tables(22)              # digits of 20 + 2 limbs, tgt 42
    small = NttTables(1 << 11, ctx.basis[:L], "cuda")
    full = tuple(range(L))
    act57, ext57 = fw.act_idx, fw.act_idx + fw.sp_idx
    act59 = ks.act_idx
    pair = ctx.ks_tables(52)             # EvalMod's first key switches
    em45 = ctx.ks_tables(45)             # EvalMod's most frequent level
    lo10 = ctx.ks_tables(10)             # the bootstrapped circuit's floor
    rows = [_fwd_case(ctx.ntt, 4, L, gen, 20),
            _inv_case(ctx.ntt, (4,), full, 0, gen, 20),
            _fwd_case(ctx.ntt, 8, None, gen, 10, limb_map=fw.dig_limbs),
            _fwd_case(small, 4, L, gen, 20),
            _inv_case(small, (4,), full, 0, gen, 20),
            # K2 on the forward (phase 4's launch_shapes): a batch-8 key
            # switch at level 57 (the decomposition's input, the mod-down's
            # special limbs of both halves), the mod-down of 1 ciphertext,
            # the rescales of 1, 4 and 8 ciphertexts (the top limb of c0
            # and c1)
            _inv_case(ctx.ntt, (8,), act57, 0, gen, 20),
            _inv_case(ctx.ntt, (2, 8), ext57, 57, gen, 20),
            _inv_case(ctx.ntt, (2, 1), ext57, 57, gen, 20),
            _inv_case(ctx.ntt, (2, 1), act57, 56, gen, 20),
            _inv_case(ctx.ntt, (2, 4), act57, 56, gen, 20),
            _inv_case(ctx.ntt, (2, 8), act57, 56, gen, 20),
            _bc_case(ks.bc, nl, 4, False, gen, 20),
            _bc_case(fw.bc, 57, 8, False, gen, 20),
            _bc_case(low.bc, 22, 1, False, gen, 20),
            _bc_case(ks.bc, nl, 32, False, gen, 10),
            _bc_case(fw.md, ctx.k_sp, MODDOWN_BATCH, True, gen, 20),
            # the bootstrap (phases 5-6, launch_shapes): mod-raise's K2 on
            # limb 0 of a batch dropped to one limb (the slice of the full
            # chain, read in place) and its K1 on all 59 limbs; the key
            # switches at the top levels, batch 1 (coeffs-to-slots of one
            # ciphertext) and batch 2 (EvalMod's re/im pair); the diagonal
            # plaintexts' K1 over the extended basis, 8 at a time
            _inv_case(ctx.ntt, (4,), act59, 0, gen, 20, stop=1),
            _fwd_case(ctx.ntt, 4, nl, gen, 20),
            _inv_case(ctx.ntt, (1,), act59, 0, gen, 20),
            _bc_case(ks.bc, nl, 1, False, gen, 20),
            _fwd_case(ctx.ntt, 1, None, gen, 10, limb_map=ks.dig_limbs),
            _inv_case(ctx.ntt, (2,), pair.act_idx, 0, gen, 20),
            _bc_case(pair.bc, pair.nl, 2, False, gen, 20),
            _fwd_case(ctx.ntt, 2, None, gen, 10, limb_map=pair.dig_limbs),
            _inv_case(ctx.ntt, (2, 2), pair.act_idx + pair.sp_idx, pair.nl,
                      gen, 20),
            _bc_case(pair.md, ctx.k_sp, 4, True, gen, 20),
            _fwd_case(ctx.ntt, 8, L, gen, 20),
            # the batch-4 bootstrap's most launched classes (phase 5's
            # launch_shapes): K1 on 350, 720 and 688 rows, the EvalMod
            # pair's (batch 8) key switch at level 45
            _fwd_case(ctx.ntt, 14, 25, gen, 20),
            _fwd_case(ctx.ntt, 16, 45, gen, 20),
            _fwd_case(ctx.ntt, 16, 43, gen, 20),
            _bc_case(em45.bc, 45, 8, False, gen, 20),
            _bc_case(em45.md, ctx.k_sp, MODDOWN_BATCH, True, gen, 20),
            _inv_case(ctx.ntt, (2, 8), em45.act_idx + em45.sp_idx, 45, gen,
                      20),
            # the bootstrapped request's most launched classes (phase 6's
            # launch_shapes): K1 on 480, 160 and 12 rows; K2 on the rescale
            # of 2 ciphertexts (4 rows of 1 limb) and a batch-8
            # decomposition input at level 10; K3's batch-8 key switch at
            # levels 10 and 9 and its mod-down
            _fwd_case(ctx.ntt, 16, 30, gen, 20),
            _fwd_case(ctx.ntt, 16, 10, gen, 20),
            _fwd_case(ctx.ntt, 1, 12, gen, 20),
            _inv_case(ctx.ntt, (2, 2), lo10.act_idx, 9, gen, 20),
            _inv_case(ctx.ntt, (8,), lo10.act_idx, 0, gen, 20),
            _bc_case(lo10.bc, 10, 8, False, gen, 20),
            _bc_case(lo10.md, ctx.k_sp, MODDOWN_BATCH, True, gen, 20),
            _bc_case(ctx.ks_tables(9).bc, 9, 8, False, gen, 20),
            # the per-token path's most launched classes (phase 7's
            # launch_shapes): K1 on a batch-8 decomposition at level 45
            # (1,560 rows: 3 digits x 8 x 65) and on 30 rows; K2 on the
            # rescale of 16 ciphertexts (32 rows of one limb, in place) and
            # a batch-8 decomposition input at level 45; K3's batch-1 key
            # switch at level 21 and batch-8 ones at levels 17 and 22
            _fwd_case(ctx.ntt, 8, None, gen, 10, limb_map=em45.dig_limbs),
            _fwd_case(ctx.ntt, 1, 30, gen, 20),
            _inv_case(ctx.ntt, (2, 16), ctx.ks_tables(30).act_idx, 29, gen,
                      20),
            _inv_case(ctx.ntt, (8,), em45.act_idx, 0, gen, 20),
            _bc_case(ctx.ks_tables(21).bc, 21, 1, False, gen, 20),
            _bc_case(ctx.ks_tables(17).bc, 17, 8, False, gen, 20),
            _bc_case(low.bc, 22, 8, False, gen, 20),
            # the device slot decrypt (decrypt_slots_device, phases 4, 6
            # and 7): the inverse NTT of c0 + c1 s over the first 3 limbs
            # of one output ciphertext (the packed pooler keeps chunk 0, so
            # its output is one ciphertext, as config 5's)
            _inv_case(ctx.ntt, (), (0, 1, 2), 0, gen, 20)]
    # K4: first the per-token FFN's key switch (level 22, batch 8; the
    # main shape), then the same through a Galois gather, the top and
    # bottom of the bootstrapped chain, one ciphertext's hoisted rotation,
    # and the packed combo's plaintext sums over 16 babies (the key halves
    # of 1 and 8 ciphertexts); then ring 2^8 (8 digits) and ring 2^16
    rows += [_ksmac_case(ctx, 22, 8, gen, 20),
             _ksmac_case(ctx, 22, 8, gen, 20, gather=True),
             _ksmac_case(ctx, 59, 8, gen, 20),
             _ksmac_case(ctx, 7, 8, gen, 20),
             _ksmac_case(ctx, 12, 1, gen, 20, gather=True),
             _ksmac_case(ctx, 22, 1, gen, 20, sel=list(range(15, -1, -1)),
                         lead=(2, 1)),
             _ksmac_case(ctx, 22, 8, gen, 20, sel=list(range(0, 32, 2)),
                         lead=(2, 8)),
             _ksmac_case(tiny, tiny.num_q, 8, gen, 20),
             _ksmac_case(ring16, 22, 2, gen, 20, gather=True)]
    # K5: first the per-token cell's most frequent mod-down (level 23, 8
    # ciphertexts' two halves, a c0 addend; the censuses of
    # port_bench/cells/), then level 22, the packed cells' level 10 and
    # their combos' level 24 (16 groups of 2 and of 6 halves, halves on
    # axis 1), and the bootstrap's level 57 at batch 16
    for nl, lead, hd in ((23, (2, 8), 0), (22, (2, 8), 0), (10, (2, 8), 0),
                         (24, (16, 2, 2), 1), (24, (16, 2, 6), 1),
                         (57, (2, 16), 0)):
        rows += _moddown_case(ctx, nl, lead, hd, gen, 20)
    # the CLI phase's ring 2^8 (preset tiny): the one-block-per-row K1/K2
    # on a batch-8 key switch's rows at the top level (59 + 8 limbs, the
    # digit map), the rescale's top limb read in place, and K3's
    # decomposition and mod-down
    tk = tiny.ks_tables(tiny.num_q)
    rows += [_fwd_case(tiny.ntt, 8, len(tiny.basis), gen, 20),
             _fwd_case(tiny.ntt, 8, None, gen, 10, limb_map=tk.dig_limbs),
             _inv_case(tiny.ntt, (8,), tk.act_idx, 0, gen, 20),
             _inv_case(tiny.ntt, (2, 8), tk.act_idx, tiny.num_q - 1, gen, 20),
             _bc_case(tk.bc, tiny.num_q, 8, False, gen, 20, n=tiny.cfg.n),
             _bc_case(tk.md, tiny.k_sp, MODDOWN_BATCH, True, gen, 20,
                      n=tiny.cfg.n)]
    rows += _ring16_cases(ring16, gen)
    rows += _parallel_cases(gen)
    main = {}
    for r in rows:
        emit({"phase": "kernels", **r})
        main.setdefault(r["kernel"], r)       # each kernel's first case
    return main, rows


# ---------------------------------------------------------------------------
# phase 3


def _keys_to(keys, device):
    """A KeySet with every tensor copied to `device`."""
    from fhe_linformer_tpu_torch.ckks.keys import (KeySet, KSKey, PublicKey,
                                                   SecretKey)
    ks = lambda k: None if k is None else KSKey(
        k.b.to(device), k.a.to(device), k.a_seed, k.max_nl)
    return KeySet(SecretKey(keys.sk.coeffs, keys.sk.eval_full.to(device)),
                  PublicKey(keys.pk.p0.to(device), keys.pk.p1.to(device)),
                  ks(keys.relin), {r: ks(k) for r, k in keys.rot.items()},
                  ks(keys.conj))


def phase_keyswitch():
    """The CLI's `bench` case (fhe_linformer_tpu_torch.bench): one Galois
    key switch at N = 2^15, 24 limbs, dnum 3, batch 4, timed here behind
    the device sleep; then rotate_hoisted on the same ciphertext for a few
    shifts, held bit for bit against the port's CPU path, with its ms per
    shift beside rotate's; then the reduced-basis switch
    (`_reduced_keyswitch`) and the chunked batch ops (`_chunked_ops`)."""
    import torch
    from fhe_linformer_tpu_torch.bench import keyswitch_case
    from fhe_linformer_tpu_torch.ckks.context import Context
    from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
    shifts = (1, 2, 3)
    switch, ev, ct, z = keyswitch_case("cuda", rotations=shifts)
    ms = cuda_ms(switch, reps=20)
    # a fresh encryption already decrypts with ~7e-3 max slot error here
    # (dense ternary secret, scale 2^26); the switch may add little to it
    fresh = float(np.abs(np.real(ev.decrypt(ct)) - z).max())
    got = np.real(ev.decrypt(ev.rotate(ct, 1)))
    err = float(np.abs(got - np.roll(z, -1, axis=-1)).max())
    if not err < 2 * fresh:
        raise AssertionError(f"rotation by 1 decrypts with error {err}, "
                             f"a fresh encryption with {fresh}")
    hoisted = ev.rotate_hoisted(ct, shifts)
    t = time.perf_counter()
    cpu = Evaluator(Context(ev.ctx.cfg, "cpu"), _keys_to(ev.keys, "cpu"))
    ct_cpu = ct.with_data(ct.c0.cpu(), ct.c1.cpu())
    want = cpu.rotate_hoisted(ct_cpu, shifts)
    cpu_s = time.perf_counter() - t
    for r in shifts:
        if not (torch.equal(hoisted[r].c0.cpu(), want[r].c0)
                and torch.equal(hoisted[r].c1.cpu(), want[r].c1)):
            raise AssertionError(f"rotate_hoisted by {r} differs from the "
                                 "CPU path")
    hoisted_ms = cuda_ms(lambda: ev.rotate_hoisted(ct, shifts), reps=10)
    emit({"phase": "keyswitch", "n": ev.ctx.cfg.n, "limbs": ct.nl,
          "dnum": ev.ctx.cfg.dnum, "batch": ct.c0.shape[0], "ms": ms,
          "keyswitches_per_s": ct.c0.shape[0] / ms * 1e3,
          "fresh_decrypt_err": fresh, "rotate_decrypt_err": err,
          "rotate_ms": cuda_ms(lambda: ev.rotate(ct, 1), reps=20),
          "rotate_hoisted_shifts": list(shifts),
          "rotate_hoisted_ms_per_shift": hoisted_ms / len(shifts),
          "rotate_hoisted_equals_cpu": True, "cpu_path_s": cpu_s})
    del switch, ev, ct, cpu
    _reduced_keyswitch()
    _chunked_ops()


def _chunked_ops(nl=16, batch=128):
    """A plaintext product with its rescale, and a rescale, on a batch of
    128 ciphertexts (config 5's FFN batch) at N = 2^15 on preset
    multi-layer's chain: in chunks of heavy_chunk ciphertexts, as the
    evaluator runs them, against one call over the whole batch
    (heavy_chunk = batch), timed in turns (whole, chunked, chunked, whole),
    the outputs held equal, each one's peak memory above its inputs."""
    import torch
    from fhe_linformer_tpu_torch.ckks.context import Context
    from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
    from fhe_linformer_tpu_torch.ckks.keys import generate_keys
    from fhe_linformer_tpu_torch.config import get
    ctx = Context(get("multi-layer").ckks)
    ev = Evaluator(ctx, generate_keys(ctx))
    chunk = ev.heavy_chunk
    rng = np.random.default_rng(0)
    ct = ev.encrypt(rng.uniform(-1, 1, (batch, ctx.cfg.slots)), nl=nl,
                    batch=True)
    pt = ev.encode(rng.uniform(-1, 1, ctx.cfg.slots), nl=nl)
    line = {"phase": "chunked_ops", "preset": "multi-layer",
            "n": ctx.cfg.n, "limbs": nl, "batch": batch, "chunk": chunk}
    for name, op in (("mul_plain", lambda: ev.mul_plain(ct, pt)),
                     ("rescale", lambda: ev.rescale(ct))):
        ms, peak_gb, outs = {"whole": [], "chunked": []}, {}, {}
        for mode in ("whole", "chunked", "chunked", "whole"):
            ev.heavy_chunk = batch if mode == "whole" else chunk
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            outs[mode] = op()
            torch.cuda.synchronize()
            peak_gb[mode] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            ms[mode].append(cuda_ms(op, reps=10))
        a, b = outs["whole"], outs["chunked"]
        if not (torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)):
            raise AssertionError(f"{name} in chunks differs from one call")
        line[name] = {"ms": ms, "peak_gb": peak_gb,
                      "chunked_over_whole_ms": float(np.mean(ms["chunked"])
                                                     / np.mean(ms["whole"]))}
        del outs, a, b
    ev.heavy_chunk = chunk
    emit(line)


def _reduced_max_nl(preset) -> int:
    return preset.ckks.num_scaling - BOOT_CONSUMED_WIDE + 3


def _reduced_keyswitch(nl=24, batch=4):
    """The phase's Galois key switch (N = 2^15, 24 limbs, dnum 3, batch 4)
    on preset multi-layer's chain (59 q-limbs + 20 special), as config 5's
    reference key set holds its keys: a rotation by 1 with a full-basis key
    (79 rows) and by -1 with a reduced-basis key at max_nl 25 (45 rows),
    timed in turns (full, reduced, reduced, full) and each held bit for bit
    against the port's CPU path; key MB side by side."""
    import torch
    from fhe_linformer_tpu_torch.ckks import evaluator as evm
    from fhe_linformer_tpu_torch.ckks.context import Context
    from fhe_linformer_tpu_torch.ckks.keys import generate_keys
    from fhe_linformer_tpu_torch.config import get
    preset = get("multi-layer")
    ctx = Context(preset.ckks)
    max_nl = _reduced_max_nl(preset)
    keys = generate_keys(ctx, rotations=(1,), rotations_reduced=(-1,),
                         reduced_max_nl=max_nl)
    ev = evm.Evaluator(ctx, keys)
    z = np.random.default_rng(0).uniform(-1, 1, (batch, ctx.cfg.slots))
    ct = ev.encrypt(z, nl=nl, batch=True)
    ks = ctx.ks_tables(nl)
    switch = {r: functools.partial(evm._galois_core, ctx, ct.c0, ct.c1,
                                   ev._perm(r), keys.rot[r], ks)
              for r in (1, -1)}
    ms = {1: [], -1: []}
    for r in (1, -1, -1, 1):
        ms[r].append(cuda_ms(switch[r], reps=20))
    t = time.perf_counter()
    cpu = evm.Evaluator(Context(ctx.cfg, "cpu"), _keys_to(keys, "cpu"))
    c0, c1 = ct.c0.cpu(), ct.c1.cpu()
    cks = cpu.ctx.ks_tables(nl)
    for r in (1, -1):
        got = switch[r]()
        want = evm._galois_core(cpu.ctx, c0, c1, cpu._perm(r),
                                cpu.keys.rot[r], cks)
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"the key switch by {r} (max_nl "
                                 f"{keys.rot[r].max_nl}) differs from the "
                                 "CPU path")
    cpu_s = time.perf_counter() - t
    fresh = float(np.abs(np.real(ev.decrypt(ct)) - z).max())
    err = float(np.abs(np.real(ev.decrypt(ev.rotate(ct, -1)))
                       - np.roll(z, 1, axis=-1)).max())
    if not err < 2 * fresh:
        raise AssertionError(f"the reduced-key rotation decrypts with error "
                             f"{err}, a fresh encryption with {fresh}")
    mb = {r: (k.b.numel() + k.a.numel()) * k.b.element_size() / 1e6
          for r, k in keys.rot.items()}
    emit({"phase": "keyswitch_reduced", "preset": preset.name,
          "n": ctx.cfg.n, "num_q": ctx.num_q, "k_sp": ctx.k_sp,
          "limbs": nl, "dnum": ctx.cfg.dnum, "batch": batch,
          "full": {"shift": 1, "rows": keys.rot[1].b.shape[1],
                   "key_mb": mb[1], "ms": ms[1]},
          "reduced": {"shift": -1, "max_nl": keys.rot[-1].max_nl,
                      "rows": keys.rot[-1].b.shape[1], "key_mb": mb[-1],
                      "ms": ms[-1]},
          "reduced_over_full_ms": float(np.mean(ms[-1]) / np.mean(ms[1])),
          "equal_to_cpu_path": True, "cpu_path_s": cpu_s,
          "fresh_decrypt_err": fresh, "rotate_decrypt_err": err})


# ---------------------------------------------------------------------------
# phase 4


def _rotations(slots: int, d: int = 128, bs: int = 16) -> tuple[int, ...]:
    """The packed circuit's rotation keys without the bootstrap's: +/-2^i
    for the rotate-accumulate trees and the BSGS shifts of a d x d block
    matmul (its main diagonals u and wrap diagonals u - d)."""
    from fhe_linformer_tpu_torch.linalg.packed import PackedOps
    rots, s = set(), 1
    while s < slots:
        rots |= {s, -s}
        s *= 2
    offsets = list(range(d)) + [(u - d) % slots for u in range(1, d)]
    for r in PackedOps.bsgs_required_rotations(offsets, bs, slots):
        rots.add(r if r < slots // 2 else r - slots)
    return tuple(sorted(rots))


def _calibrated(golden, w, embs, degree=27, tanh_degree=27):
    """bench_layer.py's CircuitParams rule (exp_pow8=False; degree 27
    without the bootstrap, 119 and a degree-247 tanh with it), taken over
    every request's golden intermediates."""
    from fhe_linformer_tpu_torch.models.circuit import CircuitParams
    inters = [golden.forward(w, e, return_intermediates=True)[1] for e in embs]
    rowsums = np.concatenate([i["exp"].sum(-1) for i in inters])
    h = max(np.abs(i["norm1"] @ w.W1.T + w.B1[None]).max() for i in inters)
    p = max(np.abs(i["norm2"][:1] @ w.Wp.T + w.bp[None]).max() for i in inters)
    return CircuitParams(inv_range=(0.5 * rowsums.min(), 1.5 * rowsums.max()),
                         inv_degree=degree, gelu_degree=degree,
                         tanh_degree=tanh_degree,
                         gelu_clip=1.0 / (1.2 * h), tanh_scale=1.0 / (1.2 * p),
                         exp_pow8=False), inters


def _device_breakdown(run):
    """One traced call of run() under torch.profiler: device time per
    kernel of the port, the other kernels' time (the plain torch ops), and
    the share of the wall time the device sat idle.  Also returns each
    port kernel's launch times (ms) in the order they ran.  Only device
    activity is recorded: the host-side op events would double what the
    profiler keeps and parses (minutes at config 5's 0.8 M launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    ours = {k: {"ms": 0.0, "count": 0}
            for k in KERNELS}
    other: dict = {}
    runs = {k: [] for k in ours}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        key = next((k for k in ours if f"{k}_kernel" in e.name), None)
        row = ours[key] if key else other.setdefault(
            e.name[:100], {"ms": 0.0, "count": 0})
        row["ms"] += ms
        row["count"] += 1
        if key:
            runs[key].append((e.time_range.start, ms))
    busy = sum(r["ms"] for r in ours.values()) + \
        sum(r["ms"] for r in other.values())
    top = sorted(other.items(), key=lambda kv: -kv[1]["ms"])[:10]
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "port_kernels": ours,
            "other_kernels_ms": sum(r["ms"] for r in other.values()),
            "other_kernel_launches": sum(r["count"] for r in other.values()),
            "top_other": [{"name": k, **v} for k, v in top]}, \
        {k: [ms for _, ms in sorted(v)] for k, v in runs.items()}


@contextlib.contextmanager
def _shape_census():
    """Records each kernel wrapper's calls by shape, in order, while the
    block runs: K1 by (rows, limb-map entries), K2 by (rows, limbs), K3 by
    (batch, g_valid, nd, tgt, prefolded), K5's entries by (batch, rows)
    and md_finish by (batch, nl, addends).  Yields {kernel: [shape,
    ...]}."""
    from fhe_linformer_tpu_torch.ops import basecvt, moddown, ntt_cuda
    from fhe_linformer_tpu_torch.ops.ntt import is_limb_map
    seen = {k: [] for k in KERNELS}
    orig = (ntt_cuda.fwd, ntt_cuda.inv, basecvt.base_convert_cuda)
    k5 = (moddown.md_fold, moddown.md_lift, moddown._finish)
    rows = lambda x: (x.numel() // (x.shape[-2] * x.shape[-1]), x.shape[-2])

    def fold(vp, ks):
        seen["md_fold"].append(rows(vp))
        return k5[0](vp, ks)

    def lift(y, v, ks):
        seen["md_lift"].append(rows(y))
        return k5[1](y, v, ks)

    def finish(x, y_e, ks, args):
        seen["md_finish"].append(rows(y_e) + (
            sum(a is not None for a in args[3]),))
        return k5[2](x, y_e, ks, args)

    def fwd(x, t, limbs):
        seen["ntt_fwd"].append((x.numel() // t.n,
                                len(limbs) if is_limb_map(limbs) else 1))
        return orig[0](x, t, limbs)

    def inv(x, t, limbs):
        seen["ntt_inv"].append((x.numel() // t.n, x.shape[-2]))
        return orig[1](x, t, limbs)

    def bc(x, tables, prefolded=False):
        g, n = x.shape[-2:]
        seen["base_convert"].append((x.numel() // (g * n), g, tables.nd,
                                     tables.q_out.shape[0], prefolded))
        return orig[2](x, tables, prefolded)

    ntt_cuda.fwd, ntt_cuda.inv, basecvt.base_convert_cuda = fwd, inv, bc
    moddown.md_fold, moddown.md_lift, moddown._finish = fold, lift, finish
    try:
        yield seen
    finally:
        ntt_cuda.fwd, ntt_cuda.inv, basecvt.base_convert_cuda = orig
        moddown.md_fold, moddown.md_lift, moddown._finish = k5


def _by_shape(calls, runs):
    """{kernel: [[shape, launches, device ms], ...]}, most launches first:
    the traced launches matched to the wrapper calls in order (device ms
    None where the two counts differ)."""
    out = {}
    for k, seq in calls.items():
        times = runs.get(k, [])
        matched = len(times) == len(seq)
        agg: dict = {}
        for i, shape in enumerate(seq):
            row = agg.setdefault(shape, [0, 0.0])
            row[0] += 1
            row[1] += times[i] if matched else 0.0
        out[k] = [[list(s), n, ms if matched else None]
                  for s, (n, ms) in sorted(agg.items(), key=lambda kv: -kv[1][0])]
    return out


def _stage(log, name, fn, *args, **kw):
    """fn(*args, **kw) timed behind a synchronize, with the key switches,
    combo rotations and bootstrapped ciphertexts it counted."""
    import torch
    from fhe_linformer_tpu_torch.utils.timing import GLOBAL_TIMERS
    c0 = dict(GLOBAL_TIMERS.counts)
    t = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    log[name] = {
        "s": time.perf_counter() - t,
        **{k: GLOBAL_TIMERS.counts[k] - c0.get(k, 0)
           for k in ("keyswitch", "combo_rot", "bootstrap")},
        "out_nl": out.nl}
    return out


def _encoder(circ, emb, log, boot=None, input_nl=None):
    """The encoder layer of one request (PackedLinformer.forward split
    where its stages meet): encrypt at input_nl limbs, attention, affine1,
    ffn_gelu, affine2.  Returns the layer's output ciphertext (one per
    chunk)."""
    import torch
    ev, w = circ.ev, circ.w

    def affine2(a, y, S_total):
        am, ym = ev.match(a, y)
        return circ.affine(ev.add(am, ym), w.a2, w.b2, w.c2, S_total)
    t = time.perf_counter()
    x, xe, xf, S_total = circ.encrypt_inputs(emb, nl=input_nl)
    torch.cuda.synchronize()
    log["encrypt"] = {"s": time.perf_counter() - t, "in_nl": x.nl}
    a = _stage(log, "attention", circ.attention, x, xe, xf, S_total,
               boot=boot)
    a = _stage(log, "affine1", circ.affine, a, w.a1, w.b1, w.c1, S_total)
    y = _stage(log, "ffn_gelu", circ.ffn, a, boot=boot)
    return _stage(log, "affine2", affine2, a, y, S_total)


def _answer(circ, emb, log, boot=None, input_nl=None):
    """One request: the encoder layer (_encoder), pooler_classifier,
    decrypt.  Returns the logits, the chunk count and the output
    ciphertext."""
    r = _encoder(circ, emb, log, boot, input_nl)
    out = _stage(log, "pooler_classifier", circ.pooler_classifier, r,
                 boot=boot)
    t = time.perf_counter()
    logits = circ.decrypt_logits(out)
    log["decrypt"] = {"s": time.perf_counter() - t}
    return logits, int(r.c0.shape[0]), out


def _device_logits(ev, out, want, host, stride=1) -> dict:
    """decrypt_slots_device of the logit slots (slot i * stride of the
    output ciphertext) beside the host decrypt's logits `host`: seconds,
    max |err| against golden and against the host decrypt, argmax."""
    idx = [i * stride for i in range(len(want))]
    t = time.perf_counter()
    dev = ev.decrypt_slots_device(out, idx).astype(np.float64)
    s = time.perf_counter() - t
    dev = dev.reshape(-1, len(idx))[0]
    return {"s": s, "out_nl": out.nl, "log2_scale": float(np.log2(out.scale)),
            "finite": bool(np.all(np.isfinite(dev))),
            "max_abs_err_vs_golden": float(np.max(np.abs(dev - want))),
            "max_abs_err_vs_host": float(np.max(np.abs(dev - host))),
            "argmax": int(np.argmax(dev))}


def _check_device_logits(what, dev, host):
    if not (dev["finite"] and dev["max_abs_err_vs_host"] <= 0.05
            and dev["argmax"] == int(np.argmax(host))):
        raise AssertionError(f"{what}: decrypt_slots_device {dev} against "
                             f"the host decrypt's logits {host}")


def _request(phase, circ, emb, want, caches, boot=None, input_nl=None,
             **extra):
    """Answers one request, emits its line and fails unless the logits
    match the golden model's (argmax equal, max |err| <= 0.05)."""
    import torch
    from fhe_linformer_tpu_torch.utils.timing import KERNEL_LAUNCHES
    torch.cuda.reset_peak_memory_stats()
    before = dict(KERNEL_LAUNCHES)
    log: dict = {}
    logits, chunks, out = _answer(circ, emb, log, boot, input_nl)
    S = emb.shape[0] + 1
    err = float(np.max(np.abs(logits - want)))
    dev = _device_logits(circ.ev, out, want, logits)
    line = {"phase": phase, "S": S, "chunks": chunks,
            "plaintext_caches": caches,
            "request_s": sum(v["s"] for v in log.values()),
            "stages": log,
            "kernel_launches": {k: KERNEL_LAUNCHES[k] - before[k]
                                for k in KERNEL_LAUNCHES},
            "argmax": int(np.argmax(logits)),
            "golden_argmax": int(np.argmax(want)),
            "max_abs_logit_err": err,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 2 ** 30,
            "decrypt_slots_device": dev, **extra}
    if boot is not None:
        line["bootstraps"] = sum(v.get("bootstrap", 0) for v in log.values())
    emit(line)
    if not np.all(np.isfinite(logits)) or \
            np.argmax(logits) != np.argmax(want) or not err <= 0.05:
        raise AssertionError(f"S={S}: logits {logits} vs golden {want} "
                             f"(max err {err})")
    _check_device_logits(f"{phase} S={S}", dev, logits)
    return line


def phase_forward():
    """Answers each request twice (caches cold, then warm) and checks the
    logits; returns the kernel launch counts of those answers."""
    import torch
    from fhe_linformer_tpu_torch.ckks.context import Context
    from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
    from fhe_linformer_tpu_torch.ckks.keys import generate_keys
    from fhe_linformer_tpu_torch.config import get
    from fhe_linformer_tpu_torch.models import golden
    from fhe_linformer_tpu_torch.models.circuit_packed import PackedLinformer
    from fhe_linformer_tpu_torch.utils.timing import (KERNEL_LAUNCHES,
                                                      reset_launches)
    t0 = time.perf_counter()
    ctx = Context(get("linformer-boot-w").ckks)
    rots = _rotations(ctx.cfg.slots)
    keys = generate_keys(ctx, rotations=rots)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ev = Evaluator(ctx, keys)
    sizes = (128, 200)
    w = golden.random_weights(d=128, k_lin=32, d_ffn=512, n_classes=20,
                              max_seq=max(sizes) + 4, seed=3, scale=0.3)
    rng = np.random.default_rng(0)
    embs = [rng.normal(0, 0.3, (S - 1, 128)) for S in sizes]
    params, inters = _calibrated(golden, w, embs)
    circ = PackedLinformer(ev, w, params, bs=16)
    emit({"phase": "forward_setup", "basis": len(ctx.basis),
          "rotation_keys": len(rots), "keygen_s": setup_s,
          "memory_allocated_gb": torch.cuda.memory_allocated() / 2 ** 30})
    reset_launches()
    for caches in ("cold", "warm"):
        for emb, inter in zip(embs, inters):
            _request("forward", circ, emb, inter["logits"], caches)
    launches = dict(KERNEL_LAUNCHES)
    with _shape_census() as calls:
        trace, runs = _device_breakdown(lambda: _answer(circ, embs[0], {}))
    emit({"phase": "forward_trace", "S": sizes[0], "plaintext_caches": "warm",
          **trace, "launch_shapes": _by_shape(calls, runs)})
    return launches


# ---------------------------------------------------------------------------
# phases 5 and 6


def _boot_setup(cfg, circuit: bool = False,
                preset: str = "linformer-boot-w"):
    """The preset's context, keys for the bootstrap's rotations (with
    `circuit`, also the packed circuit's) and conjugation, an evaluator
    and a Bootstrapper; with the set-up's seconds and key memory."""
    import torch
    from fhe_linformer_tpu_torch.boot.bootstrap import Bootstrapper
    from fhe_linformer_tpu_torch.ckks.context import Context
    from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
    from fhe_linformer_tpu_torch.ckks.keys import generate_keys
    from fhe_linformer_tpu_torch.config import get
    t0 = time.perf_counter()
    ctx = Context(get(preset).ckks)
    torch.cuda.synchronize()
    context_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    boot_rots = Bootstrapper.rotations_for(ctx.cfg.n, cfg)
    plan_s = time.perf_counter() - t0
    rots = tuple(sorted(set(boot_rots) | set(
        _rotations(ctx.cfg.slots) if circuit else ())))
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    keys = generate_keys(ctx, rotations=rots, conj=True)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    key_gb = (torch.cuda.memory_allocated() - mem0) / 2 ** 30
    ev = Evaluator(ctx, keys)
    t0 = time.perf_counter()
    booter = Bootstrapper(ev, cfg)
    info = {"preset": preset, "n": ctx.cfg.n, "num_q": ctx.num_q,
            "k_sp": ctx.k_sp, "basis": len(ctx.basis), "context_s": context_s,
            "boot_rotation_keys": len(boot_rots),
            "rotation_keys": len(rots), "conjugation_key": True,
            "keys": len(keys.rot) + (keys.relin is not None)
            + (keys.conj is not None),
            "rotations_for_s": plan_s, "keygen_s": keygen_s,
            "key_memory_gb": key_gb,
            "bootstrapper_setup_s": time.perf_counter() - t0,
            "bs": booter.bs,
            "cts_diagonals": [len(d) for d in booter.cts_diags],
            "stc_diagonals": [len(d) for d in booter.stc_diags]}
    return ev, booter, info


def phase_bootstrap():
    """tools/boot_full.py on the port: the wide production bootstrap
    (scale_boost 4) of 4 ciphertexts dropped to one limb, run twice (first,
    warm); precision through the host decrypt; a traced warm bootstrap.
    Fails unless the output has at least 23 limbs and 6.5 bits."""
    import torch
    from fhe_linformer_tpu_torch.boot.bootstrap import BootConfig
    from fhe_linformer_tpu_torch.utils.timing import (KERNEL_LAUNCHES,
                                                      approx_error_log2,
                                                      reset_launches)
    ev, booter, info = _boot_setup(BootConfig.wide_production(scale_boost=4))
    batch = 4
    m = np.random.default_rng(3).uniform(-0.9, 0.9, (batch, ev.ctx.cfg.slots))
    low = ev.drop_to(ev.encrypt(m, batch=True), 1)
    torch.cuda.synchronize()
    reset_launches()
    runs = []
    for label in ("first", "warm"):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = booter.bootstrap(low)
        torch.cuda.synchronize()
        runs.append({"run": label, "s": time.perf_counter() - t,
                     "max_memory_allocated_gb":
                         torch.cuda.max_memory_allocated() / 2 ** 30})
    launches = dict(KERNEL_LAUNCHES)
    prec = approx_error_log2(m, np.real(ev.decrypt_host(out)))
    with _shape_census() as calls:
        trace, traced = _device_breakdown(lambda: booter.bootstrap(low))
    emit({"phase": "bootstrap", **info, "batch": batch,
          "scale_boost": booter.cfg.scale_boost, "runs": runs,
          "out_nl": out.nl, "precision_bits": prec,
          "kernel_launches_per_bootstrap": {k: v / 2
                                            for k, v in launches.items()},
          "reference": REFERENCE_BOOT})
    emit({"phase": "bootstrap_trace", "batch": batch, **trace,
          "launch_shapes": _by_shape(calls, traced)})
    # the JAX record's 23 limbs predate its fused Chebyshev nodes, which
    # save one level: the current code (and the port) leave 24
    if out.nl < REFERENCE_BOOT["out_nl"] or not prec >= 6.5:
        raise AssertionError(f"bootstrap gave nl {out.nl} at {prec} bits")
    return launches


BOOT_FORWARD_SIZES = (128, 700)
# phase 6's circuit, bootstrapper and requests, held for phase native
# (which builds its own when phase 6 did not run) and dropped there
HELD_BOOT_FORWARD: dict = {}


def _boot_forward_circuit(sizes=BOOT_FORWARD_SIZES):
    """Phase 6's production circuit: linformer-boot-w with the circuit's
    and the bootstrap's rotation keys, the wide bootstrap at scale_boost 2,
    random weights of seed 3, an embedding per size and its golden logits.
    Returns (circuit, bootstrapper, set-up info, {S: embedding},
    {S: logits})."""
    from fhe_linformer_tpu_torch.boot.bootstrap import BootConfig
    from fhe_linformer_tpu_torch.models import golden
    from fhe_linformer_tpu_torch.models.circuit_packed import PackedLinformer
    ev, booter, info = _boot_setup(BootConfig.wide_production(),
                                   circuit=True)
    w = golden.random_weights(d=128, k_lin=32, d_ffn=512, n_classes=20,
                              max_seq=max(sizes) + 4, seed=3, scale=0.3)
    embs = {S: np.random.default_rng(0).normal(0, 0.3, (S - 1, 128))
            for S in sizes}
    params, inters = _calibrated(golden, w, list(embs.values()), degree=119,
                                 tanh_degree=247)
    want = {S: i["logits"] for S, i in zip(sizes, inters)}
    return PackedLinformer(ev, w, params, bs=16), booter, info, embs, want


def phase_boot_forward(sizes=BOOT_FORWARD_SIZES):
    """The production path: the bootstrapped packed Linformer with
    bench_layer.py main_packed's boot settings, answering S = 128 (cold,
    warm) and S = 700 (warm), then one traced warm S = 128 request.  Fails
    unless each request matches golden; prints its bootstrapped ciphertexts
    beside the JAX package's records (3 and 13)."""
    import torch
    from fhe_linformer_tpu_torch.utils.timing import (KERNEL_LAUNCHES,
                                                      reset_launches)
    circ, booter, info, embs, want = _boot_forward_circuit(sizes)
    emit({"phase": "boot_forward_setup", **info,
          "scale_boost": booter.cfg.scale_boost,
          "memory_allocated_gb": torch.cuda.memory_allocated() / 2 ** 30})
    reset_launches()
    for S, caches in ((sizes[0], "cold"), (sizes[0], "warm"),
                      (sizes[1], "warm")):
        ref = {"reference_bootstraps": REFERENCE_BOOTSTRAPS[S]}
        if S == 128:
            ref["reference_keyswitches"] = REFERENCE_KEYSWITCHES_S128
        _request("boot_forward", circ, embs[S], want[S], caches,
                 boot=booter, input_nl=12, **ref)
    launches = dict(KERNEL_LAUNCHES)
    with _shape_census() as calls:
        trace, runs = _device_breakdown(
            lambda: _answer(circ, embs[sizes[0]], {}, booter, 12))
    emit({"phase": "boot_forward_trace", "S": sizes[0],
          "plaintext_caches": "warm", **trace,
          "launch_shapes": _by_shape(calls, runs)})
    HELD_BOOT_FORWARD.update(circ=circ, booter=booter, embs=embs, want=want)
    return launches


# ---------------------------------------------------------------------------
# phase native: the host codec and the ReLU gadget

NATIVE_S = 700           # phase 6's request whose encoder output is saved
NATIVE_LIFT_LIMBS = 3    # the host decrypt's default crt_limbs
RELU = {"batch": 4, "degree": 119, "max_err": 0.05}


def phase_native():
    """The host codec (csrc/fastio.cpp, built by g++, through io/native.py)
    on phase 6's production path, and Gadgets.relu on the card:
      * the g++ build's seconds (phase card builds it beside the kernels);
      * the S = 700 request's encoder output (6 chunks) lifted from its
        first 3 limbs by the native lifter and by the Python-int lift:
        equal bit for bit, with each one's ms;
      * that output saved as a checkpoint with native pages, loaded, and
        the request resumed from it (pooler_classifier with its
        bootstrap): the output ciphertext equal bit for bit to the one
        without the round trip, the logits against golden; bytes, save and
        load seconds; a copy with one flipped byte raises the CRC error;
      * Gadgets.relu (degree 119) on 4 fresh ciphertexts of
        default_rng(3).uniform(-1, 1): seconds, key switches, the host
        decrypt's error against cheb_eval of the same fit (fails above
        0.05) and against max(x, 0).
    Reuses phase 6's circuit when that phase ran; returns the kernel
    launches of the resumed request and the ReLU."""
    import shutil
    import torch
    from fhe_linformer_tpu_torch.ckks.encoding import \
        crt_lift_center as python_int_lift
    from fhe_linformer_tpu_torch.convert import ciphertext_to_numpy
    from fhe_linformer_tpu_torch.io import native, serialize
    from fhe_linformer_tpu_torch.ops import cuda_build
    from fhe_linformer_tpu_torch.poly import Gadgets, cheb, cheb_eval
    from fhe_linformer_tpu_torch.utils.timing import (GLOBAL_TIMERS,
                                                      KERNEL_LAUNCHES,
                                                      reset_launches)
    if "fastio" in BUILD_REPORT:
        build = {"s": BUILD_REPORT["fastio"]["seconds"], "in": "card"}
    else:
        build = {"s": cuda_build.build(("fastio",))["fastio"]["seconds"],
                 "in": "native"}
    build["library"] = os.path.relpath(cuda_build.library_path("fastio"),
                                       os.path.dirname(
                                           os.path.abspath(__file__)))
    if HELD_BOOT_FORWARD:
        circ, booter, embs, want = (HELD_BOOT_FORWARD.pop(k) for k in
                                    ("circ", "booter", "embs", "want"))
        setup = "phase boot_forward's"
    else:
        circ, booter, _, embs, want = _boot_forward_circuit()
        setup = "built here"
    ev = circ.ev
    log: dict = {}
    r = _encoder(circ, embs[NATIVE_S], log, booter, 12)

    # the host decrypt's lift, both ways, on the encoder output
    m = min(NATIVE_LIFT_LIMBS, r.nl)
    coeffs = ev._coeff_residues(ev.drop_to(r, m), "the lift").cpu().numpy()
    flat = np.ascontiguousarray(np.moveaxis(coeffs, -2, 0).reshape(m, -1),
                                np.uint32)
    qs = ev.ctx.qs[:m]
    native.crt_lift_center(flat[:, :8], qs)        # the library loaded
    t = time.perf_counter()
    lifted = native.crt_lift_center(flat, qs)
    native_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    exact = python_int_lift(flat, qs)
    python_ms = (time.perf_counter() - t) * 1e3
    lift = {"ciphertexts": int(np.prod(coeffs.shape[:-2])), "limbs": m,
            "coefficients": int(flat.shape[1]), "native_ms": native_ms,
            "python_int_ms": python_ms,
            "log2_max_abs": float(np.log2(np.abs(exact).max())),
            "bit_equal": bool(np.array_equal(lifted.view(np.uint64),
                                             exact.view(np.uint64)))}

    # the checkpoint round trip, and the request resumed from it
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_native")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, f"encoder_S{NATIVE_S}.ct")
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        serialize.save_ciphertext(path, r)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        loaded = serialize.load_ciphertext(path, ev.ctx)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        ckpt = {"nl": r.nl, "shape": list(r.c0.shape),
                "header_bytes": os.path.getsize(path),
                "pages_bytes": os.path.getsize(path + ".pages"),
                "save_s": save_s, "load_s": load_s,
                "loaded_equal": _same(ciphertext_to_numpy(loaded),
                                      ciphertext_to_numpy(r))}
        bad = os.path.join(work, "flipped.ct")
        shutil.copyfile(path, bad)
        raw = bytearray(open(path + ".pages", "rb").read())
        raw[len(raw) // 2] ^= 0x01
        with open(bad + ".pages", "wb") as f:
            f.write(raw)
        try:
            serialize.load_ciphertext(bad, ev.ctx)
            ckpt["flipped_byte"] = "loaded"
        except IOError as e:
            ckpt["flipped_byte"] = str(e).replace(work, "<dir>")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = circ.pooler_classifier(r, boot=booter)   # without the round trip
    torch.cuda.synchronize()

    # the path: the resumed request and the ReLU
    z = np.random.default_rng(3).uniform(-1, 1, (RELU["batch"],
                                                 ev.ctx.cfg.slots))
    fresh = ev.encrypt(z, batch=True)
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    resumed = circ.pooler_classifier(loaded, boot=booter)
    torch.cuda.synchronize()
    ckpt["resume_s"] = time.perf_counter() - t
    ks0 = GLOBAL_TIMERS.counts["keyswitch"]
    t = time.perf_counter()
    y = Gadgets(ev).relu(fresh, degree=RELU["degree"])
    torch.cuda.synchronize()
    relu_s = time.perf_counter() - t
    launches = dict(KERNEL_LAUNCHES)
    relu_ks = GLOBAL_TIMERS.counts["keyswitch"] - ks0

    ckpt["resumed_equal"] = _same(ciphertext_to_numpy(resumed),
                                  ciphertext_to_numpy(out))
    logits = circ.decrypt_logits(resumed)
    ckpt["argmax"] = int(np.argmax(logits))
    ckpt["golden_argmax"] = int(np.argmax(want[NATIVE_S]))
    ckpt["max_abs_logit_err"] = float(np.abs(logits - want[NATIVE_S]).max())
    fit = cheb.chebyshev_fit(lambda x: np.maximum(x, 0.0), -1.0, 1.0,
                             RELU["degree"])
    got = np.real(ev.decrypt_host(y))
    relu = {"n": ev.ctx.cfg.n, **RELU, "in_nl": fresh.nl, "out_nl": y.nl,
            "s": relu_s, "keyswitches": relu_ks,
            "max_abs_err_vs_cheb_eval": float(np.abs(got - cheb_eval(fit, z))
                                              .max()),
            "max_abs_err_vs_relu": float(np.abs(got - np.maximum(z, 0))
                                         .max())}
    emit({"phase": "native", "setup": setup, "build": build,
          "encoder_S": NATIVE_S, "encoder_stages": log, "lift": lift,
          "checkpoint": ckpt, "relu": relu, "kernel_launches": launches})
    if not lift["bit_equal"]:
        raise AssertionError("the native lift differs from the Python-int "
                             "lift")
    if not (ckpt["loaded_equal"] and ckpt["resumed_equal"]):
        raise AssertionError(f"checkpoint round trip: {ckpt}")
    if "crc mismatch" not in ckpt["flipped_byte"]:
        raise AssertionError(f"a flipped byte gave {ckpt['flipped_byte']}")
    if ckpt["argmax"] != ckpt["golden_argmax"] or \
            not ckpt["max_abs_logit_err"] <= 0.05:
        raise AssertionError(f"resumed request: logits {logits} against "
                             f"golden {want[NATIVE_S]}")
    if not relu["max_abs_err_vs_cheb_eval"] <= RELU["max_err"]:
        raise AssertionError(f"relu: {relu}")
    return launches


def phase_ring16(batch=2):
    """tools/ring128c_run.py on the port: preset linformer-128c (ring 2^16,
    47 q-limbs + 16 special, dnum 3, uniform ternary secret; >= 128-bit
    classical security by security.assess) on a card the earlier phases
    have released; keys for the bootstrap's rotations and conjugation,
    the uniform-secret wide bootstrap (K = 512, degree-201 sine, 6 double
    angles, scale_boost 4) of `batch` ciphertexts of
    default_rng(3).uniform(-0.9, 0.9) dropped to one limb, cold and warm,
    the host decrypt's precision, and a traced warm bootstrap.  Fails
    under the JAX package's limbs out on this chain or 4.0 bits."""
    import gc
    import torch
    from fhe_linformer_tpu_torch.boot.bootstrap import BootConfig
    from fhe_linformer_tpu_torch.config import get
    from fhe_linformer_tpu_torch.security import assess
    from fhe_linformer_tpu_torch.utils.timing import (KERNEL_LAUNCHES,
                                                      approx_error_log2,
                                                      reset_launches)
    gc.collect()
    torch.cuda.empty_cache()
    start_gb = torch.cuda.memory_allocated() / 2 ** 30
    emit({"phase": "ring16_start", "memory_allocated_gb": start_gb})
    preset = get("linformer-128c")
    ev, booter, info = _boot_setup(
        BootConfig(wide=True, scale_boost=4, K=512, sin_degree=201,
                   double_angles=6), preset=preset.name)
    m = np.random.default_rng(3).uniform(-0.9, 0.9, (batch, ev.ctx.cfg.slots))
    low = ev.drop_to(ev.encrypt(m, batch=True), 1)
    torch.cuda.synchronize()
    reset_launches()
    runs = []
    for label in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = booter.bootstrap(low)
        torch.cuda.synchronize()
        runs.append({"run": label, "s": time.perf_counter() - t,
                     "max_memory_allocated_gb":
                         torch.cuda.max_memory_allocated() / 2 ** 30})
    launches = dict(KERNEL_LAUNCHES)
    t = time.perf_counter()
    prec = approx_error_log2(m, np.real(ev.decrypt_host(out)))
    decrypt_s = time.perf_counter() - t
    with _shape_census() as calls:
        trace, traced = _device_breakdown(lambda: booter.bootstrap(low))
    emit({"phase": "ring16", **info, "security": assess(ev.ctx).__dict__,
          "memory_allocated_at_start_gb": start_gb, "batch": batch,
          "scale_boost": booter.cfg.scale_boost, "K": booter.cfg.K,
          "sin_degree": booter.cfg.sin_degree,
          "double_angles": booter.cfg.double_angles, "runs": runs,
          "out_nl": out.nl, "precision_bits": prec,
          "decrypt_host_s": decrypt_s, "kernel_launches": launches,
          "reference": REFERENCE_RING16})
    emit({"phase": "ring16_trace", "batch": batch, **trace,
          "launch_shapes": _by_shape(calls, traced)})
    if out.nl < REFERENCE_RING16["out_nl"] or not prec >= 4.0:
        raise AssertionError(f"ring-2^16 bootstrap gave nl {out.nl} at "
                             f"{prec} bits")
    return launches


# ---------------------------------------------------------------------------
# phases 7 and 8


# the stages of the per-token circuit that _stage_log times
TOKEN_STAGES = ("attention", "wrap_tokens", "affine", "refresh",
                "unwrap_tokens", "ffn", "ef_project", "pooler_classifier")


def _device_gb(obj) -> float:
    """GB of the device tensors reachable from a cache entry (tuples,
    lists, dicts and the fields of plain objects such as Plaintext)."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size() / 2 ** 30 if obj.is_cuda \
            else 0.0
    if isinstance(obj, dict):
        return sum(_device_gb(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(_device_gb(v) for v in obj)
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return sum(_device_gb(v) for v in vars(obj).values())
    return 0.0


def _memory_report(circ, boot) -> dict:
    """torch.cuda.memory_allocated() and what the plaintext and key caches
    hold: the evaluator's encode cache and baby-key stack, the
    bootstrapper's folded diagonal dicts (host arrays: entries only) and
    the circuit's weight plaintexts."""
    import torch
    ev = circ.ev
    return {"memory_allocated_gb": torch.cuda.memory_allocated() / 2 ** 30,
            "enc_cache": [len(ev._enc_cache), _device_gb(ev._enc_cache)],
            "baby_stack_gb": _device_gb(ev._baby_stack),
            "fold_cache_entries": len(boot._fold_cache),
            "pt_cache": [len(circ._pt_cache), _device_gb(circ._pt_cache)]}


@contextlib.contextmanager
def _stage_log(circ, boot):
    """While the block runs, times each outermost call of the circuit's
    stage methods (and of boot.refresh) behind synchronizes, with the key
    switches and bootstrapped ciphertexts it counted, under
    layer<i>.<stage> (ef_project under the layer it feeds); each
    encoder_layer call under layer<i> with its peak memory and, at its
    start, `_memory_report`.  Yields the dict it fills."""
    import torch
    from fhe_linformer_tpu_torch.utils.timing import GLOBAL_TIMERS
    log: dict = {}
    state = {"layer": 0, "depth": 0}
    saved = {}

    def counted(key, fn, layer_total=False):
        def run(*a, **kw):
            if layer_total:
                state["layer"] += 1
                key_ = f"layer{state['layer']}"
                log.setdefault(key_, {})["start"] = _memory_report(circ, boot)
                torch.cuda.reset_peak_memory_stats()
            elif state["depth"]:
                return fn(*a, **kw)
            else:
                nxt = key == "ef_project"
                key_ = key if key == "pooler_classifier" else \
                    f"layer{state['layer'] + nxt}.{key}"
                state["depth"] += 1
            torch.cuda.synchronize()
            c0 = dict(GLOBAL_TIMERS.counts)
            t = time.perf_counter()
            try:
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            finally:
                if not layer_total:
                    state["depth"] -= 1
            row = log.setdefault(key_, {})
            for k in ("s", "calls", "keyswitch", "bootstrap"):
                row.setdefault(k, 0)
            row["s"] += time.perf_counter() - t
            row["calls"] += 1
            for k in ("keyswitch", "bootstrap"):
                row[k] += GLOBAL_TIMERS.counts[k] - c0.get(k, 0)
            row["out_nl"] = out.nl
            if layer_total:
                row["max_memory_allocated_gb"] = \
                    torch.cuda.max_memory_allocated() / 2 ** 30
            return out
        return run

    targets = [(circ, name) for name in TOKEN_STAGES if name != "refresh"]
    targets += [(boot, "refresh"), (circ, "encoder_layer")]
    for obj, name in targets:
        saved[(id(obj), name)] = (obj, name, getattr(obj, name))
        setattr(obj, name, counted(name, getattr(obj, name),
                                   layer_total=name == "encoder_layer"))
    try:
        yield log
    finally:
        for obj, name, fn in saved.values():
            delattr(obj, name)            # the class's method again


def _token_request(circ, boot, emb, want, extra_layers, caches, input_nl,
                   same_as=None, **extra):
    """One request through EncryptedLinformer.forward, decrypted on the
    host in float64 and on the device (decrypt_slots_device); emits its
    line and fails unless the logits match golden (argmax equal, max |err|
    <= 0.05), the device's logits the host's (`_check_device_logits`) and,
    given `same_as` (an earlier request's output from the same encryption
    draws), its output ciphertext equals that one exactly.  Returns the
    output ciphertext and the line."""
    import torch
    from fhe_linformer_tpu_torch.utils.timing import GLOBAL_TIMERS
    start = _memory_report(circ, boot)
    torch.cuda.reset_peak_memory_stats()
    c0 = dict(GLOBAL_TIMERS.counts)
    with _stage_log(circ, boot) as log:
        t = time.perf_counter()
        out = circ.forward(emb, extra_layers=extra_layers, boot=boot,
                           input_nl=input_nl)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t
    # _stage_log resets the peak at each layer: the request's is the largest
    peak = max([torch.cuda.max_memory_allocated() / 2 ** 30]
               + [row["max_memory_allocated_gb"] for row in log.values()
                  if "max_memory_allocated_gb" in row])
    t = time.perf_counter()
    vals = np.real(circ.ev.decrypt_host(out))
    logits = vals[: len(want) * circ.ops.d: circ.ops.d]
    decrypt_s = time.perf_counter() - t
    err = float(np.max(np.abs(logits - want)))
    dev = _device_logits(circ.ev, out, want, logits, stride=circ.ops.d)
    line = {"phase": "token_forward", "S": emb.shape[0] + 1,
            "layers": 1 + len(extra_layers), "plaintext_caches": caches,
            "request_s": forward_s + decrypt_s, "forward_s": forward_s,
            "decrypt_host_s": decrypt_s, "start": start, "stages": log,
            "keyswitches": GLOBAL_TIMERS.counts["keyswitch"]
            - c0.get("keyswitch", 0),
            "bootstraps": GLOBAL_TIMERS.counts["bootstrap"]
            - c0.get("bootstrap", 0),
            "argmax": int(np.argmax(logits)),
            "golden_argmax": int(np.argmax(want)),
            "max_abs_logit_err": err, "max_memory_allocated_gb": peak,
            "decrypt_slots_device": dev, **extra}
    if same_as is not None:
        line["equals_cold_ciphertext"] = (out.nl, out.scale) == \
            (same_as.nl, same_as.scale) and torch.equal(out.c0, same_as.c0) \
            and torch.equal(out.c1, same_as.c1)
    emit(line)
    if not np.all(np.isfinite(logits)) or \
            np.argmax(logits) != np.argmax(want) or not err <= 0.05:
        raise AssertionError(f"token_forward S={line['S']}: logits {logits} "
                             f"vs golden {want} (max err {err})")
    _check_device_logits(f"token_forward S={line['S']}", dev, logits)
    if same_as is not None and not line["equals_cold_ciphertext"]:
        raise AssertionError(f"token_forward S={line['S']}: the {caches} "
                             "request's ciphertext differs from the cold "
                             "request's on the same encryption draws")
    return out, line


def _keys_equal(a, b) -> bool:
    import torch
    pairs = [(a.relin, b.relin), (a.conj, b.conj)] + \
        [(a.rot[r], b.rot[r]) for r in b.rot]
    return sorted(a.rot) == sorted(b.rot) and \
        torch.equal(a.pk.p0, b.pk.p0) and torch.equal(a.pk.p1, b.pk.p1) and \
        torch.equal(a.sk.eval_full, b.sk.eval_full) and \
        all(x.max_nl == y.max_nl and torch.equal(x.b, y.b)
            and torch.equal(x.a, y.a) for x, y in pairs)


def _config5_keys(key_set: str, preset, ctx, bootcfg) -> dict:
    """generate_keys' arguments for config 5: "cli", the CLI's 71
    full-basis rotations (cli._preset_rotations); "reference",
    tools/config5_run.py's set, the bootstrap's rotations full-basis and
    the other +/-2^i shifts reduced-basis at max_nl 58 - 36 + 3 = 25."""
    from fhe_linformer_tpu_torch.boot.bootstrap import Bootstrapper
    from fhe_linformer_tpu_torch.cli import _preset_rotations
    if key_set == "cli":
        return {"rotations": _preset_rotations(preset, ctx)}
    pow2, step = set(), 1
    while step < ctx.cfg.slots:
        pow2 |= {step, -step}
        step *= 2
    boot_rots = set(Bootstrapper.rotations_for(ctx.cfg.n, bootcfg))
    return {"rotations": tuple(sorted(boot_rots)),
            "rotations_reduced": tuple(sorted(pow2 - boot_rots)),
            "reduced_max_nl": _reduced_max_nl(preset)}


def _config5(key_set: str, S: int, trace: bool):
    """Config 5 (preset multi-layer: two bootstrapped layers, the second's
    E/F compression homomorphic) on the per-token circuit at d = 128,
    k_lin = 32, d_ffn = 512, 20 classes, S tokens, with
    tools/config5_run.py's weights and calibration, on the key set
    `key_set` (_config5_keys) through save_keys -> load_keys: one cold and
    one warm request, checked against the 2-layer golden, and with `trace`
    a traced warm request.  Returns the evaluator, the bootstrapper, the
    kernel launches of the requests and a summary for the comparison of
    key sets."""
    import tempfile
    import torch
    from fhe_linformer_tpu_torch.boot.bootstrap import BootConfig, Bootstrapper
    from fhe_linformer_tpu_torch.ckks.context import Context
    from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
    from fhe_linformer_tpu_torch.ckks.keys import generate_keys
    from fhe_linformer_tpu_torch.config import get
    from fhe_linformer_tpu_torch.io.serialize import load_keys, save_keys
    from fhe_linformer_tpu_torch.models import golden
    from fhe_linformer_tpu_torch.models.circuit import (CircuitParams,
                                                        EncryptedLinformer)
    from fhe_linformer_tpu_torch.utils.timing import (KERNEL_LAUNCHES,
                                                      reset_launches)
    preset = get("multi-layer")
    ctx = Context(preset.ckks)
    bootcfg = BootConfig.wide_production()
    kw = _config5_keys(key_set, preset, ctx, bootcfg)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    made = generate_keys(ctx, conj=True, **kw)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    key_gb = (torch.cuda.memory_allocated() - mem0) / 2 ** 30
    with tempfile.TemporaryDirectory() as kd:
        t0 = time.perf_counter()
        save_keys(kd, made, include_secret=True)
        save_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(kd, f))
                   for f in os.listdir(kd))
        files = len(os.listdir(kd))
        t0 = time.perf_counter()
        keys = load_keys(kd, ctx)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    if not _keys_equal(keys, made):
        raise AssertionError(f"the loaded keystore ({key_set} keys) differs "
                             "from the keys generated")
    del made
    torch.cuda.empty_cache()
    ev = Evaluator(ctx, keys)
    t0 = time.perf_counter()
    # 4 blocks x 32 tokens fill one 128-piece container exactly, and the
    # FFN packs only above that (the JAX package's rule): its GELU and
    # refresh run on 128 ciphertexts, bootstrapped 8 at a time (a
    # bootstrap's working set grows ~3.5 GB per ciphertext: 128 at once
    # wanted 17 GB more than was free, 16 at a time 3 GB more)
    booter = Bootstrapper(ev, bootcfg, chunk=BOOT_CHUNK_CONFIG5)
    boot_setup_s = time.perf_counter() - t0
    reduced = {r: k.max_nl for r, k in keys.rot.items() if k.max_nl}
    setup = {"phase": "token_forward_setup", "key_set": key_set,
             "preset": preset.name, "basis": len(ctx.basis),
             "rotation_keys": len(keys.rot),
             "reduced_rotation_keys": len(reduced),
             "reduced_max_nl": max(reduced.values(), default=None),
             "conjugation_key": True, "keygen_s": keygen_s,
             "key_memory_gb": key_gb, "keystore_files": files,
             "keystore_bytes": disk, "save_keys_s": save_s,
             "load_keys_s": load_s, "loaded_equals_generated": True,
             "bootstrapper_setup_s": boot_setup_s,
             "bootstrap_chunk": booter.chunk,
             "memory_allocated_gb": torch.cuda.memory_allocated() / 2 ** 30}
    emit(setup)

    w1 = golden.random_weights(**CONFIG5_MODEL, max_seq=S + 4, seed=3,
                               scale=0.3)
    w2 = golden.random_weights(**CONFIG5_MODEL, max_seq=S + 4, seed=7,
                               scale=0.3)
    emb = np.random.default_rng(0).normal(0, 0.3,
                                          (S - 1, CONFIG5_MODEL["d"]))
    # tools/config5_run.py: calibrated on the 2-layer golden
    _, inter = golden.forward(w1, emb, return_intermediates=True,
                              extra_layers=[w2])
    rowsum = inter["exp"].sum(-1)
    params = CircuitParams(
        inv_range=(0.3 * rowsum.min(), 2.0 * rowsum.max()),
        inv_degree=119, gelu_degree=119, tanh_degree=247,
        gelu_clip=1.0 / (1.5 * np.abs(inter["norm1"] @ w1.W1.T
                                      + w1.B1[None]).max()),
        tanh_scale=1.0 / (1.5 * np.abs(inter["norm2"][:1] @ w1.Wp.T
                                       + w1.bp[None]).max()),
        exp_pow8=False)
    circ = EncryptedLinformer(ev, w1, params)
    reset_launches()
    # both requests draw the same encryption randomness, so the warm one
    # (plaintext caches filled by the cold one) must give the cold one's
    # ciphertext bit for bit: the golden bound cannot see a layer computed
    # with another layer's weights
    draws = copy.deepcopy(ev._enc_rng)
    cold, lines = None, {}
    for caches in ("cold", "warm"):
        ev._enc_rng = copy.deepcopy(draws)
        cold, lines[caches] = _token_request(
            circ, booter, emb, inter["logits"], [w2], caches, 12,
            same_as=cold, preset=preset.name, key_set=key_set)
    del cold
    launches = dict(KERNEL_LAUNCHES)
    if trace:
        with _shape_census() as calls:
            trace_line, runs = _device_breakdown(lambda: circ.forward(
                emb, extra_layers=[w2], boot=booter, input_nl=12))
        emit({"phase": "token_forward_trace", "S": S, "layers": 2,
              "key_set": key_set, "plaintext_caches": "warm", **trace_line,
              "launch_shapes": _by_shape(calls, runs)})
    layers = ("layer1", "layer2")
    summary = {
        **{k: setup[k] for k in ("rotation_keys", "reduced_rotation_keys",
                                 "key_memory_gb", "keystore_bytes",
                                 "load_keys_s")},
        "request_s": {c: ln["request_s"] for c, ln in lines.items()},
        "layer_peak_gb": {c: [ln["stages"][k]["max_memory_allocated_gb"]
                              for k in layers] for c, ln in lines.items()},
        "keyswitches": lines["warm"]["keyswitches"],
        "keyswitches_by_stage": {k: v["keyswitch"] for k, v in
                                 lines["warm"]["stages"].items()}}
    return ev, booter, launches, summary


# each config-5 key set's summary (_config5), for phase 7b's comparison
CONFIG5_SUMMARY: dict = {}


def phase_token_forward(S=32, with_s128=True):
    """Config 5 on the CLI's full-basis key set (_config5), then, with
    `with_s128`, one per-token single-layer request at S = 128 with phase
    6's settings (same chain and keys: linformer-boot-w's scheme
    parameters are multi-layer's)."""
    from fhe_linformer_tpu_torch.models import golden
    from fhe_linformer_tpu_torch.models.circuit import EncryptedLinformer
    from fhe_linformer_tpu_torch.utils.timing import KERNEL_LAUNCHES
    ev, booter, launches, CONFIG5_SUMMARY["cli"] = _config5(
        "cli", S, trace=TRACED_CONFIG5_KEYS == "cli")
    if with_s128:
        w = golden.random_weights(d=128, k_lin=32, d_ffn=512, n_classes=20,
                                  max_seq=128 + 4, seed=3, scale=0.3)
        e128 = np.random.default_rng(0).normal(0, 0.3, (127, 128))
        p128, i128 = _calibrated(golden, w, [e128], degree=119,
                                 tanh_degree=247)
        circ = EncryptedLinformer(ev, w, p128)
        before = dict(KERNEL_LAUNCHES)
        _token_request(circ, booter, e128, i128[0]["logits"], [], "cold", 12,
                       preset="linformer-boot-w", key_set="cli",
                       reference_keyswitches=16908, reference_bootstraps=7)
        for k in launches:
            launches[k] += KERNEL_LAUNCHES[k] - before[k]
    return launches


def phase_token_forward_ref(S=32):
    """Config 5 on tools/config5_run.py's key set (_config5 "reference"),
    on a card the earlier phases have released, then its numbers beside
    the full-basis set's (phase 7's, when it ran)."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    _, _, launches, CONFIG5_SUMMARY["reference"] = _config5(
        "reference", S, trace=TRACED_CONFIG5_KEYS == "reference")
    emit({"phase": "token_forward_key_sets", "S": S, **CONFIG5_SUMMARY})
    return launches


def phase_cli():
    """The port's CLI as subprocesses on the card, at preset tiny
    (tests/test_cli_e2e.py's flow): keygen to a keystore, infer from it
    (CLS query only), golden; fails unless every exit code is 0 and the
    encrypted argmax equals golden's on the CLS-only model."""
    import tempfile
    from fhe_linformer_tpu_torch.client import pipeline
    from fhe_linformer_tpu_torch.io.weights import save_reference_weights
    from fhe_linformer_tpu_torch.models import golden
    root = os.path.dirname(os.path.abspath(__file__))
    w = golden.random_weights(d=8, k_lin=4, d_ffn=32, n_classes=5,
                              max_seq=12, seed=31, scale=0.3)
    emb = np.random.default_rng(7).normal(0, 0.3, (3, 8))
    want = golden.forward(w, emb, cls_only=True,
                          return_intermediates=True)[1]["logits"]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        wd, sd, kd = (os.path.join(tmp, x) for x in ("w", "s", "k"))
        save_reference_weights(wd, w)
        pipeline.export_sample_embeddings(sd, emb)
        io = ["--weights-dir", wd, "--sample-dir", sd]
        for name, args in (
                ("keygen", ["keygen", "--preset", "tiny", "--keys-dir", kd]),
                ("infer", ["infer", "--preset", "tiny", "--keys-dir", kd,
                           "--cls-only"] + io),
                ("golden", ["golden", "--preset", "tiny"] + io)):
            t = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", f"{PORT}.cli", *args],
                               cwd=root, capture_output=True, text=True,
                               timeout=300)
            runs[name] = {"rc": r.returncode, "s": time.perf_counter() - t,
                          "last_line": (r.stdout.strip().splitlines()
                                        or [""])[-1][:2000]}
            if r.returncode != 0:
                emit({"phase": "cli", "runs": runs,
                      "stderr": r.stderr[-2000:]})
                raise AssertionError(f"cli {name} exited {r.returncode}")
    enc = json.loads(runs["infer"]["last_line"])
    gold = json.loads(runs["golden"]["last_line"])
    err = float(np.max(np.abs(np.asarray(enc["logits"]) - want)))
    emit({"phase": "cli", "runs": runs, "argmax": enc["pred"],
          "cls_only_golden_argmax": int(np.argmax(want)),
          "golden_cli_argmax": gold["pred"], "max_abs_logit_err": err,
          "infer_kernel_launches": enc["kernel_launches"]})
    if enc["pred"] != int(np.argmax(want)) or \
            min(enc["kernel_launches"].values()) <= 0:
        raise AssertionError(f"cli infer: argmax {enc['pred']} vs golden "
                             f"{int(np.argmax(want))}, launches "
                             f"{enc['kernel_launches']}")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 9: parallel/ on ranks that share the card


# the sharded key switch's context: 24 q-limbs + 8 special = 32 rows, 8 per
# rank on 4 limb ranks (the JAX dry-run's step 1e)
PARALLEL_KS = {"n": 1 << 15, "num_scaling": 23, "dnum": 3}
PARALLEL_RANKS = 4
DP_RANKS = 2
PARALLEL_TIMEOUT = 600           # seconds for each launch of ranks
DRYRUN_PROFILE = (5, 40, 3)      # the dry-run's degree, num_scaling, dnum
ATTENTION_N = 512
# the full-width dp requests: (packed, S, bootstrap chunk): phase 6's
# bootstrapped S = 700 (6 chunks) and phase 7's per-token S = 128
DP_FULL_WIDTH = ((True, 700, 0), (False, 128, BOOT_CHUNK_CONFIG5))


def _parallel_shards():
    """The sharded key switch's context and each rank's tables at the top
    level (phase 2 holds the kernels at their shapes)."""
    from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
    from fhe_linformer_tpu_torch.parallel.ksprod import (build_sharded_ks,
                                                         rank_tables)
    ctx = Context(CKKSConfig(scale_bits=26, seed=77, **PARALLEL_KS))
    plan = build_sharded_ks(ctx, ctx.num_q, PARALLEL_RANKS)
    return ctx, [rank_tables(ctx, plan, r) for r in range(PARALLEL_RANKS)]


def _parallel_cases(gen):
    """Phase 2's cases at the sharded key switch's per-rank shapes: K2 on a
    rank's 8 rows of c1 (rank 0: limbs 0-7) and on the 8 special rows of
    rank 3's accumulator (the mod-down); K1 on a rank's 3 x 8 digit rows
    and its 8 mod-down rows (a table over the rank's own primes); K3 on
    rank 0's slice of the digit groups (3 digits of 8 sources, targets the
    32 rows) and on rank 3's specials (the mod-down's partial
    conversion)."""
    from fhe_linformer_tpu_torch.ops.ntt import NttTables
    ctx, shards = _parallel_shards()
    r0, r3 = shards[0], shards[-1]
    own = NttTables(ctx.cfg.n, [ctx.basis[i] for i in r0.limbs], "cuda")
    return [_inv_case(ctx.ntt, (), r0.limbs, 0, gen, 20),
            _inv_case(ctx.ntt, (), r3.limbs, r3.sp0, gen, 20),
            _fwd_case(own, ctx.cfg.dnum, len(r0.limbs), gen, 20),
            _fwd_case(own, 1, len(r0.limbs), gen, 20),
            _bc_case(r0.bc, r0.bc.nd * r0.bc.alpha, 1, False, gen, 20),
            _bc_case(r3.md, r3.md.alpha, 1, True, gen, 20)]


def _dp_make(keys, w, params, bootcfg, boot_chunk, packed):
    """A dp rank's circuit and bootstrapper on the card (the `make` of
    parallel.circuit.run_forward): linformer-boot-w's context and the
    parent's keys (shared through CUDA IPC), phase 6's packed circuit with
    batch_chunks or phase 7's per-token circuit."""
    from fhe_linformer_tpu_torch.boot.bootstrap import Bootstrapper
    from fhe_linformer_tpu_torch.ckks.context import Context
    from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
    from fhe_linformer_tpu_torch.config import get
    from fhe_linformer_tpu_torch.models.circuit import EncryptedLinformer
    from fhe_linformer_tpu_torch.models.circuit_packed import PackedLinformer
    ev = Evaluator(Context(get("linformer-boot-w").ckks,
                           keys.pk.p0.device), keys)
    booter = Bootstrapper(ev, bootcfg, chunk=boot_chunk)
    circ = PackedLinformer(ev, w, params, bs=16, batch_chunks=True) \
        if packed else EncryptedLinformer(ev, w, params)
    return circ, booter


def _single_forward(circ, boot, inputs, S, packed):
    """The single-process layer and pooler/classifier from the same
    encrypted inputs the ranks get: (layer output, logits ciphertext,
    seconds, key switches)."""
    import torch
    from fhe_linformer_tpu_torch.convert import ciphertext_from_numpy
    from fhe_linformer_tpu_torch.utils.timing import GLOBAL_TIMERS
    x, xe, xf = (ciphertext_from_numpy(circ.ev.ctx, *a) for a in inputs)
    ks0 = GLOBAL_TIMERS.counts["keyswitch"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    y = circ.encoder_layer(x, xe, xf, S, boot=boot)
    out = circ.pooler_classifier(y if packed
                                 else y.with_data(y.c0[0], y.c1[0]), boot=boot)
    torch.cuda.synchronize()
    return y, out, time.perf_counter() - t, \
        GLOBAL_TIMERS.counts["keyswitch"] - ks0


def _same(a, b) -> bool:
    """Two ciphertexts as convert.ciphertext_to_numpy arrays, equal bit for
    bit."""
    return tuple(a[2:]) == tuple(b[2:]) and np.array_equal(a[0], b[0]) \
        and np.array_equal(a[1], b[1])


def _host_logits(circ, out, packed):
    vals = np.real(circ.ev.decrypt_host(out))
    ncls = circ.w.Wc.shape[0]
    return vals[:ncls] if packed else vals[: ncls * circ.ops.d: circ.ops.d]


def _add_rank_launches(launches, res, what, kernels=KERNELS):
    """Add each rank's launches on the sharded or dp path alone (the ranks
    count around those calls only) to `launches`; fails if a rank launched
    one of `kernels` no time."""
    for rank, r in enumerate(res):
        missing = [k for k in kernels if r["launches"][k] <= 0]
        if missing:
            raise AssertionError(f"{what}: rank {rank} never launched "
                                 f"{missing}")
        for k in KERNELS:
            launches[k] += r["launches"][k]


def _parallel_keyswitch(launches):
    """Step 1: the limb-sharded Galois switch and combo (shifts 1, 2, 3) at
    ring 2^15 on 4 ranks, through Evaluator.rotate / rotate_combo, and the
    attention step on a 2 x 2 mesh; every rank holds its result to its own
    single-process switch on the card."""
    from fhe_linformer_tpu_torch.ops import ntt
    from fhe_linformer_tpu_torch.ops.ntt import NttTables
    from fhe_linformer_tpu_torch.parallel.dryrun import dryrun_worker
    from fhe_linformer_tpu_torch.parallel.mesh import launch
    from fhe_linformer_tpu_torch.primes import ntt_primes
    import torch
    qs = ntt_primes(2 * ATTENTION_N, 2)
    rng = np.random.default_rng(1)
    x = np.stack([[rng.integers(0, q, ATTENTION_N) for q in qs]
                  for _ in range(4)]).astype(np.int32)
    wt = np.stack([rng.integers(0, q, ATTENTION_N) for q in qs]
                  ).astype(np.int32)
    t = time.perf_counter()
    res = launch(dryrun_worker, PARALLEL_RANKS, {
        "device": "cuda",
        "ksprod": dict(PARALLEL_KS, rot=1, shifts=(1, 2, 3), reps=10),
        "attention": {"dp": 2, "limb": 2, "n": ATTENTION_N, "x": x,
                      "wt": wt}}, timeout=PARALLEL_TIMEOUT)
    wall = time.perf_counter() - t
    cpu = NttTables(ATTENTION_N, qs, "cpu")
    xt, wtt = torch.from_numpy(x), torch.from_numpy(wt)
    want = ntt.inv_plain(torch.remainder(
        ntt.fwd_plain(xt, cpu, (0, 1)).long() * wtt, cpu.q.view(-1, 1)),
        cpu, (0, 1)).numpy()
    for r in res:
        a = r["attention"]
        (b0, b1), (r0, r1) = a["batch"], a["rows"]
        if not np.array_equal(a["z"], want[b0:b1, r0:r1]):
            raise AssertionError("the attention step differs from the plain "
                                 f"NTT at batch {b0}:{b1}, rows {r0}:{r1}")
    _add_rank_launches(launches, res, "the sharded key switch",
                       SHARDED_KERNELS)
    sharded = [r["keyswitch_sharded"] for r in res]
    if min(sharded) <= 0:
        raise AssertionError(f"keyswitch_sharded per rank {sharded}")
    line = {"phase": "parallel_keyswitch", **PARALLEL_KS,
            "ranks": PARALLEL_RANKS, "rows_per_rank": 8,
            "transport": "gloo", "staging": "host", "launch_wall_s": wall,
            "keyswitch_sharded_per_rank": sharded,
            "launches_per_rank": [r["launches"] for r in res],
            "equals_single_process": True, "attention_step_exact": True}
    for op in ("rotate", "combo"):
        timed = [r[op][1] for r in res]
        line[op] = {"single_ms": timed[0]["single_ms"],
                    "sharded_ms_per_rank": [t["sharded_ms"] for t in timed],
                    "decrypt_err": timed[0]["err"],
                    "collective_bytes_per_switch":
                        timed[0]["collective_bytes_per_switch"]}
    emit(line)


def phase_parallel():
    """`parallel/` on 2-4 processes sharing the card, exchanging data
    through gloo with host-staged buffers (NCCL refuses two ranks on one
    device): the numbers are exactness, shapes, per-shard kernels, memory
    and bytes per collective, not a multi-card speed.  The kernels are
    built here before any rank starts.  Step 1 (`_parallel_keyswitch`),
    then one 2-rank launch of the dp forwards: the dry-run's tiny profile
    (per-token S = 6, packed S = 32 as 2 chunks) and, at full width on
    linformer-boot-w with keys the ranks share with this process, the
    bootstrapped packed S = 700 request (6 chunks, batch_chunks) and the
    per-token single-layer S = 128 request.  Each rank's output ciphertext
    must equal this process's single-process one from the same encryption
    exactly, whose host decrypt must match golden (argmax, 0.05); the
    packed single-process forward with batch_chunks must equal the chunk
    loop."""
    import gc
    import torch
    from fhe_linformer_tpu_torch.boot.bootstrap import BootConfig, Bootstrapper
    from fhe_linformer_tpu_torch.cli import _preset_rotations
    from fhe_linformer_tpu_torch.ckks.context import Context
    from fhe_linformer_tpu_torch.ckks.keys import generate_keys
    from fhe_linformer_tpu_torch.config import get
    from fhe_linformer_tpu_torch.models import golden
    from fhe_linformer_tpu_torch.ops import cuda_build
    from fhe_linformer_tpu_torch.convert import ciphertext_to_numpy
    from fhe_linformer_tpu_torch.parallel.circuit import dryrun_circuit
    from fhe_linformer_tpu_torch.parallel.dryrun import dryrun_worker
    from fhe_linformer_tpu_torch.parallel.mesh import launch
    cuda_build.build()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    emit({"phase": "parallel_setup", "free_gb": free / 2 ** 30,
          "total_gb": total / 2 ** 30, "transport": "gloo",
          "staging": "host", "note": "ranks share one card: exactness, "
          "shapes, memory and bytes, no multi-card speed"})
    # the path's launches are the ranks' own, counted around the sharded
    # and dp calls alone; this process's references are not counted
    launches = {k: 0 for k in KERNELS}
    _parallel_keyswitch(launches)

    # the parent's single-process references, from the encryptions the
    # ranks get
    forwards, refs = [], []
    for packed, S in ((False, 6), (True, 32)):
        make_args = (S, *DRYRUN_PROFILE, packed, None, 11, "cuda")
        circ, emb, want = dryrun_circuit(*make_args)
        x, xe, xf, St = circ.encrypt_inputs(emb)
        inputs = [ciphertext_to_numpy(c) for c in (x, xe, xf)]
        y, out, sec, ks = _single_forward(circ, None, inputs, St, packed)
        refs.append({"what": f"dryrun {'packed' if packed else 'token'}",
                     "S": St, "packed": packed, "layer": y, "out": out,
                     "s": sec, "keyswitch": ks, "circ": circ, "want": want})
        forwards.append({"make_args": make_args, "inputs": inputs,
                         "S_total": St, "packed": packed})
    t = time.perf_counter()
    ctx = Context(get("linformer-boot-w").ckks)
    bootcfg = BootConfig.wide_production()
    rots = set(_preset_rotations(get("linformer-boot-w"), ctx)) | set(
        Bootstrapper.rotations_for(ctx.cfg.n, bootcfg)) | set(
        _rotations(ctx.cfg.slots))
    keys = generate_keys(ctx, rotations=tuple(sorted(rots)), conj=True)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t
    for packed, S, chunk in DP_FULL_WIDTH:
        w = golden.random_weights(d=128, k_lin=32, d_ffn=512, n_classes=20,
                                  max_seq=S + 4, seed=3, scale=0.3)
        emb = np.random.default_rng(0).normal(0, 0.3, (S - 1, 128))
        params, (inter,) = _calibrated(golden, w, [emb], degree=119,
                                       tanh_degree=247)
        make_args = (keys, w, params, bootcfg, chunk, packed)
        circ, booter = _dp_make(*make_args)
        x, xe, xf, St = circ.encrypt_inputs(emb, nl=12)
        inputs = [ciphertext_to_numpy(c) for c in (x, xe, xf)]
        y, out, sec, ks = _single_forward(circ, booter, inputs, St, packed)
        ref = {"what": f"{'packed' if packed else 'token'} full width",
               "S": St, "packed": packed, "layer": y, "out": out, "s": sec,
               "keyswitch": ks, "circ": circ, "want": inter["logits"]}
        if packed:               # the chunk loop gives the same ciphertexts
            circ.batch_chunks = False
            y2, out2, ref["loop_s"], _ = _single_forward(circ, booter, inputs,
                                                         St, True)
            ref["batch_chunks_equals_loop"] = \
                _same(ciphertext_to_numpy(y2), ciphertext_to_numpy(y)) and \
                _same(ciphertext_to_numpy(out2), ciphertext_to_numpy(out))
            if not ref["batch_chunks_equals_loop"]:
                raise AssertionError("batch_chunks differs from the chunk "
                                     "loop at S=700")
            del y2, out2
        refs.append(ref)
        forwards.append({"make": _dp_make, "make_args": make_args,
                         "inputs": inputs, "S_total": St, "packed": packed})
        del booter, circ, y, out
    for ref in refs:               # host decrypt against golden
        logits = _host_logits(ref["circ"], ref["out"], ref["packed"])
        ref["max_abs_logit_err"] = float(np.abs(logits - ref["want"]).max())
        ref["argmax"] = int(np.argmax(logits))
        if int(np.argmax(ref["want"])) != ref["argmax"] or \
                not ref["max_abs_logit_err"] <= 0.05:
            raise AssertionError(f"{ref['what']}: logits {logits} vs golden "
                                 f"{ref['want']}")
        ref["layer"], ref["out"] = ciphertext_to_numpy(ref["layer"]), \
            ciphertext_to_numpy(ref["out"])
        del ref["circ"]
    gc.collect()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    # the ranks' allocators grow segments in place (two processes share the
    # card: no memory stranded in half-used blocks); this process has
    # allocated already and keeps its own
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t = time.perf_counter()
    try:
        res = launch(dryrun_worker, DP_RANKS, {"device": "cuda",
                                               "forwards": forwards},
                     timeout=PARALLEL_TIMEOUT)
    finally:
        if alloc_conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    wall = time.perf_counter() - t
    _add_rank_launches(launches, res, "the dp forwards")
    for i, ref in enumerate(refs):
        ranks = [r["forwards"][i] for r in res]
        holders = [r for r in ranks if r["out"] is not None]
        equal = len(holders) == (1 if ref["packed"] else DP_RANKS) and all(
            _same(r["out"], ref["out"]) for r in holders)
        if ref["packed"]:
            per = ref["layer"][0].shape[0] // DP_RANKS
            equal = equal and all(
                np.array_equal(r["layer"][0], ref["layer"][0][j * per:
                                                              (j + 1) * per])
                and np.array_equal(r["layer"][1],
                                   ref["layer"][1][j * per:(j + 1) * per])
                for j, r in enumerate(ranks))
        emit({"phase": "parallel_dp", "forward": ref["what"], "S": ref["S"],
              "ranks": DP_RANKS, "chunks": ref["layer"][0].shape[0]
              if ref["packed"] else None,
              "equals_single_process": equal,
              "single_s": ref["s"], "single_loop_s": ref.get("loop_s"),
              "batch_chunks_equals_loop": ref.get("batch_chunks_equals_loop"),
              "rank_s": [r["s"] for r in ranks],
              "single_keyswitches": ref["keyswitch"],
              "rank_keyswitches": [r["keyswitch"] for r in ranks],
              "rank_launches": [r["launches"] for r in ranks],
              "collective_bytes": [r["collective_bytes"] for r in ranks],
              "rank_max_memory_allocated_gb":
                  [r["max_memory_allocated_gb"] for r in ranks],
              "argmax": ref["argmax"],
              "golden_argmax": int(np.argmax(ref["want"])),
              "max_abs_logit_err": ref["max_abs_logit_err"],
              **({"keygen_s": keygen_s, "rotation_keys": len(rots),
                  "free_gb_before_spawn": free_before / 2 ** 30}
                 if "full" in ref["what"] else {})})
        if not equal:
            raise AssertionError(f"{ref['what']}: a rank's output differs "
                                 "from the single-process output")
        if not all(r["keyswitch"] < ref["keyswitch"] for r in ranks):
            raise AssertionError(f"{ref['what']}: a rank ran as many key "
                                 "switches as the single process")
    emit({"phase": "parallel_launch", "ranks": DP_RANKS, "wall_s": wall})
    return launches


PHASES = ("card", "kernels", "keyswitch", "forward", "bootstrap",
          "boot_forward", "native", "token_forward", "token_forward_ref",
          "ring16", "parallel", "cli")
PATHS = {"forward": phase_forward, "bootstrap": phase_bootstrap,
         "boot_forward": phase_boot_forward, "native": phase_native,
         "token_forward": phase_token_forward,
         "token_forward_ref": phase_token_forward_ref, "ring16": phase_ring16,
         "parallel": phase_parallel}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all, "
                         "which alone prints the result line)")
    only = ap.parse_args(argv).only.split(",")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fhe_linformer_tpu_torch.ckks.context import Context
    from fhe_linformer_tpu_torch.config import get
    torch.manual_seed(0)
    if "card" in only:
        phase_card()
    if "kernels" in only:
        main_shapes, kernel_rows = phase_kernels(
            Context(get("linformer-boot-w").ckks), Context(get("tiny").ckks),
            Context(get("linformer-128c").ckks))
    if "keyswitch" in only:
        phase_keyswitch()
    paths = {name: run() for name, run in PATHS.items() if name in only}
    if "cli" in only:
        phase_cli()
    if set(only) != set(PHASES):
        return 0
    for name, counts in paths.items():
        missing = [k for k in KERNELS if counts[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {name} "
                                 f"path: {missing}")
    copied = [r["shape"] for r in kernel_rows if r["kernel"] == "ntt_inv"
              and not r["read_in_place"]]
    if copied:
        raise AssertionError(f"K2 got a copy, not the slice, at {copied}")
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k],
         "launches": sum(counts[k] for counts in paths.values()),
         "launches_by_path": {p: counts[k] for p, counts in paths.items()},
         "max_abs_err": main_shapes[k]["max_abs_err"],
         "ms": main_shapes[k]["ms"], "plain_ms": main_shapes[k]["plain_ms"],
         "bound_ms": main_shapes[k]["bound_ms"],
         "bound_by": main_shapes[k]["bound_by"], "library_ms": None}
        for k in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
