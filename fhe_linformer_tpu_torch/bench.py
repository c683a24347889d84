"""The key-switch yardstick: one Galois key switch (rotation by 1) at
N = 2^15, 24 limbs, dnum 3, on a batch of 4 ciphertexts."""

from __future__ import annotations

import time

import numpy as np

LOG2N, LIMBS, DNUM, BATCH = 15, 24, 3, 4


def keyswitch_case(device=None, rotations=(1,)):
    """(switch, ev, ct, values): `switch()` runs the key switch of ct by a
    rotation of 1 (the evaluator's Galois core, as every rotation does) and
    returns (c0, c1); values are the encrypted slots.  The keys cover
    `rotations`."""
    from .ckks import evaluator as evm
    from .ckks.context import CKKSConfig, Context
    from .ckks.keys import generate_keys
    cfg = CKKSConfig(n=1 << LOG2N, scale_bits=26, num_scaling=LIMBS - 1,
                     dnum=DNUM)
    ctx = Context(cfg, device)
    keys = generate_keys(ctx, rotations=rotations)
    ev = evm.Evaluator(ctx, keys)
    z = np.random.default_rng(0).uniform(-1, 1, (BATCH, cfg.slots))
    ct = ev.encrypt(z, batch=True)
    ks = ctx.ks_tables(ct.nl)
    perm = ctx.galois_perm(ctx.galois_t(1))
    return (lambda: evm._galois_core(ctx, ct.c0, ct.c1, perm, keys.rot[1],
                                     ks)), ev, ct, z


def keyswitches_per_s(device=None, reps: int = 20) -> dict:
    """Median time of one batch-4 key switch (CUDA events on the card, the
    host clock on the CPU) and the key switches per second it gives."""
    import torch
    switch, ev, ct, _ = keyswitch_case(device)
    cuda = ev.ctx.device.type == "cuda"
    for _ in range(2):
        switch()
    times = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            switch()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        else:
            t = time.perf_counter()
            switch()
            times.append((time.perf_counter() - t) * 1e3)
    ms = float(np.median(times))
    return {"n": 1 << LOG2N, "limbs": ct.nl, "dnum": DNUM, "batch": BATCH,
            "ms": ms, "keyswitches_per_s": BATCH / ms * 1e3,
            "device": str(ev.ctx.device)}
