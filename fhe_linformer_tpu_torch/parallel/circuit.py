"""The per-token encrypted circuit (`models/circuit.py`) with the token
axis on the mesh's dp axis: the counterpart of the JAX package's
`parallel/circuit.py`.

The JAX package commits the token batch to the dp axis and leaves the
collectives to XLA's sharding propagation.  The port has none, and the
tokens mix at several points (the score interleave, the row and token
wraps and unwraps, the FFN containers, `ef_project`).  So the token batch
stays whole on every rank and the ops that carry it are split instead:
under `Evaluator.enable_dp` every batched key-switching op
(`Evaluator._batched`: ct x ct products, the Chebyshev nodes, Galois key
switches, accumulated rotations) runs one contiguous block of its batch on
each rank and all-gathers the blocks.  Each ciphertext's ops are
independent of the others', so the output equals the single-process
output bit for bit; each rank runs its share of those key switches (its
`keyswitch` count falls below the single-process one), while plaintext
products and rescales (in chunks of `heavy_chunk`), hoisted rotation
stacks, rotation combos and the bootstraps run whole on every rank.

`run_forward` runs one dp rank of either forward (this one and
`parallel/circuit_packed.py`'s); `parallel/dryrun.py`'s `dryrun_worker`
calls it under `mesh.launch`.  `dryrun_circuit` builds the JAX dry-run's
tiny profile (n = 256, d = 8, k_lin = 4, d_ffn = 32, 5 classes).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ckks.ciphertext import Ciphertext

D, KLIN, FFN, NCLS, BS = 8, 4, 32, 5, 4       # the dry-run's model


def _pow2_rotations(slots: int) -> list[int]:
    out, s = [], 1
    while s < slots:
        out += [s, -s]
        s *= 2
    return out


def dryrun_circuit(S_total: int, degree: int = 13, num_scaling: int = 44,
                   dnum: int = 8, packed: bool = False,
                   chunk_tokens: int | None = None, seed: int = 11,
                   device=None):
    """The JAX dry-run's circuit on `device`: per-token
    (the JAX package's `run_encoder_forward_dp`, CKKS seed 42) or, with
    `packed`, the block-major one (its `run_packed_forward_dp`: CKKS seed
    99, bs 4, batch_chunks; `chunk_tokens` re-chunks the sequence so the
    chunk count divides a dp axis); weights of seed 5 at scale 0.35, embeddings from
    default_rng(seed), the approximation ranges from the golden
    intermediates.  Returns (circuit, embeddings, golden logits)."""
    from ..ckks.context import CKKSConfig, Context
    from ..ckks.evaluator import Evaluator
    from ..ckks.keys import generate_keys
    from ..models import golden
    from ..models.circuit import CircuitParams, EncryptedLinformer
    from ..models.circuit_packed import PackedLinformer
    ctx = Context(CKKSConfig(n=256, scale_bits=26, num_scaling=num_scaling,
                             dnum=dnum, seed=99 if packed else 42), device)
    rots = _pow2_rotations(ctx.cfg.slots)
    if packed:
        rots += [j for j in range(1, BS) if j & (j - 1)]
    ev = Evaluator(ctx, generate_keys(ctx, rotations=tuple(rots)))
    w = golden.random_weights(d=D, k_lin=KLIN, d_ffn=FFN, n_classes=NCLS,
                              max_seq=S_total + 4, seed=5, scale=0.35)
    emb = np.random.default_rng(seed).normal(0, 0.3, (S_total - 1, D))
    _, inter = golden.forward(w, emb, return_intermediates=True)
    x1 = inter["norm1"]
    params = CircuitParams(
        inv_range=(0.5 * inter["exp"].sum(-1).min(),
                   1.5 * inter["exp"].sum(-1).max()),
        inv_degree=degree, gelu_degree=degree, tanh_degree=degree,
        gelu_clip=1.0 / (1.2 * np.abs(x1 @ w.W1.T + w.B1[None]).max()),
        tanh_scale=1.0 / (1.2 * np.abs(
            inter["norm2"][:1] @ w.Wp.T + w.bp[None]).max()),
        exp_pow8=False)
    circ = PackedLinformer(ev, w, params, bs=BS, batch_chunks=True,
                           chunk_tokens=chunk_tokens) if packed \
        else EncryptedLinformer(ev, w, params)
    return circ, emb, inter["logits"]


def dryrun_make(*args, **kw):
    """dryrun_circuit's circuit and no bootstrapper: a `make` for
    run_forward."""
    return dryrun_circuit(*args, **kw)[0], None


def token_forward_dp(circ, mesh, x, xe, xf, S_total: int, boot=None
                     ) -> Ciphertext:
    """The per-token layer and the pooler/classifier with the heavy
    batched ops split over `mesh`'s dp axis; every rank returns the logits
    ciphertext."""
    circ.ev.enable_dp(mesh)
    try:
        y = circ.encoder_layer(x, xe, xf, S_total, boot=boot)
        return circ.pooler_classifier(y.with_data(y.c0[0], y.c1[0]),
                                      boot=boot)
    finally:
        circ.ev.enable_dp(None)


def run_forward(mesh, make, make_args, inputs, S_total: int,
                packed: bool) -> dict:
    """`make(*make_args)` builds (circuit, bootstrapper or None) on this
    rank, `inputs` are the encrypted (x, XE, XF) as
    `convert.ciphertext_to_numpy` arrays (drawn once, by the caller).  Runs `token_forward_dp` or, with `packed`,
    `packed_forward_dp` on `mesh`.  Returns this rank's output arrays (the
    logits ciphertext where the rank has it, the packed layer's chunk
    block), seconds, its `keyswitch` and kernel-launch counts, the
    collective bytes and, on a card, its peak memory."""
    from ..convert import ciphertext_from_numpy, ciphertext_to_numpy
    from ..utils.timing import (COLLECTIVE_BYTES, GLOBAL_TIMERS,
                                KERNEL_LAUNCHES)
    from .circuit_packed import packed_forward_dp
    circ, boot = make(*make_args)
    ctx = circ.ev.ctx
    x, xe, xf = (ciphertext_from_numpy(ctx, *a) for a in inputs)
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ks0 = GLOBAL_TIMERS.counts["keyswitch"]
    launches0, bytes0 = dict(KERNEL_LAUNCHES), dict(COLLECTIVE_BYTES)
    t = time.perf_counter()
    result = {}
    if packed:
        layer, out = packed_forward_dp(circ, mesh, x, xe, xf, S_total, boot)
        result["layer"] = ciphertext_to_numpy(layer)
    else:
        out = token_forward_dp(circ, mesh, x, xe, xf, S_total, boot)
    if cuda:
        torch.cuda.synchronize()
    result.update({
        "s": time.perf_counter() - t,
        "out": None if out is None else ciphertext_to_numpy(out),
        "keyswitch": GLOBAL_TIMERS.counts["keyswitch"] - ks0,
        "launches": {k: v - launches0[k] for k, v in KERNEL_LAUNCHES.items()},
        "collective_bytes": {k: v - bytes0[k]
                             for k, v in COLLECTIVE_BYTES.items()},
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30
        if cuda else None})
    return result
