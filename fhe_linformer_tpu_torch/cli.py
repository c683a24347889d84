"""Command-line interface of the PyTorch/CUDA port:

    python -m fhe_linformer_tpu_torch.cli <command> [options]

  keygen   - context + public/relinearization/rotation/conjugation keys to
             a keystore directory (--secure withholds the secret key)
  infer    - encrypted forward over a sample's exported embeddings: the
             per-token circuit (--layers, --cls-only, checkpoints) or the
             block-major one (--packed)
  golden   - the plaintext golden forward on the same files
  eval     - accuracy over a directory of samples (--encrypted adds the
             encrypted circuit and its agreement with golden)
  security - the HE-standard security assessment of the presets
  bench    - key switches per second at N = 2^15, 24 limbs, dnum 3, batch 4

Commands that compute on ciphertexts take --device (default cuda) and fail
without a card unless given --device cpu.  Keystores, checkpoints and
weight files use the JAX package's formats.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _build_context(preset_name: str, device=None):
    from .ckks.context import Context
    from .config import get
    p = get(preset_name)
    return p, Context(p.ckks, device)


def _preset_rotations(p, ctx) -> tuple:
    """The rotation shifts a preset's circuits need: power-of-two trees of
    both signs, the block-major circuit's BSGS babies and giants (bs 16),
    and with bootstrapping the bootstrap's BSGS shifts."""
    rots = set()
    s = 1
    while s < ctx.cfg.slots:
        rots |= {s, -s}
        s *= 2
    rots |= {j for j in range(1, 16) if j & (j - 1)}
    rots |= {16 * g for g in range(1, 8)} | \
        {16 * g - 128 for g in range(1, 8)}
    if p.bootstrap:
        from .boot.bootstrap import Bootstrapper
        rots |= set(Bootstrapper.rotations_for(ctx.cfg.n))
    return tuple(sorted(rots))


def _weights(args, p):
    from .io.weights import load_reference_weights
    from .models import golden
    if args.weights_dir:
        return load_reference_weights(args.weights_dir, d=p.d, k_lin=p.k_lin,
                                      d_ffn=p.d_ffn, n_classes=p.n_classes,
                                      max_seq=p.max_seq)
    return golden.random_weights(d=p.d, k_lin=p.k_lin, d_ffn=p.d_ffn,
                                 n_classes=p.n_classes, max_seq=p.max_seq)


def _bootstrapper(p, ev):
    """Wide presets (names ending in -w) take the paired-scale config."""
    if not p.bootstrap:
        return None
    from .boot.bootstrap import BootConfig, Bootstrapper
    return Bootstrapper(ev, BootConfig.wide_production()
                        if p.name.endswith("-w") else None)


def _result(logits, t0, **extra) -> str:
    """The answer's JSON line, with the CUDA kernels' launches so far (all
    0 on the CPU)."""
    from .client.pipeline import softmax_argmax
    from .utils.timing import KERNEL_LAUNCHES
    cls, probs = softmax_argmax(logits)
    return json.dumps({"pred": cls, "prob": float(probs[cls]),
                       "latency_s": round(time.time() - t0, 3), **extra,
                       "kernel_launches": dict(KERNEL_LAUNCHES),
                       "logits": np.asarray(logits).tolist()})


def cmd_keygen(args):
    from .ckks import keys as ckks_keys
    from .io.serialize import save_keys
    p, ctx = _build_context(args.preset, args.device)
    rots = _preset_rotations(p, ctx)
    t0 = time.time()
    keys = ckks_keys.generate_keys(ctx, rotations=rots, conj=True,
                                   keep_secret=not args.secure)
    save_keys(args.keys_dir, keys, include_secret=not args.secure)
    print(f"keys -> {args.keys_dir} in {time.time() - t0:.1f}s "
          f"({len(rots)} rotations, secret "
          f"{'withheld' if args.secure else 'retained'})")


def cmd_golden(args):
    from .client.pipeline import load_sample_embeddings, softmax_argmax
    from .config import get
    from .models import golden
    p = get(args.preset)
    w = _weights(args, p)
    emb = load_sample_embeddings(args.sample_dir)
    _, inter = golden.forward(w, emb, return_intermediates=True)
    cls, probs = softmax_argmax(inter["logits"])
    print(json.dumps({"pred": cls, "prob": float(probs[cls]),
                      "logits": inter["logits"].tolist()}))


def cmd_infer(args):
    from .ckks import keys as ckks_keys
    from .ckks.evaluator import Evaluator
    from .client.pipeline import load_sample_embeddings
    from .io import serialize
    from .models import golden
    from .models.circuit import EncryptedLinformer
    p, ctx = _build_context(args.preset, args.device)
    if args.keys_dir:
        keys = serialize.load_keys(args.keys_dir, ctx)   # no key generation
    else:
        keys = ckks_keys.generate_keys(ctx, rotations=_preset_rotations(p, ctx),
                                       conj=p.bootstrap)
    ev = Evaluator(ctx, keys)
    w = _weights(args, p)
    emb = load_sample_embeddings(args.sample_dir)
    booter = _bootstrapper(p, ev)
    if args.packed:
        from .models.circuit_packed import PackedLinformer
        pc = PackedLinformer(ev, w, p.circuit, d=p.d,
                             chunk_tokens=args.chunk_tokens)
        t0 = time.time()
        # 12 input limbs: the bootstrapped chain's depth before the exp
        out = pc.forward(emb, boot=booter,
                         input_nl=12 if p.bootstrap else None)
        print(_result(pc.decrypt_logits(out), t0, packed=True))
        return
    circ = EncryptedLinformer(ev, w, p.circuit)
    extra = [golden.random_weights(d=p.d, k_lin=p.k_lin, d_ffn=p.d_ffn,
                                   n_classes=p.n_classes, max_seq=p.max_seq,
                                   seed=100 + i)
             for i in range((args.layers or p.layers) - 1)]
    t0 = time.time()
    if args.resume_checkpoint:
        x = serialize.load_ciphertext(args.resume_checkpoint, ctx)
    else:
        x_cts, xe, xf, S_total = circ.encrypt_inputs(
            emb, nl=10 if p.bootstrap else None)
        x = circ.encoder_layer(x_cts, xe, xf, S_total,
                               cls_only=args.cls_only, boot=booter)
        for lw in extra:
            x = circ.next_layer(x, lw, S_total, boot=booter)
        if args.save_checkpoint:
            serialize.save_ciphertext(args.save_checkpoint, x)
    cls_ct = x.with_data(x.c0[0], x.c1[0]) if x.c0.dim() > 2 else x
    out = circ.pooler_classifier(cls_ct, boot=booter)
    print(_result(circ.decrypt_logits(out), t0))


def cmd_eval(args):
    """Accuracy over <root>/test_<i>/input_<t>.txt with <root>/labels.txt;
    --encrypted also runs each sample through the encrypted block-major
    circuit (one key generation) and reports its accuracy and its argmax
    agreement with golden."""
    from .client.pipeline import load_sample_embeddings, softmax_argmax
    from .models import golden
    p, ctx = _build_context(args.preset, args.device)
    w = _weights(args, p)
    with open(os.path.join(args.eval_root, "labels.txt")) as f:
        labels = [int(x) for x in f]
    dirs = sorted((d for d in os.listdir(args.eval_root)
                   if d.startswith("test_")), key=lambda d: int(d[5:]))
    circ = booter = None
    if args.encrypted:
        from .ckks import keys as ckks_keys
        from .ckks.evaluator import Evaluator
        from .models.circuit_packed import PackedLinformer
        ev = Evaluator(ctx, ckks_keys.generate_keys(
            ctx, rotations=_preset_rotations(p, ctx), conj=p.bootstrap))
        booter = _bootstrapper(p, ev)
        circ = PackedLinformer(ev, w, p.circuit, d=p.d,
                               chunk_tokens=args.chunk_tokens)
    correct = total = enc_correct = enc_agree = 0
    for d in dirs:
        idx = int(d[5:])
        emb = load_sample_embeddings(os.path.join(args.eval_root, d))
        probs = golden.forward(w, emb, cls_only=args.cls_only)
        pred, _ = softmax_argmax(np.log(np.maximum(probs, 1e-30)))
        correct += int(pred == labels[idx])
        total += 1
        if circ is not None:
            out = circ.forward(emb, boot=booter,
                               input_nl=12 if p.bootstrap else None)
            epred, _ = softmax_argmax(circ.decrypt_logits(out))
            enc_correct += int(epred == labels[idx])
            enc_agree += int(epred == pred)
    res = {"accuracy": correct / max(total, 1), "n": total}
    if circ is not None:
        res["encrypted_accuracy"] = enc_correct / max(total, 1)
        res["encrypted_golden_agreement"] = enc_agree / max(total, 1)
    print(json.dumps(res))


def cmd_security(args):
    from . import config, security
    names = [args.preset] if args.preset else sorted(config.PRESETS)
    for name in names:
        cfg = config.get(name).ckks
        print(f"{name:18s} {security.assess(cfg)}")
        print(f"{'':18s} estimator: {security.estimator_input(cfg)}")


def cmd_bench(args):
    from .bench import keyswitches_per_s
    print(json.dumps(keyswitches_per_s(args.device)))


def main(argv=None):
    ap = argparse.ArgumentParser("fhe-linformer-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain PyTorch versions of the kernels)")

    kg = sub.add_parser("keygen")
    kg.add_argument("--preset", default="linformer-boot")
    kg.add_argument("--keys-dir", default="keys")
    kg.add_argument("--secure", action="store_true",
                    help="do not keep or persist the secret key")
    device(kg)
    kg.set_defaults(fn=cmd_keygen)

    gd = sub.add_parser("golden")
    gd.add_argument("--preset", default="tiny")
    gd.add_argument("--weights-dir", default=None)
    gd.add_argument("--sample-dir", required=True)
    gd.set_defaults(fn=cmd_golden)

    inf = sub.add_parser("infer")
    inf.add_argument("--preset", default="tiny")
    inf.add_argument("--keys-dir", default=None,
                     help="load the keystore a keygen wrote instead of "
                          "generating keys")
    inf.add_argument("--weights-dir", default=None)
    inf.add_argument("--sample-dir", required=True)
    inf.add_argument("--cls-only", action="store_true")
    inf.add_argument("--packed", action="store_true",
                     help="the block-major circuit (one ciphertext per "
                          "slots/d tokens)")
    inf.add_argument("--chunk-tokens", type=int, default=None,
                     help="block-major circuit: tokens per chunk")
    inf.add_argument("--layers", type=int, default=None,
                     help="encoder layers (default: the preset's); layers "
                          ">= 2 run their K/V compression homomorphically")
    inf.add_argument("--save-checkpoint", default=None)
    inf.add_argument("--resume-checkpoint", default=None)
    device(inf)
    inf.set_defaults(fn=cmd_infer)

    evp = sub.add_parser("eval")
    evp.add_argument("--preset", default="tiny")
    evp.add_argument("--weights-dir", default=None)
    evp.add_argument("--eval-root", required=True)
    evp.add_argument("--cls-only", action="store_true")
    evp.add_argument("--encrypted", action="store_true",
                     help="also run each sample through the encrypted "
                          "circuit; report its accuracy and agreement")
    evp.add_argument("--chunk-tokens", type=int, default=None)
    device(evp)
    evp.set_defaults(fn=cmd_eval)

    sec = sub.add_parser("security", help="HE-standard security assessment")
    sec.add_argument("--preset", default=None,
                     help="preset name (default: every preset)")
    sec.set_defaults(fn=cmd_security)

    bn = sub.add_parser("bench", help="key switches per second")
    device(bn)
    bn.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
