"""The block-major circuit with several heads and a model wider than one
128-lane block, `models/circuit_packed.PackedLinformer(heads=, block=)`:
each ciphertext carries 128 tokens of one 128-feature block, the hidden
state a batch of d / 128 blocks; logits at slots 0..19."""

import inspect

from fhe_linformer_tpu_torch.models.circuit_packed import PackedLinformer

# a program without the multi-head circuit fails here, when the harness
# loads this file, before it generates any key
if "heads" not in inspect.signature(PackedLinformer).parameters:
    raise TypeError("PackedLinformer takes no heads: this program has no "
                    "multi-head packed circuit")


def build(ev, weights, calib, cfg):
    from port_bench.harness import linformer_parts
    w, params = linformer_parts(weights, calib, cfg)
    c = cfg["circuit"]
    return PackedLinformer(ev, w, params, bs=c["bs"], block=c["block"],
                           heads=cfg["model"]["heads"])
