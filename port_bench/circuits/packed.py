"""The block-major circuit, `models/circuit_packed.PackedLinformer`: one
ciphertext carries 128 tokens of 128 dimensions; logits at slots 0..19."""


def build(ev, weights, calib, cfg):
    from fhe_linformer_tpu_torch.models.circuit_packed import PackedLinformer

    from port_bench.harness import linformer_parts
    w, params = linformer_parts(weights, calib, cfg)
    return PackedLinformer(ev, w, params, bs=cfg["circuit"]["bs"])
