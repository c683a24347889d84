"""The reference application's per-token circuit,
`models/circuit.EncryptedLinformer`: one ciphertext per token, batched on a
leading axis; logits at slots 0, 128, ..., 19 x 128."""


def build(ev, weights, calib, cfg):
    from fhe_linformer_tpu_torch.models.circuit import EncryptedLinformer

    from port_bench.harness import linformer_parts
    w, params = linformer_parts(weights, calib, cfg)
    return EncryptedLinformer(ev, w, params)
