"""Kernel K2, the inverse negacyclic NTT (`ops/ntt_cuda.inv`).

Bytes as K1's.  A row takes the Shoup butterflies of all stages but the
last, (n / 2)(log2 n - 1), and n multiplies by n^-1 folded into the last
stage's two outputs, 3 32-bit multiplies each."""

TARGET = ("fhe_linformer_tpu_torch.ops.ntt_cuda", "inv")
KERNEL = "ntt_inv_kernel"
ROOFLINE = "ntt"


def record(x, t, limbs, *_, **__):
    n = int(x.shape[-1])
    rows = int(x.numel()) // n
    return {"n": n, "rows": rows, "tables": int(x.shape[-2])} if rows \
        else None


def cost(c):
    n = c["n"]
    return (c["rows"] * n * 8 + c["tables"] * n * 8,
            c["rows"] * ((n // 2) * (n.bit_length() - 2) + n) * 3, 0)
