"""Kernel K1, the forward negacyclic NTT (`ops/ntt_cuda.fwd`).

One call transforms `active` rows of n residues: each row is read and
written once (4 + 4 bytes a residue) and each limb's twiddles with their
Shoup companions are read once (8 bytes a point); a row takes
(n / 2) log2 n Shoup butterflies of 3 32-bit multiplies.  Rows a limb map
marks < 0 are skipped and not counted."""

TARGET = ("fhe_linformer_tpu_torch.ops.ntt_cuda", "fwd")
KERNEL = "ntt_fwd_kernel"
ROOFLINE = "ntt"


def record(x, t, limbs, *_, **__):
    """The call's shape: None when it launches nothing."""
    n = int(x.shape[-1])
    if limbs and isinstance(limbs[0], (tuple, list)):
        entries = [v for row in limbs for v in row if v >= 0]
        per = int(x.numel()) // (n * len(limbs) * len(limbs[0]))
        active, tables = per * len(entries), len(set(entries))
    else:
        active, tables = int(x.numel()) // n, len(limbs)
    return {"n": n, "rows": active, "tables": tables} if active else None


def cost(c):
    """(bytes, 32-bit integer multiplies, int8 tensor-core operations)."""
    n = c["n"]
    return (c["rows"] * n * 8 + c["tables"] * n * 8,
            c["rows"] * (n // 2) * (n.bit_length() - 1) * 3, 0)
