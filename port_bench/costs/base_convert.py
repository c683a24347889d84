"""Kernel K3, the fused fold and fast base conversion
(`ops/basecvt.base_convert_cuda`).

A call converts B x g_valid source rows of n residues into nd digits of
tgt target rows: sources read once and outputs written once, 4 bytes a
residue.  On the tensor cores, each digit and coefficient is one
(4 tgt) x (4 alpha_j) product of balanced int8 planes over the digit's own
sources, 2 operations a multiply-add, g_valid sources in all.  On the CUDA
cores, the fold (3 multiplies a source unless prefolded) and the
epilogue's two Shoup steps (6 multiplies an output)."""

TARGET = ("fhe_linformer_tpu_torch.ops.basecvt", "base_convert_cuda")
KERNEL = "base_convert_kernel"
ROOFLINE = "base_convert"


def record(x, bc, prefolded=False, *_, **__):
    g, n = int(x.shape[-2]), int(x.shape[-1])
    return {"n": n, "batch": int(x.numel()) // (g * n), "g_valid": g,
            "nd": int(bc.nd), "tgt": int(bc.q_out.shape[0]),
            "prefolded": bool(prefolded)}


def cost(c):
    B, n, g, nd, tgt = c["batch"], c["n"], c["g_valid"], c["nd"], c["tgt"]
    return (4 * B * n * (g + nd * tgt),
            B * n * ((0 if c["prefolded"] else 3 * g) + 6 * nd * tgt),
            2 * B * n * (4 * tgt) * (4 * g))
