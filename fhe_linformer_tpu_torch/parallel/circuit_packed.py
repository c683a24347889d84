"""The block-major (packed) circuit with its chunk axis on the mesh's dp
axis: the counterpart of the JAX package's `parallel/circuit_packed.py`.

Chunks never mix outside the replicated K/V broadcast: a chunk's scores,
softmax, value mix, output projection, affine norms, FFN and their
bootstraps read only that chunk and the single XE/XF ciphertexts.  So each
dp rank takes its contiguous block of the chunk axis and runs the encoder
layer on it (`PackedLinformer(batch_chunks=True)`, the (C, k, ...) batched
attention), with XE and XF whole on every rank and `S_total` the global
sequence length (affine's fL).  The pooler and classifier read chunk 0
only, so they run on the rank that holds it, which is rank 0: the logits
are there without a collective.  Use `chunk_tokens` so that the chunk
count divides the dp axis.
"""

from __future__ import annotations

from ..ckks.ciphertext import Ciphertext
from .mesh import block


def packed_forward_dp(circ, mesh, x_ct: Ciphertext, xe: Ciphertext,
                      xf: Ciphertext, S_total: int, boot=None):
    """This rank's chunk block through the encoder layer; then, on the
    rank holding chunk 0, the pooler/classifier.  Returns (the layer's
    output for this rank's chunks, the logits ciphertext or None)."""
    C = x_ct.c0.shape[0]
    b = block(C, mesh.shape["dp"], mesh.coords["dp"])
    y = circ.encoder_layer(x_ct.with_data(x_ct.c0[b], x_ct.c1[b]), xe, xf,
                           S_total, boot=boot)
    out = circ.pooler_classifier(y, boot=boot) if b.start == 0 else None
    return y, out
