"""The dry-run's sharded step: a slice of the encrypted data path over a
(dp x limb) mesh, the counterpart of the JAX package's
`parallel/sharded.py`.

Each rank holds its (batch, limb) block of the activations (batch over dp,
limbs over limb) and its limb block of the weights.  The NTT (K1), the
ct x pt product and the inverse NTT (K2) are limb-local; the one
cross-limb step, a base conversion of batch element 0 to the first prime,
sums each rank's terms (each below q0) and reduces them with ONE sum
all-reduce over the limb axis, then folds the sum below q0.  The JAX
package's sum is a lazy u32 psum, exact only for up to 4 limbs; the
port's is int64 and keeps the JAX bound and its three folds for parity.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ckks import context
from ..ops import ntt
from ..ops.modarith import mulmod
from ..ops.ntt import NttTables
from ..primes import ntt_primes


def make_attention_step(mesh, n: int = 512, device=None):
    """(tables, step): the full NTT tables over the limb axis's primes (one
    per limb rank) and step(x_l, wt_l) -> (z_l, total) on this rank's (B_loc, per, n) block
    of the activations and (per, n) block of the weights: z_l the block of
    iNTT(NTT(x) * wt), total the (1, n) digit sum of this rank's batch
    element 0, the same on every rank of its limb axis."""
    n_limb = mesh.shape["limb"]
    assert n_limb <= 4, "lazy psum exactness bound: digit groups <= 4 limbs"
    qs = ntt_primes(2 * n, n_limb)
    tables = NttTables(n, qs, context.resolve_device(device))
    rows = mesh.limb_block(len(qs))
    limbs = tuple(range(len(qs)))[rows]
    qcol = np.asarray(qs, np.int64).reshape(-1, 1)
    q = torch.as_tensor(qcol[rows].astype(np.int32), device=tables.device)
    # (Qhat / q_t) mod q0: the conversion to the first prime
    conv = torch.as_tensor(((qcol // 3) % qs[0])[rows], device=tables.device)
    comm = mesh.comms["limb"]
    q0 = qs[0]

    def step(x_l, wt_l):
        y = mulmod(ntt.fwd(x_l, tables, limbs), wt_l, q)
        z = ntt.inv(y, tables, limbs)
        term = torch.remainder(z[0].long() * conv, q0)
        total = comm.all_reduce(term.sum(0, keepdim=True))
        for _ in range(3):
            total = torch.where(total >= q0, total - q0, total)
        return z, total

    return tables, step
