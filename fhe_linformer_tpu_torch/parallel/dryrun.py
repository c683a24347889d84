"""The multi-rank dry-run: every sharded path of `parallel/` at the JAX
dry-run's sizes, as one worker for `mesh.launch`.

`dryrun_worker(rank, world, spec)` runs, for each key present in `spec`:

  * "attention": `make_attention_step` on a (dp x limb) mesh over the
    given activations and weights (numpy), returning this rank's block,
    its output and digit sum;
  * "ksprod": the limb-sharded Galois switch and combo on a (1 x world)
    mesh, each directly and through a MeshEvaluator, every result required
    (inside the rank) to equal the single-process switch bit for bit;
    optional `ct_rot` / `ct_combo` arrays to switch instead of fresh
    encryptions; with the rank's `keyswitch_sharded` count;
  * "forwards": a list of dp forwards on a (world x 1) mesh, each a dict
    of `run_forward`'s arguments ("make": a module-level function, default
    `dryrun_make`; "make_args", "inputs", "S_total", "packed"), run in
    turn; on a card the memory each leaves behind is released before the
    next.

The result also carries the rank's kernel launches on the sharded and dp
paths alone: the attention step, the sharded switches (not their
single-process references or the key generation) and the forwards.

The caller holds the results against its references (the JAX package in
the tests, the single-process path on the card in `chip_smoke.py`).
"""

from __future__ import annotations

import gc

import torch

from .circuit import dryrun_make, run_forward
from .ksprod import sharded_combo_parity_check, sharded_rotate_parity_check
from .mesh import make_mesh
from .sharded import make_attention_step


def dryrun_worker(rank, world, spec: dict) -> dict:
    from ..utils.timing import GLOBAL_TIMERS, KERNEL_LAUNCHES, launches_into
    device = spec.get("device")
    launches = {k: 0 for k in KERNEL_LAUNCHES}
    out = {"launches": launches}
    if "attention" in spec:
        a = spec["attention"]
        mesh = make_mesh(a["dp"], a["limb"])
        tables, step = make_attention_step(mesh, a["n"], device)
        bs, rs = mesh.ct_block(*a["x"].shape[:2])
        x = torch.as_tensor(a["x"][bs, rs], device=tables.device)
        wt = torch.as_tensor(a["wt"][rs], device=tables.device)
        with launches_into(launches):
            z, total = step(x, wt)
        out["attention"] = {"batch": (bs.start, bs.stop),
                            "rows": (rs.start, rs.stop), "z": z,
                            "total": total}
    if "ksprod" in spec:
        k = dict(spec["ksprod"])
        ct_rot, ct_combo = k.pop("ct_rot", None), k.pop("ct_combo", None)
        rot, shifts = k.pop("rot"), k.pop("shifts")
        mesh = make_mesh(1, world)
        out["rotate"] = [sharded_rotate_parity_check(
            mesh, rot=rot, via_evaluator=v, device=device, ct=ct_rot, **k)
            for v in (False, True)]
        out["combo"] = [sharded_combo_parity_check(
            mesh, shifts=shifts, via_evaluator=v, device=device,
            ct=ct_combo, **k) for v in (False, True)]
        out["keyswitch_sharded"] = GLOBAL_TIMERS.counts["keyswitch_sharded"]
        for check in out["rotate"] + out["combo"]:
            for name, v in check.pop("launches").items():
                launches[name] += v
    if "forwards" in spec:
        mesh = make_mesh(world, 1)
        out["forwards"] = []
        for f in spec["forwards"]:
            out["forwards"].append(run_forward(
                mesh, f.get("make", dryrun_make), f["make_args"],
                f["inputs"], f["S_total"], f["packed"]))
            for name, v in out["forwards"][-1]["launches"].items():
                launches[name] += v
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return out
