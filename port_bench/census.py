"""Take a cell's census: the work of one warm request of each length the
traffic sends, by shape.

    python3 -m port_bench.census --workload packed-s222 --seed 11 \
        --out build/packed-s222.census.json

Set-up as a run's, then for each length one request under a dispatch mode
that counts the elements of every int64 elementwise product the request's
torch operations make, with each kernel wrapper's calls recorded by shape
(costs/*.py).  The file it writes is frozen as
cells/<workload>.census.json, which metrics/request_mfu.py reads.  The
circuit's work does not depend on the data, so one request of one seed
stands for every request of its length.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def census(cell, seed: int, device="cuda") -> dict:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from . import harness
    from . import trace as tr
    sub = harness.seeds(seed)
    weights, embs, calib = harness.inputs(cell, seed, device)
    prog = harness.Program(cell, sub["key"], weights, calib, device=device)
    harness.warm_up(cell, prog, embs)
    muls = (torch.ops.aten.mul.Tensor, torch.ops.aten.mul.Scalar,
            torch.ops.aten.mul_.Tensor, torch.ops.aten.mul_.Scalar)
    out = {"workload": cell.workload["name"], "seed": seed, "lengths": {}}
    lengths = cell.lengths()
    for i in range(len(cell.warm_entries())):
        j = cell.entry(i)
        products: dict[int, int] = {}

        class Count(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                got = func(*args, **(kwargs or {}))
                if func in muls and got.dtype == torch.int64:
                    limbs = int(got.shape[-2]) if got.dim() >= 2 else 1
                    products[limbs] = products.get(limbs, 0) + got.numel()
                return got

        with tr.kernel_calls(cell.kernels()) as calls, Count():
            prog.decrypt(prog.forward(embs[j].numpy()))
        harness.sync(device)
        one = {"int64_products": sorted([[k, v] for k, v in
                                         products.items()])}
        for k, recs in calls.items():
            agg: dict[str, int] = {}
            for r in recs:
                key = json.dumps(r, sort_keys=True)
                agg[key] = agg.get(key, 0) + 1
            one[Path(k.__file__).stem] = \
                [[json.loads(s), c] for s, c in sorted(agg.items())]
        out["lengths"][str(lengths[j])] = one
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    from . import harness
    harness.cache_dirs(Path.cwd())
    res = census(harness.Cell(args.workload), args.seed)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(json.dumps({s: {k: (v if k == "int64_products" else len(v))
                          for k, v in one.items()}
                      for s, one in res["lengths"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
