"""Readings that set a cell's limit: the program's sound runs beside its
lower-precision controls, on several seeds, in one process per call.

    python3 -m port_bench.control --workload packed-s222 --seconds 51 \
        --seeds 101 102 103 --out build/control-packed-s222.json

For each seed: the inputs, the program and its warm-up as a run makes
them; then a window at the cell's own load with the configuration's
bootstrap (the sound reading), and one window with the program's own
lower-precision path (the bootstrap's paired working scale 2^52 switched
off for the single scale 2^26); on the sound window's requests, the plain
reference computed in lower types put in the program's place (float32,
bfloat16, float16, and fp8 e4m3, the step below bfloat16).  Each reading is the
number the judge compares, max_logit_err.  With --reference-only N, only
the lower types, over the first N requests a window would send, with no
program.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

# the program's lower-precision path, as bootstrap settings
SINGLE_SCALE_BOOT = {"wide": False, "two_pass": False}
LOWER_TYPES = ("float32", "bfloat16", "float16", "float8_e4m3fn")


def readings(cell, seed: int, seconds: float, device="cuda",
             lower_types=LOWER_TYPES) -> dict:
    import torch

    from . import harness, judge
    sub = harness.seeds(seed)
    weights, embs, calib = harness.inputs(cell, seed, device)
    prog = harness.Program(cell, sub["key"], weights, calib, device=device)
    harness.warm_up(cell, prog, embs)
    out = {"seed": seed}
    sound_boot = prog.boot
    run = harness.window(cell, prog, embs, seconds, device)
    v = judge.judge(cell, run, weights, embs, sub["key"])
    out["sound"] = {"max_logit_err": v["max_logit_err"],
                    "requests": len(run["requests"]), "error": run["error"]}
    for t in lower_types:
        lv = judge.judge(cell, run, weights, embs, sub["key"],
                         dtype=getattr(torch, t))
        out[f"reference_{t}"] = {"max_logit_err": lv["max_logit_err"]}
    from fhe_linformer_tpu_torch.boot.bootstrap import Bootstrapper
    bootcfg, two_pass = harness.boot_config(cell.config["boot"],
                                            **SINGLE_SCALE_BOOT)
    prog.boot = Bootstrapper(prog.ev, bootcfg, chunk=sound_boot.chunk,
                             two_pass=two_pass)
    t = time.perf_counter()
    try:
        harness.warm_up(cell, prog, embs)           # its own warm-up
        run = harness.window(cell, prog, embs, seconds, device)
        cv = judge.judge(cell, run, weights, embs, sub["key"])
        out["single_scale_boot"] = {"max_logit_err": cv["max_logit_err"],
                                    "requests": len(run["requests"]),
                                    "error": run["error"],
                                    "s": time.perf_counter() - t}
    except Exception as e:                            # noqa: BLE001
        out["single_scale_boot"] = {"error": f"{type(e).__name__}: {e}"}
    return out


def reference_readings(cell, seed: int, requests: int, device="cuda",
                       lower_types=LOWER_TYPES) -> dict:
    """The plain reference in each lower type against itself in float64,
    over the requests a window sends first (inputs drawn on `device`, as a
    run draws them), with no program."""
    import torch

    from . import harness, judge
    weights, embs, _ = harness.inputs(cell, seed, device)
    run = {"requests": [{"index": cell.entry(i)} for i in range(requests)]}
    key = harness.seeds(seed)["key"]
    return {"seed": seed, **{
        f"reference_{t}": {"max_logit_err": judge.judge(
            cell, run, weights, embs, key,
            dtype=getattr(torch, t))["max_logit_err"]}
        for t in lower_types}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--reference-only", type=int, default=0,
                    help="requests per seed; no program")
    args = ap.parse_args(argv)
    from . import harness
    harness.cache_dirs(Path.cwd())
    cell = harness.Cell(args.workload)
    res = []
    for seed in args.seeds:
        res.append(reference_readings(cell, seed, args.reference_only)
                   if args.reference_only else
                   readings(cell, seed, args.seconds))
        print(json.dumps(res[-1]), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
