"""Run one cell of the port's benchmark and print its result line.

    python3 -m port_bench.run --workload packed-s222 --seed 7 --seconds 10 \
        --trace 0

One process: set-up (imports, the kernels' build or load, context, keys,
calibration, one warm-up request of each length the traffic sends), then
one client in a closed loop for --seconds, then the judgement against the plain reference.
The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error.  Without a CUDA card
it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse        # noqa: E402
import json            # noqa: E402
import math            # noqa: E402
import sys             # noqa: E402
from pathlib import Path  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card(chips: int) -> dict | None:
    """The card's description, or None when fewer than `chips` CUDA cards
    are present."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def measure(cell, seed: int, seconds: float, trace: bool, device="cuda",
            t_start: float | None = None) -> dict:
    """Set-up, window and judgement of one run.  Returns the result's parts
    (without `device`'s card fields) and the numbers compared."""
    import torch

    from . import harness, judge
    from . import trace as tr
    t_start = time.perf_counter() if t_start is None else t_start
    steps = {"imports": time.perf_counter() - t_start}
    sub = harness.seeds(seed)
    t = time.perf_counter()
    weights, embs, calib = harness.inputs(cell, seed, device)
    steps["inputs_and_calibration"] = time.perf_counter() - t
    t = time.perf_counter()
    prog = harness.Program(cell, sub["key"], weights, calib, device=device)
    harness.sync(device)
    steps["context_and_keys"] = time.perf_counter() - t
    # warm-up: one request of each length the traffic sends
    t = time.perf_counter()
    harness.warm_up(cell, prog, embs)
    harness.sync(device)
    steps["warm_up_request"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    spans = prof = calls_cm = None
    traced = {}
    if trace:
        n_prof = cell.config.get("trace_requests", 1)
        spans = tr.Spans(device, profiled=n_prof)
        spans.instrument(prog)
        kernels = cell.kernels()
        # the profiler starts before the window: its start-up is no
        # request's; only the profiled requests' activity is kept
        prof = _profiler(device)
        prof.__enter__()

        def on_request(i, phase):
            nonlocal calls_cm
            if phase == "start" and i == 0:
                calls_cm = tr.kernel_calls(kernels)
                traced["calls"] = calls_cm.__enter__()
                harness.sync(device)
                traced["offset"] = time.time_ns() - time.perf_counter_ns()
                traced["t0"] = time.perf_counter_ns()
            spans.on_request(i, phase)
            if phase == "end" and i == n_prof - 1:
                harness.sync(device)
                traced["t1"] = time.perf_counter_ns()
                prof.__exit__(None, None, None)
                calls_cm.__exit__(None, None, None)
                traced["requests"] = n_prof
    else:
        on_request = None
    run = harness.window(cell, prog, embs, seconds, device,
                         on_request=on_request)
    if prof is not None and "t1" not in traced:     # the window broke off
        prof.__exit__(None, None, None)
        if calls_cm is not None:
            calls_cm.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    # the program's state goes before the reference runs
    for r in run["requests"]:
        c0, c1, nl, scale = r["out"]
        r["out"] = (c0.cpu(), c1.cpu(), nl, scale)
    del prog
    if device != "cpu":
        torch.cuda.empty_cache()
    verdict = judge.judge(cell, run, weights, embs, sub["key"])
    limit = cell.config["limits"]["max_logit_err"]
    failed = run["attempted"] - len(run["requests"])
    correct = (failed == 0 and run["error"] is None
               and verdict["max_logit_err"] <= limit)
    out = {"correct": bool(correct), "attempted": run["attempted"],
           "failed": failed, "peak": peak, "run": run, "verdict": verdict,
           "limit": limit, "setup_s": setup_s, "setup_steps": steps}
    if trace:
        out["record"] = _record(cell, run, spans, prof, traced)
    return out


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if device != "cpu" else \
        [ProfilerActivity.CPU]
    return profile(activities=acts)


def _record(cell, run, spans, prof, traced) -> dict:
    """What the per-layer readers read."""
    from . import trace as tr
    rec = {"requests": run["requests"], "window_s": run["window_s"],
           "kinds": [spans.kinds[i] for i in range(len(run["requests"]))],
           "lengths": cell.lengths(),
           "spans": spans, "census": cell.census, "peaks": cell.peaks,
           "trace": None}
    if "t1" in traced:
        events = tr.device_events(prof)
        off = traced["offset"]
        rec["trace"] = tr.reduce(events, traced["t0"] + off,
                                 traced["t1"] + off, spans.spans, off,
                                 cell.kernels(), traced["calls"])
        rec["trace"]["requests"] = traced["requests"]
    return rec


def metrics_of(cell, res: dict, trace: bool) -> dict:
    from . import harness
    if not trace:
        vals = harness.end_to_end(res["run"], res["setup_s"], res["peak"],
                                  res["verdict"]["max_logit_err"])
    else:
        vals = {m["name"]: cell.reader(m["name"]).read(res["record"])
                for m in cell.metrics(trace=True)}
    out = {}
    for m in cell.metrics(trace):
        v = vals.get(m["name"])
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    root = Path.cwd()
    from . import harness
    harness.cache_dirs(root)
    cell = harness.Cell(args.workload)
    dev = card(cell.workload["chips"])
    if dev is None:
        print("no CUDA card (or fewer than the cell asks for): no result",
              file=sys.stderr)
        return 2
    res = measure(cell, args.seed, args.seconds, bool(args.trace),
                  t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    trace = bool(args.trace)
    dev["memory_peak_bytes"] = int(res["peak"])
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"],
            "metrics": metrics_of(cell, res, trace), "device": dev}
    if trace and res["record"]["trace"] is not None:
        t = res["record"]["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    v = res["verdict"]
    line["compared"] = {"max_logit_err": {"value": v["max_logit_err"],
                                          "limit": res["limit"]}}
    if res["run"]["error"]:
        print(res["run"]["error"], file=sys.stderr)
    print(f"requests {len(res['run']['requests'])} in "
          f"{res['run']['window_s']:.3f} s; per-request errors "
          f"{[round(e, 9) for e in v['errors']]}; client decrypt against "
          f"the reference's decrypt {v['decrypt_gap']:.3e}", file=sys.stderr)
    if trace:
        by_kind: dict[str, list[float]] = {}
        for r, k in zip(res["run"]["requests"], res["record"]["kinds"]):
            by_kind.setdefault(k, []).append(r["s"])
        print("mean request seconds by kind " + " ".join(
            f"{k} {sum(v) / len(v):.4f} ({len(v)})"
            for k, v in by_kind.items()), file=sys.stderr)
    print("set-up " + " ".join(f"{k} {v:.3f} s" for k, v in
                               res["setup_steps"].items()), file=sys.stderr)
    print(f"max_logit_err {v['max_logit_err']!r} limit {res['limit']!r}",
          file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
