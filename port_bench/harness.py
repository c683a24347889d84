"""The benchmark's general parts: the manifest and the files it names, the
seeds, the inputs, the program's set-up, the closed loop and the result.

Everything that belongs to one configuration, traffic mix, per-layer metric
or kernel sits in a file of its own that is found by its name:
  configs/<config>.json      sizes and settings of the program
  circuits/<kind>.py         how the program's circuit of that kind is built
  traffic/<traffic>.json     the request mix (keys in TRAFFIC_KEYS)
  metrics/<metric>.py        a reader: read(run) -> number or None
  costs/<kernel>.py          a kernel's bytes and operations per call
  cells/<workload>.census.json  the work of one request, frozen
  reference/<reference>.py   the plain model
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
PORT = "fhe_linformer_tpu_torch"
# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", PORT.removesuffix("_torch"))
# what a traffic file may say; the harness runs one client in a closed loop
# and refuses a file that asks for anything else
TRAFFIC_KEYS = {"loop", "clients", "seq_lens", "pool", "embedding_std",
                "source", "why"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark by its file, under a name of its own."""
    name = "port_bench_" + "_".join(path.relative_to(BENCH).with_suffix("")
                                    .parts).replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of the manifest with the files it names."""

    def __init__(self, name: str, manifest: dict | None = None,
                 bench: Path = BENCH, traffic_dir: Path | None = None):
        self.bench = bench
        self.manifest = manifest or load_json(bench.parent / "BENCHMARK.json")
        found = [w for w in self.manifest["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in the manifest")
        self.workload = found[0]
        entry = [c for c in self.manifest["configs"]
                 if c["name"] == self.workload["config"]][0]
        self.config = load_json(bench.parent / entry["file"])
        self.traffic = check_traffic(load_json(
            (traffic_dir or bench / "traffic")
            / f"{self.workload['traffic']}.json"))
        census = bench / "cells" / f"{name}.census.json"
        self.census = load_json(census) if census.exists() else None
        self.peaks = load_json(bench / "peaks.json")

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports in a run with or without trace."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.manifest[key]
                if self.workload["name"] in m.get("workloads",
                                                  [self.workload["name"]])]

    def reader(self, metric: str):
        return load_module(self.bench / "metrics" / f"{metric}.py")

    def kernels(self) -> list:
        """The cost modules of every kernel the benchmark knows."""
        return [load_module(p) for p in sorted((self.bench / "costs")
                                               .glob("*.py"))]

    def circuit(self):
        return load_module(self.bench / "circuits"
                           / f"{self.config['circuit']['kind']}.py")

    def reference(self):
        return load_module(self.bench / "reference"
                           / f"{self.config['reference']}.py")

    def lengths(self) -> list[int]:
        """Sequence length S (tokens with CLS) of each pool entry: entry j
        has the traffic's seq_lens[j % len(seq_lens)]."""
        lens, pool = self.traffic["seq_lens"], self.traffic["pool"]
        return [lens[j % len(lens)] for j in range(pool)]

    def warm_entries(self) -> list[int]:
        """The pool entries of the warm-up: the first of each length."""
        first: dict[int, int] = {}
        for j, s in enumerate(self.traffic["seq_lens"]):
            first.setdefault(s, j)
        return sorted(first.values())

    def entry(self, i: int) -> int:
        """The pool entry that window request i carries: the pool in order
        after the warm-up's cycle of lengths, cycled."""
        return (len(self.traffic["seq_lens"]) + i) % self.traffic["pool"]


def check_traffic(tr: dict) -> dict:
    """The traffic file as the harness runs it, or ValueError where it asks
    for what the harness does not do."""
    extra = set(tr) - TRAFFIC_KEYS
    if extra:
        raise ValueError(f"traffic keys the harness does not read: "
                         f"{sorted(extra)}")
    if tr.get("loop", "closed") != "closed" or tr.get("clients", 1) != 1:
        raise ValueError("the harness runs one client in a closed loop; "
                         f"the traffic asks for loop {tr.get('loop')!r}, "
                         f"clients {tr.get('clients')!r}")
    lens, pool = tr["seq_lens"], tr["pool"]
    if not lens or any(int(s) != s or s < 2 for s in lens):
        raise ValueError(f"seq_lens must be lengths of 2 or more: {lens}")
    if pool <= len(lens) or pool % len(lens):
        raise ValueError(f"pool {pool} must be a multiple of the "
                         f"{len(lens)} seq_lens, above it")
    return tr


def seeds(seed: int) -> dict[str, int]:
    """Independent sub-seeds of the run's seed: the CKKS key and encryption
    draws, the weights, the request embeddings."""
    state = np.random.SeedSequence(int(seed) % 2 ** 64).generate_state(
        3, dtype=np.uint64)
    return {"key": int(state[0]) >> 1, "weights": int(state[1]) >> 1,
            "embeddings": int(state[2]) >> 1}


def inputs(cell: Cell, seed: int, device) -> tuple[dict, list, dict]:
    """(weights, request embeddings, calibration) of a run: the weights and
    a pool of embeddings (entry j of S_j - 1 tokens, `Cell.lengths`) drawn
    on `device` from the seed, and the circuit's intervals calibrated over
    every embedding of the pool."""
    ref = cell.reference()
    cfg, tr = cell.config, cell.traffic
    s = seeds(seed)
    w = ref.make_weights(cfg["model"], s["weights"], device)
    embs = ref.make_embeddings([n - 1 for n in cell.lengths()],
                               cfg["model"]["d"], tr["embedding_std"],
                               s["embeddings"], device)
    return w, embs, ref.calibrate(w, embs)


def rotations(ctx, cfg) -> tuple[int, ...]:
    """The circuit's rotation keys: power-of-two shifts of both signs for
    the rotate-accumulate trees, and the baby and giant shifts of a d x d
    block matmul's BSGS split at the configuration's baby size (its main
    diagonals u and wrap diagonals u - d)."""
    from fhe_linformer_tpu_torch.linalg.packed import PackedOps
    slots, d = ctx.cfg.slots, cfg["model"]["d"]
    rots, s = set(), 1
    while s < slots:
        rots |= {s, -s}
        s *= 2
    offsets = list(range(d)) + [(u - d) % slots for u in range(1, d)]
    for r in PackedOps.bsgs_required_rotations(offsets, cfg["keys"]["bs"],
                                               slots):
        rots.add(r if r < slots // 2 else r - slots)
    return tuple(sorted(rots))


def boot_config(boot: dict, **overrides):
    """(BootConfig, two_pass) from a configuration's `boot` block, every
    field written out there, with `overrides` (the control's)."""
    from fhe_linformer_tpu_torch.boot.bootstrap import BootConfig
    b = dict(boot, **overrides)
    two_pass = b.pop("two_pass", None)
    b["level_budget"] = tuple(b["level_budget"])
    return BootConfig(**b), two_pass


class Program:
    """The port set up for one configuration: context, keys, evaluator,
    bootstrapper and circuit (built by the configuration's circuits/ file
    from the drawn weights and the calibration).  `forward` answers one
    request up to the output ciphertext, `decrypt` is the client's decrypt
    of it."""

    def __init__(self, cell: Cell, key_seed: int, weights: dict, calib: dict,
                 device="cuda"):
        from fhe_linformer_tpu_torch.boot.bootstrap import Bootstrapper
        from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
        from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
        from fhe_linformer_tpu_torch.ckks.keys import generate_keys
        cfg = cell.config
        ck = {k: v for k, v in cfg["ckks"].items() if k != "preset"}
        self.ctx = Context(CKKSConfig(**ck, seed=key_seed), device=device)
        bootcfg, two_pass = boot_config(cfg["boot"]) if cfg.get("boot") \
            else (None, None)
        mod = cell.circuit()
        rots = rotations(self.ctx, cfg)
        if bootcfg is not None:
            rots = tuple(sorted(set(rots) | set(
                Bootstrapper.rotations_for(self.ctx.cfg.n, bootcfg))))
        self.keys = generate_keys(self.ctx, rotations=rots,
                                  conj=bootcfg is not None)
        self.ev = Evaluator(self.ctx, self.keys)
        self.boot = None if bootcfg is None else Bootstrapper(
            self.ev, bootcfg, chunk=cfg["circuit"].get("boot_chunk", 0),
            two_pass=two_pass)
        self.circ = mod.build(self.ev, weights, calib, cfg)
        self.input_nl = cfg["input_nl"]

    def forward(self, emb: np.ndarray):
        return self.circ.forward(emb, boot=self.boot, input_nl=self.input_nl)

    def decrypt(self, out) -> np.ndarray:
        return np.asarray(self.circ.decrypt_logits(out), np.float64)


def sync(device) -> None:
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def linformer_parts(weights: dict, calib: dict, cfg: dict):
    """(LinformerWeights, CircuitParams) of the one-layer Linformer
    circuits from the drawn weights, the calibration and the
    configuration's approximation degrees."""
    from fhe_linformer_tpu_torch.models.circuit import CircuitParams
    from fhe_linformer_tpu_torch.models.golden import LinformerWeights
    params = CircuitParams(inv_range=tuple(calib["inv_range"]),
                           gelu_clip=calib["gelu_clip"],
                           tanh_scale=calib["tanh_scale"],
                           **cfg["approximation"])
    return LinformerWeights(**{k: v.numpy() for k, v in weights.items()}), \
        params


def warm_up(cell: Cell, prog: Program, embs) -> None:
    """One request of each length the traffic sends, which fills the
    plaintext caches a warm server holds."""
    for j in cell.warm_entries():
        prog.decrypt(prog.forward(embs[j].numpy()))


def window(cell: Cell, prog: Program, embs, seconds: float, device,
           on_request=None) -> dict:
    """The closed loop: one client sends the next request when the last
    has been answered, until a request ends `seconds` after the first
    began.  Request i carries the pool's entry `cell.entry(i)`.  A request
    runs from the client's encrypt to the logits in host memory (the
    decrypt copies them there, so no other synchronize is needed).
    `on_request(i, phase)` is called before ("start") and after ("end")
    each request; the window's clock leaves out the time spent in it (a
    traced run stops its profiler there).  Returns the requests' latencies,
    inputs, output ciphertexts and logits, and the window's seconds."""
    done, attempted, error, hooks = [], 0, None, 0.0

    def hook(i, phase):
        nonlocal hooks
        if on_request:
            t = time.perf_counter()
            on_request(i, phase)
            hooks += time.perf_counter() - t
    sync(device)
    t_win = time.perf_counter()
    while True:
        i = attempted
        j = cell.entry(i)
        emb = embs[j].numpy()
        attempted += 1
        hook(i, "start")
        t = time.perf_counter()
        try:
            out = prog.forward(emb)
            logits = prog.decrypt(out)
        except Exception as e:                       # noqa: BLE001
            error = f"request {i}: {type(e).__name__}: {e}"
            break
        end = time.perf_counter()
        elapsed = end - t_win - hooks
        hook(i, "end")
        done.append({"index": j, "s": end - t,
                     "out": (out.c0, out.c1, out.nl, out.scale),
                     "logits": logits})
        if elapsed >= seconds:
            break
    return {"requests": done, "attempted": attempted, "error": error,
            "window_s": time.perf_counter() - t_win - hooks}


def percentile(values, q: float) -> float:
    """The q-th percentile with linear interpolation between order
    statistics (numpy's default), over every value given."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end(run: dict, setup_s: float, peak_bytes: int,
               max_err: float) -> dict:
    lat = [r["s"] for r in run["requests"]]
    n = len(lat)
    return {"request_s": run["window_s"] / n if n else None,
            "request_p90_s": percentile(lat, 90) if n else None,
            "logit_bits": -math.log2(max_err) if 0 < max_err < math.inf
            else None,
            "peak_device_gb": peak_bytes / 1e9,
            "setup_s": setup_s}


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = root / "build" / "port_bench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)
