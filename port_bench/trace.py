"""What a `--trace 1` run records: spans around the program's layers, its
counters per request, each kernel's calls by shape, and the profiler's
device activity over the first requests of the window.

Spans come from the benchmark's own wrappers around the calls into each
layer.  The window's requests are of three kinds (`Spans.kind`):
  profiled  the first requests, under the profiler; their spans take the
            host's clock only, with no synchronize, and say what the host
            was doing during each idle gap of the device;
  spanned   every other request after those: each span behind a
            synchronize at both ends, so it holds the device work it
            launched (the stage and bootstrap seconds);
  plain     the rest: no span and no profiler, as in an untraced run (the
            request seconds of request_mfu).
Nothing is written to disk: the profiler's events are read in memory and
reduced here.
"""

from __future__ import annotations

import contextlib
import importlib
import time

import numpy as np

# circuit methods spanned; both circuits have them
STAGES = ("encrypt_inputs", "attention", "ffn", "pooler_classifier")
# the program's counters, per request
COUNTERS = ("keyswitch", "combo_rot", "bootstrap")


class Spans:
    """Named spans (name, start ns, end ns, request, synchronized) on the
    host's monotonic clock, the kind of each request, and per-request
    counter deltas."""

    def __init__(self, device, profiled: int = 1):
        self.device = device
        self.profiled = profiled
        self.spans: list[tuple[str, int, int, int, bool]] = []
        self.counts: list[dict] = []
        self.kinds: dict[int, str] = {}
        self.request = -1
        self._c0: dict = {}

    def kind(self, i: int) -> str:
        """Request i's kind: the first `profiled` are profiled, then every
        other one is spanned, starting with the first after them."""
        if i < self.profiled:
            return "profiled"
        return "spanned" if (i - self.profiled) % 2 == 0 else "plain"

    def _sync(self):
        from .harness import sync
        sync(self.device)

    def wrap(self, obj, name: str, label: str | None = None):
        """Shadow obj.name with a call of the original that is spanned as
        the current request's kind says."""
        orig = getattr(obj, name)

        def spanned(*args, **kw):
            synced = self.kinds.get(self.request) == "spanned"
            if self.kinds.get(self.request) == "plain":
                return orig(*args, **kw)
            if synced:
                self._sync()
            t = time.perf_counter_ns()
            try:
                return orig(*args, **kw)
            finally:
                if synced:
                    self._sync()
                self.spans.append((label or name, t, time.perf_counter_ns(),
                                   self.request, synced))
        setattr(obj, name, spanned)

    def instrument(self, prog) -> None:
        for stage in STAGES:
            if hasattr(prog.circ, stage):
                self.wrap(prog.circ, stage)
        if prog.boot is not None:
            prog.boot = _Boot(prog.boot, self)

    def on_request(self, i: int, phase: str) -> None:
        from fhe_linformer_tpu_torch.utils.timing import GLOBAL_TIMERS
        if phase == "start":
            self.request = i
            self.kinds[i] = self.kind(i)
            self._c0 = dict(GLOBAL_TIMERS.counts)
            self._t = time.perf_counter_ns()
        else:
            self.counts.append({k: GLOBAL_TIMERS.counts.get(k, 0)
                                - self._c0.get(k, 0) for k in COUNTERS})
            self.spans.append(("request", self._t, time.perf_counter_ns(), i,
                               False))

    def per_request(self, name: str) -> list[float]:
        """Seconds of the synchronized span `name` summed within each
        spanned request that has one."""
        out: dict[int, float] = {}
        for n, t0, t1, r, synced in self.spans:
            if n == name and synced:
                out[r] = out.get(r, 0.0) + (t1 - t0) / 1e9
        return list(out.values())


class _Boot:
    """The bootstrapper handed to the circuit in a traced run: each call of
    `refresh` or `bootstrap` from the circuit is one "bootstrap" span (the
    real bootstrapper's own calls inside it are not spanned again); the
    rest passes through."""

    def __init__(self, boot, spans: Spans):
        self._boot = boot
        spans.wrap(self, "refresh", "bootstrap")
        spans.wrap(self, "bootstrap", "bootstrap")

    def refresh(self, ct):
        return self._boot.refresh(ct)

    def bootstrap(self, ct, *args, **kw):
        return self._boot.bootstrap(ct, *args, **kw)

    def __getattr__(self, name):
        return getattr(self._boot, name)


@contextlib.contextmanager
def kernel_calls(kernels):
    """Records each kernel wrapper's calls by shape while the block runs:
    yields {kernel module: [record, ...]} (a record of None launched
    nothing and is dropped).  A wrapper the program no longer has is left
    out."""
    calls, undo = {}, []
    for k in kernels:
        mod_name, attr = k.TARGET
        try:
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
        except (ImportError, AttributeError):
            continue
        calls[k] = []

        def wrapped(*args, _orig=orig, _k=k, **kw):
            try:
                rec = _k.record(*args, **kw)
            except Exception:                        # noqa: BLE001
                rec = {"unreadable": True}
            if rec is not None:
                calls[_k].append(rec)
            return _orig(*args, **kw)
        setattr(mod, attr, wrapped)
        undo.append((mod, attr, orig))
    try:
        yield calls
    finally:
        for mod, attr, orig in undo:
            setattr(mod, attr, orig)


def device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device activity the profiler
    kept, on the profiler's clock."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def reduce(events, t0: int, t1: int, spans, clock_offset: int,
           kernels, calls) -> dict:
    """The traced window [t0, t1) (profiler clock): device busy seconds (the
    union of activity), the idle gaps summed by the innermost span open at
    each gap's middle (on the host's clock: what the host was doing),
    device seconds by operation, and per kernel its traced launches'
    seconds beside its calls."""
    ev = sorted((s, e, n) for n, s, e in events if e > t0 and s < t1)
    busy, gaps, cur_s, cur_e = 0, [], None, t0
    for s, e, _ in ev:
        s, e = max(s, t0), min(e, t1)
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    gaps.append((cur_e, t1))
    gaps = np.asarray([g for g in gaps if g[1] > g[0]], np.int64).reshape(-1, 2)
    mids = gaps.sum(1) // 2
    order = np.argsort(mids)
    gaps, mids = gaps[order], mids[order]
    label = np.full(len(mids), -1)
    names = []
    # outer spans first, so the innermost span open at a gap's middle
    # names it
    for n, a, b, *_ in sorted(spans, key=lambda sp: sp[1] - sp[2]):
        lo, hi = np.searchsorted(mids, [a + clock_offset, b + clock_offset])
        if hi > lo:
            if n not in names:
                names.append(n)
            label[lo:hi] = names.index(n)
    idle: dict[str, float] = {}
    secs = (gaps[:, 1] - gaps[:, 0]) / 1e9
    for j, n in enumerate(names + ["outside_requests"]):
        sel = label == (j if j < len(names) else -1)
        if sel.any():
            idle[n] = float(secs[sel].sum())
    by_op: dict[str, float] = {}
    for s, e, n in ev:
        by_op[n[:100]] = by_op.get(n[:100], 0.0) + (e - s) / 1e9
    per_kernel = {}
    for k, recs in calls.items():
        times = [(e - s) / 1e9 for s, e, n in ev if k.KERNEL in n]
        per_kernel[k] = {"calls": recs, "seconds": times}
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy / 1e9, "window_s": (t1 - t0) / 1e9,
            "device_ops": top(by_op), "idle_gaps": top(idle),
            "kernels": per_kernel}
