"""Build the CUDA kernels of `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers), so one
nvcc call builds it in seconds.  Libraries go to `build/torch_kernels/`
beside the package, named by a hash of their source and the shared
headers, at first use; `build` starts one nvcc per missing source, all at
once, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCES = ("ntt", "basecvt")
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def library_path(name: str) -> Path:
    """Named by a hash of the source and every shared `csrc/*.cuh` header,
    so an edit to either rebuilds."""
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return _BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every library in `names` that is not built yet, one nvcc
    process per source, all started together.  Returns per source the
    build seconds (0 when it was already built) and nvcc's -Xptxas -v
    report (registers, shared memory, spills)."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report = {name: {"seconds": 0.0, "ptxas": ""} for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    if name not in _loaded:
        build((name,))
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
