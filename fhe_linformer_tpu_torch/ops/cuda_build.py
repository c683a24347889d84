"""Build the native sources of `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers), so one
nvcc call builds it in seconds; `csrc/fastio.cpp`, the host codec, is built
by g++, so it builds on a machine without a card too.  Libraries go to
`build/torch_kernels/` beside the package, named by a hash of their source
(and, for the kernels, the shared headers), at first use, each written to
a temporary file and then renamed, so processes that build at once do not
collide; `build` starts one compiler per missing source, all at once, and
waits for them.  A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SOURCES = ("ntt", "basecvt", "ksmac", "moddown", "modops", "fastio")
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX = "g++"                      # the host compiler of the csrc/*.cpp sources
_HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def _source(name: str) -> Path:
    cu = _CSRC / f"{name}.cu"
    return cu if cu.exists() else _CSRC / f"{name}.cpp"


def library_path(name: str) -> Path:
    """Named by a hash of the source and, for a kernel source, every shared
    `csrc/*.cuh` header, so an edit to either rebuilds."""
    src = _source(name)
    h = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(_CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
    return _BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list[str]:
    src = _source(name)
    if src.suffix == ".cu":
        return [_nvcc(), *_FLAGS, "-o", str(out), str(src)]
    return [GXX, *_HOST_FLAGS, "-o", str(out), str(src)]


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every library in `names` that is not built yet, one compiler
    process per source (nvcc for `.cu`, g++ for `.cpp`), all started
    together.  Returns per source the build seconds (0 when it was already
    built) and the compiler's output (for nvcc, the -Xptxas -v report:
    registers, shared memory, spills)."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            for started, *_ in procs.values():
                started.kill()
                started.wait()
            raise RuntimeError(f"cannot run {cmd[0]} for {_source(name).name}"
                               f": {e}") from e
        procs[name] = (proc, tmp, out, time.perf_counter())
    report = {name: {"seconds": 0.0, "ptxas": ""} for name in names}

    def finish(proc, t0):      # each process's own seconds, not the wait's
        log, _ = proc.communicate()
        return log, time.perf_counter() - t0
    with ThreadPoolExecutor(max(len(procs), 1)) as pool:
        done = {name: pool.submit(finish, proc, t0)
                for name, (proc, _, _, t0) in procs.items()}
    failed = []
    for name, (proc, tmp, out, _) in procs.items():
        log, seconds = done[name].result()
        report[name] = {"seconds": seconds, "ptxas": log}
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{_source(name).name} (rc {proc.returncode}):"
                          f"\n{log}")
        else:
            tmp.replace(out)
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu or .cpp, built first if
    needed: a kernel's first use builds every kernel source not built yet,
    all at once, so a fresh checkout waits for one nvcc, not one per
    kernel in turn."""
    if name not in _loaded:
        kernels = tuple(s for s in SOURCES if _source(s).suffix == ".cu")
        build(kernels if name in kernels else (name,))
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
