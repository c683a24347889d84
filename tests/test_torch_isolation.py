"""The port stands alone: it imports neither JAX nor the JAX package, no
file of it names either, and it runs on the card unless asked for the CPU.
Its layers below `parallel/` import nothing of it."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "fhe_linformer_tpu_torch"


def test_import_pulls_in_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import fhe_linformer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith("
        "('jax.', 'jaxlib')) or k == 'fhe_linformer_tpu' or "
        "k.startswith('fhe_linformer_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_file_names_jax_or_the_jax_package():
    pattern = re.compile(r"import jax|from jax|fhe_linformer_tpu[^_]")
    files = [f for ext in ("py", "cu", "cuh", "cpp", "h")
             for f in PORT.rglob(f"*.{ext}")] + [ROOT / "chip_smoke.py"]
    assert PORT / "csrc" / "fastio.cpp" in files
    hits = [f"{f.relative_to(ROOT)}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, hits


def test_context_defaults_to_cuda():
    from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
    cfg = CKKSConfig(n=256, scale_bits=26, num_scaling=2, dnum=2)
    if torch.cuda.is_available():
        assert Context(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Context(cfg)
    assert Context(cfg, device="cpu").device.type == "cpu"


def test_lower_layers_import_no_parallel():
    """The layers under the mesh (ckks, ops, poly, linalg, boot, models)
    import nothing of `parallel/`: the mesh evaluator builds on them."""
    hits = []
    for layer in ("ckks", "ops", "poly", "linalg", "boot", "models"):
        for f in sorted((PORT / layer).rglob("*.py")):
            pkg = f.relative_to(ROOT).with_suffix("").parts[:-1]
            for node in ast.walk(ast.parse(f.read_text())):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    base = list(pkg[:len(pkg) - node.level + 1]) \
                        if node.level else []
                    mod = ".".join(base + ([node.module] if node.module
                                           else []))
                    names = [mod] + [f"{mod}.{a.name}" for a in node.names]
                else:
                    continue
                if any(n.split(".")[:2] == [PORT.name, "parallel"]
                       for n in names):
                    hits.append(f"{f.relative_to(ROOT)}:{node.lineno}")
    assert not hits, hits
