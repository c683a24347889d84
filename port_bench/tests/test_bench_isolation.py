"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name; the reference loads nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import BENCH, REPO

from port_bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "fhe_linformer_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_nothing_forbidden():
    for path in BENCH.rglob("*.py"):
        tops = set(_imports(path))
        assert not tops & FORBIDDEN, path
        if path.parent.name == "reference":
            assert not tops & {harness.PORT, "port_bench"}, path


def test_whole_name_comparison():
    assert set(harness.FORBIDDEN) == FORBIDDEN
    sys.modules["fhe_linformer_tpu_torch_probe"] = sys
    try:
        assert "fhe_linformer_tpu_torch_probe" not in \
            harness.forbidden_modules()
    finally:
        del sys.modules["fhe_linformer_tpu_torch_probe"]


_WALK = """
import json, sys
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
from conftest import tiny_cell
from port_bench import run
res = run.measure(tiny_cell("packed"), 7, 0.1, True, device="cpu")
assert res["correct"], res["verdict"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REF = """
import json, sys
sys.path.insert(0, {repo!r})
from pathlib import Path
from port_bench.harness import load_module
b = Path({bench!r})
lin = load_module(b / "reference" / "linformer.py")
ck = load_module(b / "reference" / "ckks.py")
m = {{"d": 8, "k_lin": 4, "d_ffn": 32, "n_classes": 5, "max_seq": 12,
      "weight_scale": 0.3}}
w = lin.make_weights(m, 1, "cpu")
lin.calibrate(w, lin.make_embeddings([7, 5], 8, 0.3, 2, "cpu"))
dec = ck.Decryptor({{"n": 256, "scale_bits": 26, "num_scaling": 4,
                    "first_mod_bits": 30, "dnum": 2, "secret_hw": None}}, 3)
dec.slots([[1] * 256, [2] * 256], [[3] * 256, [4] * 256], 2.0 ** 26, [0, 1])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(script):
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_nothing_forbidden():
    """A whole run at the CPU test size, traced, in a fresh process: the
    program is loaded (so its name, which begins with the JAX package's,
    is not caught by a prefix) and nothing forbidden is."""
    tops = _loaded(_WALK.format(repo=str(REPO),
                                tests=str(BENCH / "tests")))
    assert harness.PORT in tops
    assert not tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    tops = _loaded(_REF.format(repo=str(REPO), bench=str(BENCH)))
    assert not tops & (FORBIDDEN | {harness.PORT})
