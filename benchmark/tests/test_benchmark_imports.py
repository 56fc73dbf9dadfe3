"""What a run loads: no JAX, no JAX package; the reference nothing of the port;
the harness the model of a family only through the family's module.

Module names are compared by their top-level name, whole: the port's
package (`uvhand_tpu_torch`) is not the JAX package (`uvhand_tpu`)."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

from benchmark import spec

JAX_NAMES = {"jax", "jaxlib", "flax", "uvhand_tpu"}


def loaded_after(code: str) -> set:
    """Top-level names in sys.modules of a fresh interpreter after `code`."""
    probe = code + ("\nimport json, sys\n"
                    "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import torch
from benchmark import calibrate, run, spec
from benchmark.tests import tiny_cells
root = tiny_cells.make({str(tmp_path)!r}, "eval")
run.run_cell(tiny_cells.args("eval", trace=1), torch.device("cpu"), root=root)
for m in json.load(open(root + "/BENCHMARK.json"))["per_layer"]:
    spec.reader(m["name"], root)
"""
    loaded = loaded_after("import json\n" + code)
    assert "uvhand_tpu_torch" in loaded  # the system under test did run
    assert not loaded & JAX_NAMES, loaded & JAX_NAMES


def test_the_reference_loads_nothing_of_the_port():
    names = [os.path.splitext(os.path.basename(p))[0]
             for p in glob.glob(os.path.join(spec.ROOT, "benchmark", "reference", "*.py"))]
    code = "\n".join(f"import benchmark.reference.{n}" for n in names if n != "__init__")
    code += """
import torch
from benchmark.reference.model import UVHandDETR
m = UVHandDETR(d_model=32, n_heads=4, num_encoder_layers=1, num_decoder_layers=1,
               dim_feedforward=64, num_queries=20)
m(torch.zeros(2, 64, 64, 3))
"""
    banned = JAX_NAMES | {"uvhand_tpu_torch"}
    loaded = loaded_after(code)
    assert not loaded & banned, loaded & banned


def test_no_reference_source_imports_the_port():
    for path in glob.glob(os.path.join(spec.ROOT, "benchmark", "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]} if node.level == 0 else set()
            else:
                continue
            assert not tops & (JAX_NAMES | {"uvhand_tpu_torch"}), (path, tops)


def imported_modules(path: str) -> set:
    """The modules that the file at `path` imports, relative ones as
    written (`.reference.model`)."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            names |= {base} | {f"{base}.{a.name}".replace("..", ".") for a in node.names}
    return names


def test_the_harness_reaches_a_model_only_through_its_family():
    banned = ("uvhand_tpu_torch.models", "reference.model", "reference.steps")
    for name in ("run.py", "roofline.py", "readers.py", "calibrate.py"):
        found = [m for m in imported_modules(os.path.join(spec.ROOT, "benchmark", name))
                 if any(b in m for b in banned)]
        assert not found, (name, found)
