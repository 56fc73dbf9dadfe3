"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to fall back to the CPU when no card is present."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "uvhand_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "uvhand_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_SOURCES
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    from uvhand_tpu_torch import engine
    from uvhand_tpu_torch.geometry import mano, objects
    from uvhand_tpu_torch.models.detr import UVHandDETR

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: UVHandDETR(num_queries=4, num_encoder_layers=1, num_decoder_layers=1),
                  lambda: mano.synthetic_mano(0),
                  lambda: objects.synthetic_object_bank(0),
                  lambda: engine.make_eval_step(None, None, None, None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
