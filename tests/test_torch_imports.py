"""The port and its chip script stand alone: no module of
`synt_isic_tpu_torch/`, nor `chip_smoke.py`, imports JAX, Flax, Optax or the
JAX package."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "synt_isic_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "synt_isic_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [name for name in _imports(path) if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
