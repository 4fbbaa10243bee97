"""The port stands alone: nothing under `pixflow_tpu_torch/`, nor
`chip_smoke.py`, imports JAX, flax, optax or the JAX package."""

import ast
from pathlib import Path

import pytest

from torch_threads import cap_torch_threads

cap_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pixflow_tpu")
FILES = sorted((ROOT / "pixflow_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_files_exist():
    assert (ROOT / "pixflow_tpu_torch" / "__init__.py").exists()
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 20
    # the data-parallel layer and its entry point are checked below too
    for rel in ("parallel/__init__.py", "parallel/dist.py", "parallel/multihost.py",
                "main_pretrain_multihost.py"):
        assert ROOT / "pixflow_tpu_torch" / rel in FILES, rel


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
