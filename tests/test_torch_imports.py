"""The PyTorch port and chip_smoke.py stand on their own: no module of
pea_diffusion_tpu_torch/ and not chip_smoke.py imports jax, flax or anything
of the JAX package (pea_diffusion_tpu), configs included. Checked on the
source with `ast`, so conditional and function-local imports count too."""
import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SOURCES = sorted((REPO / "pea_diffusion_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pea_diffusion_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_guard_catches_the_jax_package_but_not_the_port():
    tree = ast.parse("import jax.numpy\nfrom pea_diffusion_tpu.ops import x\n"
                     "from pea_diffusion_tpu_torch.ops import y\n"
                     "def f():\n    import flax.linen\n")
    assert [m for m in _imported_modules(tree) if _forbidden(m)] == [
        "jax.numpy", "pea_diffusion_tpu.ops", "flax.linen"]
