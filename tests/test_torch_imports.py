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


@pytest.mark.parametrize("module", ["data/__init__.py", "data/buckets.py", "data/captions.py",
                                    "data/multiplexer.py", "data/native_reader.py",
                                    "data/pipeline.py", "data/wds_reader.py",
                                    "utils/metrics.py", "train/trainer.py", "train/kd.py",
                                    "cli/train.py", "cli/serve.py", "cli/evaluate.py",
                                    "models/clip_vision.py", "utils/fid.py",
                                    "tools/bench_serve.py", "utils/startup.py",
                                    "quant/__init__.py", "quant/int8.py",
                                    "tools/bench_startup.py", "pipelines/controlnet.py",
                                    "models/controlnet.py"])
def test_the_guard_covers_the_data_and_training_modules(module):
    assert REPO / "pea_diffusion_tpu_torch" / module in SOURCES


# the plain fp32 reference the ControlNet serving tests hold the port to
PLAIN_REFERENCE = [REPO / "benchmark" / "reference" / name
                   for name in ("controlnet.py", "controlnet_checks.py", "models.py",
                                "diffusion.py", "checks.py")]


@pytest.mark.parametrize("path", PLAIN_REFERENCE, ids=lambda p: str(p.relative_to(REPO)))
def test_the_plain_reference_imports_neither_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree)
           if _forbidden(m) or m.split(".")[0] == "pea_diffusion_tpu_torch"]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
