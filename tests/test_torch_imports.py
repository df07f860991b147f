"""The port stands alone: no module of legslam_torch/, and not
chip_smoke.py, imports JAX, Flax or the JAX package (legslam_tpu), not
even a module of it that does not import JAX, nor the onnx, lpips or
transformers packages (the JAX package's optional routes to reference
weights: the port reads the weight files itself). Checked on the source with
ast, module by module: plain and from-imports, and importlib /
__import__ calls with a literal name."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "legslam_torch").rglob("*.py")) + \
    ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "legslam_tpu", "onnx", "lpips",
             "transformers")


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            if name in ("import_module", "__import__"):
                yield node.args[0].value


def _forbidden(source: str):
    return sorted({n for n in _imported_names(ast.parse(source))
                   if n.split(".")[0] in FORBIDDEN})


@pytest.mark.parametrize("path", FILES)
def test_module_imports_no_jax(path):
    assert _forbidden((ROOT / path).read_text()) == [], path


def test_the_check_sees_every_form():
    src = ("import jax\nimport numpy, flax.linen as nn\n"
           "from legslam_tpu.ops import binning\n"
           "def f():\n    import importlib\n"
           "    importlib.import_module('jax.numpy')\n"
           "    __import__('legslam_tpu.config')\n"
           "from legslam_torch.config import MapperParams\n")
    assert _forbidden(src) == ["flax.linen", "jax", "jax.numpy",
                               "legslam_tpu.config", "legslam_tpu.ops"]
    assert len(FILES) > 30 and "legslam_torch/mapper/mapper.py" in FILES


def test_tracking_slice_is_checked():
    """The visual tracking slice's modules are among the files checked."""
    for mod in ("slam/tracking", "slam/native", "slam/pose_graph",
                "slam/imu", "ops/stereo", "serving/viewer"):
        assert f"legslam_torch/{mod}.py" in FILES, mod
