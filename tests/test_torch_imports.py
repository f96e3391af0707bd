"""The port stands alone: no module of ``recommendation_tpu_torch``, no
``examples/torch_*.py`` and not ``chip_smoke.py`` imports JAX or the JAX
package, and ``chip_smoke.py``
refuses to report a result where there is no card or no repo."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = (sorted((ROOT / "recommendation_tpu_torch").rglob("*.py"))
              + sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            arg = node.args[0]
            yield arg.value if isinstance(arg, ast.Constant) else ast.unparse(arg).strip("f'\"")


def _forbidden(module):
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "flax", "optax", "orbax") or root == "recommendation_tpu"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_sees_imports():
    assert len(PORT_FILES) > 10
    assert _forbidden("recommendation_tpu.ops.topk") and _forbidden("jax.numpy")
    assert not _forbidden("recommendation_tpu_torch.ops.topk")
    mods = set(_imported_modules(ROOT / "recommendation_tpu_torch" / "models" / "registry.py"))
    assert "recommendation_tpu_torch.models.{mod}" in mods
    port = ROOT / "recommendation_tpu_torch"
    assert {port / "graph" / "augment.py", port / "ops" / "segment.py"} | {
        port / "models" / f"{m}.py"
        for m in ("selfcf", "buir", "ssl4rec", "gcl", "grace", "gbt", "bgrl", "graphsage",
                  "gat")} <= set(PORT_FILES)
    assert {ROOT / "examples" / f"torch_{m}.py" for m in (
        "train_lightgcn", "train_social_multichip", "tune_directau")} <= set(PORT_FILES)
    assert {port / "native" / f"{m}.py" for m in ("__init__", "build", "bucketize", "loader")} | {
        port / "tune" / f"{m}.py" for m in ("__init__", "tuner", "presets")} | {
        port / "evalx" / "rating.py", port / "evalx" / "probe.py",
        port / "utils" / "profiling.py"} <= set(PORT_FILES)


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)  # the script finds the package only beside it
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "recommendation_tpu_torch" in out.stderr  # it stopped at the import
