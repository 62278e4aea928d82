"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import neither
``jax`` nor the JAX package, and the entry points refuse to run without a
GPU unless asked for the CPU."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_import_leaves_jax_and_repro_unloaded():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=_env(), capture_output=True, text=True,
        timeout=300, check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.fed.server" in loaded and "repro_torch.kernels.build" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_repro_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path}:{node.lineno} imports {names}"


def test_run_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch import api

    spec = api.ExperimentSpec(federation=api.FederationSpec(rounds=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.run(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.build(spec)


def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when there is
    no GPU, and when it stands alone without the package."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    runs = [(alone, {k: v for k, v in os.environ.items() if k != "PYTHONPATH"})]
    if not torch.cuda.is_available():
        runs.append((ROOT, dict(os.environ)))
    for cwd, env in runs:
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode != 0, (cwd, proc.stdout)
        assert '"ok": true' not in proc.stdout
