"""The port stands alone: it imports neither JAX nor the reference package,
its chip smoke script and its card tools neither, and its entry points never fall back to the
CPU on their own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 25 else 0)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def test_every_module_imports_without_jax_or_reference():
    out = subprocess.run([sys.executable, "-c", _CHECK], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("[]")


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "tools").glob("*.py"))
                         + sorted((SRC / "repro_torch").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_chip_smoke_refuses_to_run_without_the_card(tmp_path):
    """Without CUDA it exits non-zero and prints no result; copied alone into
    an empty directory it cannot even find the port."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_entry_points_without_device_raise_when_there_is_no_card(monkeypatch):
    from repro_torch import api
    from repro_torch.core.problem import SCSKProblem
    from repro_torch.core.tiering import ClauseTiering
    from repro_torch.device import resolve_device
    from repro_torch.serve.engine import TieredEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.TieringPipeline.from_synthetic(0, "tiny")
    pipe = api.TieringPipeline.from_synthetic(0, "tiny", device="cpu").mine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SCSKProblem.from_data(pipe.data)
    tiering = ClauseTiering([], np.zeros((0, 2), np.uint32),
                            np.zeros(pipe.data.n_docs, bool), 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TieredEngine(pipe.data.postings, tiering, pipe.data.n_docs)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_module_imports_first():
    """`chip_smoke.py` imports `repro_torch.kernels._build` before anything
    else of the package; that order must not meet an import cycle."""
    code = ("import repro_torch.kernels._build, repro_torch.api, "
            "repro_torch.core.isk; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
