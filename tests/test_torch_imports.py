"""The port stands alone: greptimedb_tpu_torch and chip_smoke.py import
neither jax nor the reference package, and a CUDA device is never assumed."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "greptimedb_tpu_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+greptimedb_tpu(\.|\s|$)|"
    r"from\s+greptimedb_tpu(\.|\s))",
    re.M,
)


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    hits = _FORBIDDEN.findall(path.read_text(encoding="utf-8"))
    assert not hits, f"{path} imports jax or greptimedb_tpu: {hits}"


def test_imports_with_jax_and_reference_blocked():
    """Every module of the port (and chip_smoke) imports in a process
    where `jax` and `greptimedb_tpu` cannot be imported at all."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['greptimedb_tpu'] = None\n"
        "import greptimedb_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'greptimedb_tpu_torch.')]\n"
        "assert {'greptimedb_tpu_torch.ops.rate', 'greptimedb_tpu_torch.query.promql.engine',\n"
        "        'greptimedb_tpu_torch.query.promql.parser',\n"
        "        'greptimedb_tpu_torch.query.promql.tile_exec',\n"
        "        'greptimedb_tpu_torch.ops.permute', 'greptimedb_tpu_torch.ops.vector',\n"
        "        'greptimedb_tpu_torch.ops.sketch', 'greptimedb_tpu_torch.parallel.mesh',\n"
        "        'greptimedb_tpu_torch.storage.puffin',\n"
        "        'greptimedb_tpu_torch.storage.index'} <= set(names), names\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'greptimedb_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30  # every module was walked, query.promql's too


def test_cuda_database_raises_without_a_card(tmp_path):
    import torch

    from greptimedb_tpu_torch import Database
    from greptimedb_tpu_torch.utils.errors import ConfigError

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the machine without one")
    with pytest.raises(ConfigError):
        Database(str(tmp_path), device="cuda")
    with pytest.raises(ConfigError):
        Database(str(tmp_path), device="tpu")


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line without CUDA."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
