"""bwtpu_torch imports torch and never jax, nothing of the JAX package
(`bwtpu`, the root `cli.py`), and importing builds nothing."""

import glob
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files() -> list[str]:
    """Every Python file of the port, relative to the repository root."""
    files = glob.glob(os.path.join(ROOT, "bwtpu_torch", "**", "*.py"), recursive=True)
    files += [os.path.join(ROOT, "chip_smoke.py")]
    files += glob.glob(os.path.join(ROOT, "scripts", "torch_*.py"))
    return sorted(os.path.relpath(f, ROOT) for f in files)


def _module_name(path: str) -> str:
    return path[:-3].replace(os.sep, ".").removesuffix(".__init__")


def test_port_imports_without_jax_or_nvcc():
    code = (
        "import sys\n"
        "import bwtpu_torch, bwtpu_torch.engine, bwtpu_torch.cli, bwtpu_torch.sw\n"
        "import bwtpu_torch.dist, bwtpu_torch.multihost, bwtpu_torch.bench\n"
        "from bwtpu_torch.kernels import (common, compact, gather, locate, prep,\n"
        "    search, search2, searchk, verify, verify2, _build)\n"
        "from bwtpu_torch import sais\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert not _build._libs, 'a kernel was built at import'\n"
        "assert sais._lib is None and not sais._lib_tried, 'the host library loaded at import'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_module_of_the_jax_package_is_imported():
    """In a fresh process: every module of bwtpu_torch, chip_smoke (as a
    module, not run) and scripts/torch_*.py (loaded from their files, not
    run) leave no `bwtpu`, `bwtpu.*`, `cli` or jax module behind."""
    mods = [_module_name(p) for p in _port_files() if p.startswith("bwtpu_torch")]
    scripts = [p for p in _port_files() if p.startswith("scripts")]
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"for i, path in enumerate({scripts!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'_script{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m in ('bwtpu', 'cli')\n"
        "             or m.startswith(('bwtpu.', 'jax')))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 25 and len(scripts) >= 2


# `import bwtpu`, `from bwtpu import x`, `from bwtpu.x import y`,
# `import cli`, `import bench` (the root bench.py is part of the JAX
# package); `bwtpu_torch` does not match (word boundary, no `_`)
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(bwtpu|cli|bench)(\s|\.|,|$)")


@pytest.mark.parametrize("path", _port_files())
def test_source_names_no_module_of_the_jax_package(path):
    with open(os.path.join(ROOT, path)) as f:
        bad = [f"{path}:{i}: {line.strip()}" for i, line in enumerate(f, 1)
               if _FORBIDDEN.match(line)]
    assert not bad, bad


def test_the_scan_would_catch_an_import():
    for line in ("import bwtpu", "from bwtpu import dna", "    from bwtpu.io import Read",
                 "import cli", "import bwtpu.sais as s", "import bench",
                 "    from bench import gather_model", "import bench as b"):
        assert _FORBIDDEN.match(line), line
    for line in ("from bwtpu_torch import dna", "import bwtpu_torch.cli",
                 "from bwtpu_torch import cli as tcli", "# import bwtpu is not done",
                 "from bwtpu_torch import bench", "import benchmark"):
        assert not _FORBIDDEN.match(line), line
