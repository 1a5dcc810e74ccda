"""bwtpu_torch imports torch and never jax, and importing builds nothing."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax_or_nvcc():
    code = (
        "import sys\n"
        "import bwtpu_torch, bwtpu_torch.engine, bwtpu_torch.cli\n"
        "from bwtpu_torch.kernels import (common, compact, gather, locate, prep,\n"
        "    search, search2, searchk, verify, verify2, _build)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert not _build._libs, 'a kernel was built at import'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
