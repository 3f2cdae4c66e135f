"""The port stands alone: ``repro_torch`` imports neither ``jax`` nor the
reference package ``repro`` (the card's machine has no JAX)."""
import os
import re
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def test_import_pulls_in_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.obs\n"
        "import repro_torch.kernels.tocab_fused.ops\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "", out.stdout


def test_no_jax_or_repro_import_lines():
    pattern = re.compile(
        r"^\s*(import\s+(jax|repro)(\.|\s|,|$)|from\s+(jax|repro)(\.|\s))",
        re.MULTILINE)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert files
    offenders = [f"{p.relative_to(SRC)}: {m.group(0).strip()}"
                 for p in files for m in pattern.finditer(p.read_text())]
    assert offenders == []
