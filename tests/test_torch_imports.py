"""The port stands alone: ``repro_torch`` imports neither ``jax`` nor the
reference package ``repro`` (the card's machine has no JAX)."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PATTERN = re.compile(
    r"^\s*(import\s+(jax|repro)(\.|\s|,|$)|from\s+(jax|repro)(\.|\s))",
    re.MULTILINE)


def test_import_pulls_in_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.obs\n"
        "import repro_torch.kernels.tocab_fused.ops\n"
        "import repro_torch.kernels.tocab_spmm.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.flash_attention.decode_kernel\n"
        "import repro_torch.configs, repro_torch.models.layers\n"
        "import repro_torch.models.transformer, repro_torch.launch.serve\n"
        "import repro_torch.kernels.embedding_bag.ops\n"
        "import repro_torch.data.recsys, repro_torch.models.bert4rec\n"
        "import repro_torch.configs.recsys_archs\n"
        "import repro_torch.core.traversal\n"
        "import repro_torch.obs.export, repro_torch.obs.report\n"
        "import repro_torch.resilience, repro_torch.tune\n"
        "import repro_torch.tune.__main__, repro_torch.tune.suite\n"
        "import repro_torch.core.cache_model, repro_torch.configs.graphcage\n"
        "import repro_torch.core.ablations\n"
        "import repro_torch.models.moe, repro_torch.data.tokens\n"
        "import repro_torch.configs.tinyllama_1_1b\n"
        "import repro_torch.configs.gemma_7b, repro_torch.configs.gemma2_27b\n"
        "import repro_torch.configs.granite_moe_3b_a800m\n"
        "import repro_torch.configs.mixtral_8x22b\n"
        "import repro_torch.configs.bert4rec\n"
        "import repro_torch.train.optim, repro_torch.train.checkpoint\n"
        "import repro_torch.train.trainer, repro_torch.train.tree\n"
        "import repro_torch.models.gnn, repro_torch.data.graphs\n"
        "import repro_torch.data.sampler, repro_torch.launch.train\n"
        "import repro_torch.configs.gnn_archs, repro_torch.configs.gat_cora\n"
        "import repro_torch.configs.gin_tu, repro_torch.configs.dimenet\n"
        "import repro_torch.configs.graphsage_reddit\n"
        "import repro_torch.dist, repro_torch.dist.sharding\n"
        "import repro_torch.dist.collectives, repro_torch.dist.elastic\n"
        "import repro_torch.launch.mesh, repro_torch.launch.cells\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.hlo_analysis\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "", out.stdout


def test_dist_imports_create_no_process_group():
    """Importing the distribution layer and the production mesh starts no
    process group (a mesh is built by a function call)."""
    code = (
        "import torch.distributed as dist\n"
        "import repro_torch.dist, repro_torch.dist.sharding\n"
        "import repro_torch.dist.collectives, repro_torch.dist.elastic\n"
        "import repro_torch.launch.mesh, repro_torch.launch.train\n"
        "import repro_torch.train.trainer, repro_torch.train.checkpoint\n"
        "print('GROUP:', dist.is_initialized())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "GROUP: False", out.stdout


def _offenders(files, root):
    return [f"{p.relative_to(root)}: {m.group(0).strip()}"
            for p in files for m in PATTERN.finditer(p.read_text())]


def test_no_jax_or_repro_import_lines():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert files
    assert _offenders(files, SRC) == []


def test_card_scripts_import_neither_jax_nor_repro():
    """``chip_smoke.py``, the port's benchmarks and its examples run on the
    card's machine, which has no JAX."""
    files = [ROOT / "chip_smoke.py",
             *sorted((ROOT / "benchmarks").glob("torch_*.py")),
             *sorted((ROOT / "examples").glob("torch_*.py"))]
    assert ROOT / "benchmarks" / "torch_paper_figs.py" in files
    for name in ("benchmarks/torch_roofline.py", "benchmarks/torch_report.py",
                 "examples/torch_quickstart.py",
                 "examples/torch_serve_recsys.py",
                 "examples/torch_train_lm.py"):
        assert ROOT / name in files
    assert _offenders(files, ROOT) == []


def test_new_scripts_load_without_jax():
    """The roofline and report benchmarks and the three examples load (and
    import what they run) in a process that then holds neither ``jax`` nor
    ``repro``; importing the dry-run opens no process group."""
    code = (
        "import importlib.util, sys\n"
        "import torch.distributed as dist\n"
        "for path in sys.argv[1:]:\n"
        "    spec = importlib.util.spec_from_file_location('m', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import repro_torch.launch.dryrun\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD:' + ','.join(bad), 'GROUP:', dist.is_initialized())\n"
    )
    paths = [str(ROOT / p) for p in (
        "benchmarks/torch_roofline.py", "benchmarks/torch_report.py",
        "examples/torch_quickstart.py", "examples/torch_serve_recsys.py",
        "examples/torch_train_lm.py")]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code, *paths], env=env,
                         check=True, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "BAD: GROUP: False", \
        out.stdout


def test_tune_cli_help_runs_without_jax():
    """``python -m repro_torch.tune --help`` in a process that then lists
    what it imported: neither ``jax`` nor ``repro``."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['repro_torch.tune', '--help']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.tune', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD:' + ','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert "{tune,show,apply}" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "BAD:", out.stdout
